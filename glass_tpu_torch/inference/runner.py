"""Inference API: the ``GlassRunner`` of the port.

Counterpart of ``glass_tpu/inference/runner.py``: build the model from a
YAML config and a checkpoint, resize the input by the demo scale rule
(max-side cap / min-side upscale bounded by ``MAX_UPSCALE_RATIO``) or, for
dataset evaluation, by d2's shortest-edge rule, pad it into the same
``TPU.IMAGE_BUCKETS`` as glass_tpu (the padded border changes features near
the edge and the RPN's anchor mask depends on it), run the model, rescale
the predictions and post-process them on the host (or merge on the device,
``POST_PROCESSING.ON_DEVICE``).

``TPU.TWO_STAGE_INFERENCE`` runs single-image serving (``run_model``, so
``__call__`` and ``eval_call``) in two stages: detection, then the
recognizer and the mask head on the smallest ``TPU.WORD_BUCKETS`` row count
that holds the detections.  Batched serving stays one-stage, as glass_tpu's
does.  ``forward_with_given_boxes`` runs the heads on boxes given from
outside (the TTA path, ``inference/tta.py``).

Batched serving (``batch_call``, ``eval_batch_call``) uploads a padded
batch in one pinned copy, runs the model program on it and fetches the
outputs of the whole batch in one copy.  ``TPU.SERVE_BATCH_MODE="map"`` runs
the single-image program over the batch's rows (outputs equal b = 1 serving
bit for bit); any other mode ("vmap") runs one program over the batch
(``glass_inference_batch``: one backbone call, each pooler and the crop one
launch a batch, one NMS fixpoint a stage), whose outputs equal map's up to
rounding.  Either program reads a few values back on the host (the NMS
fixpoints' convergence tests), so the thread that dispatches it waits on
the device; with ``TPU.ASYNC_FETCH`` a worker thread therefore runs the
model and the fetch of the next batch while the calling thread
post-processes the last one.

``TPU.SERVE_DATA_PARALLEL`` splits the rows of a batch over the serving
devices (every visible GPU, or ``serve_devices``): one replica of the model
per device, the batch padded with zero images of 1x1 content to a multiple
of the device count, each device running the program (map or vmap) on its
contiguous rows from a thread of its own, the outputs gathered in row
order.  With one device it is a no-op, as in glass_tpu.

While a ``torch.profiler`` session records, every stage of a request is a
``utils.trace`` span: ``glass.resize``, ``glass.upload``, ``glass.dispatch``
(the model program's enqueue), ``glass.fetch``, ``glass.pipeline_wait``
and ``glass.post`` (one image's host stage), with the request id of the
runner's call count (one-image serving) or the image's index in the call
(a batch's spans: its first image's).
"""

from __future__ import annotations

import contextlib
import copy
import logging
import math
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import cv2
import numpy as np
import torch

from ..config import CfgNode, get_cfg
from ..device import resolve_device
from ..models import (
    GlassArch,
    GlassRCNN,
    glass_detect_stage,
    glass_heads_stage,
    glass_inference_batch,
    glass_inference_single,
)
from ..models.glass_rcnn import backbone_features, pack_box_pyramid, preprocess
from ..models.context import BatchNorm2d
from ..models.local_extractor import BasicBlock
from ..models.resnet import BottleneckBlock
from ..postprocess import build_post_processor, detector_postprocess
from ..postprocess.paste import RotatedMaskPaster
from ..postprocess.post_processor import scale_rotated_np
from ..structures import Instances
from ..text import TextCodec, decode_instance_texts
from ..train.checkpoint import load_weights_
from ..utils import trace
from ..utils.common import rgb2grey

logger = logging.getLogger(__name__)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def shortest_edge_size(h, w, short, max_size):
    """d2 ``ResizeShortestEdge`` target size (glass_tpu data/mapper.py)."""
    scale = short / min(h, w)
    if h < w:
        new_h, new_w = short, scale * w
    else:
        new_h, new_w = scale * h, short
    if max(new_h, new_w) > max_size:
        scale2 = max_size / max(new_h, new_w)
        new_h, new_w = new_h * scale2, new_w * scale2
    return int(new_h + 0.5), int(new_w + 0.5)


def random_init_(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Fill every weight from one seeded generator: N(0, 2/fan_in) weights,
    zero biases, unit LayerNorm scales, and nontrivial BN statistics (so
    eval-mode BN is a real normalization; ``calibrate_batch_norm_`` then
    matches the statistics to real activations).  The last BN of every
    residual branch is scaled by 1/4 (d2's zero-init-residual idea, short of
    zero): a random deep network then amplifies rounding differences ~10x
    less, so two f32 implementations stay comparable through 50+ layers."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                fan_in = p[0].numel() if "tgt_embedding" not in name else 1
                p.copy_(torch.randn(p.shape, generator=gen) * math.sqrt(2.0 / fan_in))
            else:
                p.zero_()
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.weight.copy_(1.0 + 0.1 * torch.randn(m.weight.shape, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
            elif isinstance(m, torch.nn.LayerNorm):
                m.weight.fill_(1.0)
        for m in model.modules():
            if isinstance(m, BottleneckBlock):
                m.conv3.norm.weight.mul_(0.25)
            elif isinstance(m, BasicBlock):
                m.bn2.weight.mul_(0.25)
    return model


def calibrate_batch_norm_(model: GlassRCNN, image: torch.Tensor, content_hw) -> GlassRCNN:
    """Set every BN's running statistics to those of its input on one image
    (a data-dependent init: a randomly initialized model then keeps its
    activations of order one through all 50+ layers, so its detections,
    scores and texts vary as a trained model's do)."""

    def hook(bn, args):
        x = args[0].to(torch.float32)
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm2d)]
    try:
        with torch.no_grad():
            glass_inference_single(model, image, content_hw)
    finally:
        for h in handles:
            h.remove()
    return model


def _set_text_fields(inst: Instances, out: dict, sel) -> None:
    if "text_probs" in out:
        inst.pred_text_prob = out["text_probs"][sel]
    if "text_ids" in out:
        inst.pred_text_ids = out["text_ids"][sel]
        inst.pred_text_step_scores = out["text_step_scores"][sel]


def _unpack_masks(m: np.ndarray) -> np.ndarray:
    """Dequantize a TPU.MASK_FETCH_DTYPE=uint8 mask fetch back to probs."""
    if m.dtype == np.uint8:
        return m.astype(np.float32) / 255.0
    return m


def _instances(out: dict, hw) -> Instances:
    """One image's fetched outputs as raw instances of size ``hw``: the
    valid rows, their text fields and, with the mask head, their masks
    and ``pred_rboxes``."""
    valid = out["valid"]
    inst = Instances(
        hw,
        pred_boxes=out["boxes"][valid],
        scores=out["scores"][valid],
        pred_classes=out["classes"][valid],
        orientations=out["orientations"][valid],
    )
    _set_text_fields(inst, out, valid)
    if "mask_probs" in out:
        inst.pred_masks = _unpack_masks(out["mask_probs"][valid])
        inst.pred_rboxes = out["boxes"][valid]
    return inst


_NUMPY_DTYPES = {
    torch.float32: np.float32, torch.float16: np.float16, torch.int32: np.int32,
    torch.int64: np.int64, torch.uint8: np.uint8, torch.bool: np.bool_,
}


def start_fetch(out: dict, device: torch.device):
    """Start one device-to-host copy of every output tensor: their bytes,
    packed into one buffer on the device, go to pinned host memory in one
    non-blocking copy (one transfer per batch, not one per tensor).
    ``finish_fetch`` waits for it and unpacks numpy arrays."""
    layout, parts = [], []
    for k, v in out.items():
        v = v.contiguous()
        layout.append((k, _NUMPY_DTYPES[v.dtype], tuple(v.shape)))
        parts.append(v.reshape(-1).view(torch.uint8))
    packed = torch.cat(parts)
    if device.type != "cuda":
        return packed, None, layout
    host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done, layout


def finish_fetch(fetch) -> dict:
    host, done, layout = fetch
    if done is not None:
        done.synchronize()
    raw = host.numpy()
    out, off = {}, 0
    for k, dtype, shape in layout:
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        out[k] = np.frombuffer(raw[off:off + n].tobytes(), dtype).reshape(shape)
        off += n
    return out


def pipelined(items, produce, consume, rid_of=lambda item: None) -> None:
    """``consume(item, produce(item))`` for each item in order, with
    ``produce`` (a batch's model and fetch, which wait on the device) on a
    worker thread while this thread consumes the batch before, at most two
    batches ahead: ``eval_batch_call``'s overlap, shared with the
    benchmark so that it times the served loop.  This thread's waits for
    the worker are ``glass.pipeline_wait`` spans with ``rid_of(item)``."""

    def result(item, fut):
        with trace.span("glass.pipeline_wait", rid_of(item)):
            return fut.result()

    with ThreadPoolExecutor(1) as worker:
        pending = deque()
        for item in items:
            pending.append((item, worker.submit(produce, item)))
            if len(pending) > 2:
                item0, fut = pending.popleft()
                consume(item0, result(item0, fut))
        while pending:
            item0, fut = pending.popleft()
            consume(item0, result(item0, fut))


class GlassRunner:
    def __init__(
        self,
        model_path: Optional[str] = None,
        config_path: Optional[str] = None,
        opts: Optional[List[str]] = None,
        post_process: bool = True,
        cfg: Optional[CfgNode] = None,
        state_dict: Optional[dict] = None,
        device=None,
        serve_devices: Optional[List] = None,
    ):
        """Runs on ``cuda`` unless ``device="cpu"``.  Weights come from
        ``state_dict``, else ``model_path``, else a random init from seed 0.
        ``serve_devices`` are the devices of ``TPU.SERVE_DATA_PARALLEL``
        (default: every visible GPU)."""
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else get_cfg(config_path, opts)
        self.post_process_flag = post_process
        self.arch = GlassArch.from_config(self.cfg)
        model = GlassRCNN(self.arch)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        elif model_path:
            logger.info("Loading checkpoint %s", model_path)
            load_weights_(model, model_path)
        else:
            logger.warning("No checkpoint given; random-initializing weights (seed 0)")
            random_init_(model, 0)
        self.model = model.eval().to(self.device)
        self.replicas = [self.model]
        if self.cfg.TPU.SERVE_DATA_PARALLEL:
            if serve_devices:
                devices = [torch.device(d) for d in serve_devices]
            elif self.device.type == "cuda":
                devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            else:
                devices = [self.device]
            home = next(self.model.parameters()).device
            self.replicas = [self.model if i == 0 and d == home else copy.deepcopy(self.model).to(d)
                             for i, d in enumerate(devices)]
            if len(self.replicas) > 1:
                logger.info("data-parallel serving over %d devices", len(self.replicas))

        self.min_target_size = self.cfg.INPUT.MIN_SIZE_TEST
        self.max_target_size = self.cfg.INPUT.MAX_SIZE_TEST
        self.max_upscale_ratio = self.cfg.INPUT.MAX_UPSCALE_RATIO
        self.input_format = self.cfg.INPUT.FORMAT
        assert self.input_format in ("RGB", "BGR", "GREY")
        self.codec = TextCodec.from_config(self.cfg)
        self.post_processor = build_post_processor(self.cfg, self.device)
        # the mask polygons of every path through detector_postprocess: K3
        # on a CUDA device, the host loop on the CPU
        self.mask_paster = RotatedMaskPaster(self.device) if self.device.type == "cuda" else None
        self.pad_multiple = self.cfg.TPU.PAD_IMAGE_TO_MULTIPLE
        self.buckets = [tuple(b) for b in self.cfg.TPU.IMAGE_BUCKETS]
        pp = self.cfg.POST_PROCESSING
        self.filter_small_boxes = pp.MIN_BOX_DIMENSION
        self.inflate_ratio = pp.INFLATE_RATIO
        self.drop_overlapping = pp.DROP_OVERLAPPING
        self.ioa_threshold = pp.IOA_THRESHOLD
        self.valid_score = self.cfg.INFERENCE_TH_TEST
        self.calls = 0  # one-image requests served: the trace's request id

    # -- geometry ---------------------------------------------------------
    def get_inference_scale_ratio(self, image_shape) -> float:
        """Reference glass_runner.py:111-121."""
        height, width = image_shape[:2]
        max_dim = max(height, width)
        if max_dim > self.max_target_size:
            return self.max_target_size / max_dim
        if max_dim < self.min_target_size:
            return min(self.max_upscale_ratio, self.min_target_size / max_dim)
        return 1.0

    def _resize_demo(self, image: np.ndarray):
        """The demo scale rule on a BGR image: the float32 image resized by
        ``get_inference_scale_ratio``, and that ratio."""
        ratio = self.get_inference_scale_ratio(image.shape)
        if ratio == 1:
            return image.astype(np.float32), ratio
        new_h = int(np.round(ratio * image.shape[0]))
        new_w = int(np.round(ratio * image.shape[1]))
        return cv2.resize(image.astype(np.float32), (new_w, new_h), interpolation=cv2.INTER_LINEAR), ratio

    def _resize_shortest_edge(self, image: np.ndarray, keep_uint8: bool = False) -> np.ndarray:
        """d2's ``ResizeShortestEdge`` (MIN/MAX_SIZE_TEST) on a BGR image, in
        float32, or in uint8 for a uint8 image under ``keep_uint8``
        (TPU.EVAL_UINT8_TRANSFER: d2's eval mapper resizes uint8)."""
        nh, nw = shortest_edge_size(*image.shape[:2], self.min_target_size, self.max_target_size)
        if not keep_uint8 or image.dtype != np.uint8:
            image = image.astype(np.float32)
        return cv2.resize(image, (nw, nh))

    def _pick_bucket(self, h: int, w: int) -> Tuple[int, int]:
        ph = round_up(h, self.pad_multiple)
        pw = round_up(w, self.pad_multiple)
        candidates = [b for b in self.buckets if b[0] >= ph and b[1] >= pw]
        if not candidates:
            return ph, pw
        return min(candidates, key=lambda b: b[0] * b[1])

    # -- model invocation -------------------------------------------------
    def run_model(self, image: np.ndarray, rid=None) -> dict:
        """Pad an already-resized HWC BGR image into its bucket and run the
        model (in two stages with TPU.TWO_STAGE_INFERENCE): the
        fixed-capacity outputs as numpy arrays."""
        with torch.inference_mode():
            out = self._enqueue(image, rid)
            with trace.span("glass.fetch", rid):
                return {k: v.cpu().numpy() for k, v in out.items()}

    def _enqueue(self, image: np.ndarray, rid) -> dict:
        """``run_model`` up to its fetch: the padded upload, then the model
        program's outputs on the device."""
        h, w = image.shape[:2]
        with trace.span("glass.upload", rid):
            bh, bw = self._pick_bucket(h, w)
            pad_dtype = np.uint8 if image.dtype == np.uint8 else np.float32
            padded = np.zeros((bh, bw, 3), pad_dtype)
            padded[:h, :w] = image
            img = torch.from_numpy(padded).to(self.device)
        with trace.span("glass.dispatch", rid):
            if self.cfg.TPU.TWO_STAGE_INFERENCE:
                return self._run_two_stage(img, (h, w))
            return glass_inference_single(self.model, img, (h, w))

    def _run_two_stage(self, image: torch.Tensor, hw) -> dict:
        """Two-stage inference: detect, then run the recognizer and the
        mask head on the smallest of TPU.WORD_BUCKETS (or
        DETECTIONS_PER_IMAGE) rows that holds the detections.  One host
        read (the detection count); the valid rows go first in a stable
        order, padding rows are (0, 0, 1, 1, 0), and the heads' fields are
        scattered back into zeroed rows of the full detection set."""
        det, feats, norm, pyr = glass_detect_stage(self.model, image, hw)
        valid = det["valid"]
        n = int(valid.sum())
        d = self.arch.detections_per_image
        cap = next(b for b in sorted(self.cfg.TPU.WORD_BUCKETS) + [d] if b >= n)
        order = torch.sort((~valid).to(torch.int32), stable=True).indices[:n]
        boxes = torch.zeros((cap, 5), dtype=torch.float32, device=image.device)
        boxes[:, 2:4] = 1.0
        boxes[:n] = det["boxes"][order]
        # the raw uint8 image only under f32 compute (glass_inference_single)
        raw = image if image.dtype == torch.uint8 and self.arch.torch_dtype == torch.float32 else None
        heads = glass_heads_stage(self.model, feats, norm, pyr, boxes, raw_image=raw)
        for key, t in heads.items():
            full = torch.zeros((d,) + t.shape[1:], dtype=t.dtype, device=t.device)
            full[order] = t[:n]
            det[key] = full
        return det

    def run_on_resized(self, image: np.ndarray, rid=None) -> Instances:
        """Raw (un-postprocessed) instances at the resized image's scale:
        ``run_model``, then its outputs unpacked."""
        return _instances(self.run_model(image, rid), image.shape[:2])

    # -- batched serving --------------------------------------------------
    def dispatch_batch(self, images: List[np.ndarray], rid=None):
        """Upload a batch of resized images (padded to the largest of their
        buckets) in one pinned copy, run the batched program and start the
        fetch of its outputs.  Returns (fetch, hws); ``collect_batch``
        finishes it."""
        with torch.inference_mode():
            with trace.span("glass.upload", rid):
                bh = max(self._pick_bucket(*im.shape[:2])[0] for im in images)
                bw = max(self._pick_bucket(*im.shape[:2])[1] for im in images)
                b = len(images)
                u8 = all(im.dtype == np.uint8 for im in images)
                host = torch.zeros((b, bh, bw, 3), dtype=torch.uint8 if u8 else torch.float32,
                                   pin_memory=self.device.type == "cuda")
                padded = host.numpy()
                hws = np.zeros((b, 2), np.int32)
                for i, im in enumerate(images):
                    h, w = im.shape[:2]
                    padded[i, :h, :w] = im
                    hws[i] = (h, w)
                staged = host.to(self.device, non_blocking=True)
            with trace.span("glass.dispatch", rid):
                out = self.batch_model_fn()(staged, hws)
                return start_fetch(out, self.device), hws

    def batch_model_fn(self):
        """The batched model program, per TPU.SERVE_BATCH_MODE.  "map" runs
        the single-image program over the rows of the uploaded batch, so its
        outputs equal b = 1 serving bit for bit; any other mode (glass_tpu's
        "vmap") runs ``glass_inference_batch``, one program over the batch."""
        mode = str(self.cfg.TPU.SERVE_BATCH_MODE)
        if mode == "map":
            def program(model, imgs: torch.Tensor, hws: np.ndarray) -> dict:
                outs = [glass_inference_single(model, imgs[i], (int(hws[i, 0]), int(hws[i, 1])))
                        for i in range(imgs.shape[0])]
                return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        else:
            program = glass_inference_batch

        if len(self.replicas) == 1:
            return lambda imgs, hws: program(self.model, imgs, hws)
        return lambda imgs, hws: self._data_parallel(program, imgs, hws)

    def _data_parallel(self, program, imgs: torch.Tensor, hws: np.ndarray) -> dict:
        """glass_tpu's sharding of the batched program: the batch padded to
        a multiple of the replica count with zero images of 1x1 content,
        replica d running ``program`` on rows [d*k, (d+1)*k) on its device
        from a thread of its own (inference mode is per thread), the outputs
        gathered in row order on this runner's device and cut back to the
        batch."""
        n, b = len(self.replicas), imgs.shape[0]
        k = -(-b // n)
        pad = n * k - b
        if pad:
            imgs = torch.cat([imgs, imgs.new_zeros((pad,) + tuple(imgs.shape[1:]))])
            hws = np.concatenate([hws, np.ones((pad, 2), hws.dtype)])

        def shard(d):
            model = self.replicas[d]
            dev = next(model.parameters()).device
            # the kernels launch on the thread's current device
            guard = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            with guard, torch.inference_mode():
                out = program(model, imgs[d * k:(d + 1) * k].to(dev), hws[d * k:(d + 1) * k])
                return {key: v.to(self.device) for key, v in out.items()}

        with ThreadPoolExecutor(n) as pool:
            outs = list(pool.map(shard, range(n)))
        return {key: torch.cat([o[key] for o in outs])[:b] for key in outs[0]}

    def run_batch_on_resized(self, images: List[np.ndarray], rid=None) -> List[Instances]:
        """Batched inference over same-bucket resized images: raw instances
        at each resized image's scale."""
        if not images:
            return []
        return self.collect_batch(self.dispatch_batch(images, rid), rid)

    def collect_batch(self, dispatched, rid=None) -> List[Instances]:
        """Finish the fetch of a ``dispatch_batch`` result and unpack it."""
        fetch, hws = dispatched
        with trace.span("glass.fetch", rid):
            out = finish_fetch(fetch)
            return [_instances({k: v[i] for k, v in out.items()}, tuple(hws[i])) for i in range(len(hws))]

    def _model_postprocess(self, preds: Instances, height: int, width: int) -> Instances:
        """GlassRCNN._postprocess (reference glass_rcnn.py:103-128)."""
        if self.filter_small_boxes:
            preds = self.post_processor.filter_small_boxes(preds)
        if self.inflate_ratio:
            preds = self.post_processor.resize_boxes(preds, self.inflate_ratio)
        if self.drop_overlapping:
            preds = self.post_processor.drop_overlapping_boxes(
                preds, self.ioa_threshold, self.valid_score
            )
        return detector_postprocess(preds, height, width, paster=self.mask_paster)

    def _to_bgr(self, image: np.ndarray) -> np.ndarray:
        if self.input_format == "RGB":
            image = image[:, :, ::-1]
        if self.input_format == "GREY":
            image = rgb2grey(image, three_channels=True)
        return image

    def _post_one(self, preds: Instances, rid, resized_hw, orig_hw, ratio=None) -> Instances:
        """One image's host stage.  The demo scale rule's paths (``ratio``
        given) post-process at the resized size, scale the boxes back by
        1 / ratio and give the instances the original size; the
        shortest-edge paths (``ratio`` None) post-process back to the
        original size.  Then the post-processor, with ``post_process``."""
        with trace.span("glass.post", rid):
            trace.count("glass.post.words", len(preds))
            if ratio is None:
                preds = self._model_postprocess(preds, *orig_hw)
            else:
                preds = self._model_postprocess(preds, *resized_hw)
                if ratio != 1 and len(preds):
                    preds.pred_boxes = scale_rotated_np(np.asarray(preds.pred_boxes), 1.0 / ratio, 1.0 / ratio)
                preds._image_size = orig_hw
            if self.post_process_flag:
                preds = self.post_processor(preds)
            return preds

    def __call__(self, original_image: np.ndarray) -> Instances:
        rid = self.calls
        self.calls += 1
        with trace.span("glass.resize", rid):
            original_image = self._to_bgr(original_image)
            image, ratio = self._resize_demo(original_image)
        preds = self.run_on_resized(image, rid)
        return self._post_one(preds, rid, image.shape[:2], original_image.shape[:2], ratio)

    def eval_call(self, original_image: np.ndarray) -> Instances:
        """Dataset-evaluation path: d2 ``ResizeShortestEdge`` (MIN/MAX_SIZE_TEST)
        and ``detector_postprocess`` back to the original resolution."""
        rid = self.calls
        self.calls += 1
        with trace.span("glass.resize", rid):
            original_image = self._to_bgr(original_image)
            resized = self._resize_shortest_edge(original_image)
        preds = self.run_on_resized(resized, rid)
        return self._post_one(preds, rid, resized.shape[:2], original_image.shape[:2])

    def eval_batch_call(self, original_images: List[np.ndarray], batch_size: int = 8) -> List[Instances]:
        """Batched ``eval_call``: shortest-edge resize, the batched model,
        detector_postprocess back to original sizes, post-processing.

        TPU.EVAL_UINT8_TRANSFER resizes a uint8 image as uint8 and uploads
        it so (d2's eval mapper resizes uint8); the model normalizes on the
        device.  TPU.ASYNC_FETCH pipelines the batches: a worker thread runs
        each batch's model and fetch (both wait on the device) while this
        thread post-processes the batch before, at most two batches ahead;
        without it the batches run in turn on this thread, as in
        ``batch_call``.  Every setting gives the same predictions."""
        u8 = bool(self.cfg.TPU.EVAL_UINT8_TRANSFER)
        prepped = []
        for rid, img in enumerate(original_images):
            with trace.span("glass.resize", rid):
                img = self._to_bgr(img)
                prepped.append((self._resize_shortest_edge(img, u8), img.shape[:2], None))
        return self._serve_batches(prepped, batch_size, pipeline=bool(self.cfg.TPU.ASYNC_FETCH))

    def batch_call(self, original_images: List[np.ndarray], batch_size: int = 8) -> List[Instances]:
        """Full-pipeline batched inference: per-image demo scale rule,
        grouped batched model calls in turn, per-image post-processing."""
        prepped = []
        for rid, img in enumerate(original_images):
            with trace.span("glass.resize", rid):
                img = self._to_bgr(img)
                resized, ratio = self._resize_demo(img)
                prepped.append((resized, img.shape[:2], ratio))
        return self._serve_batches(prepped, batch_size, pipeline=False)

    def _serve_batches(self, prepped, batch_size: int, pipeline: bool) -> List[Instances]:
        """The batched path of ``prepped`` ((resized image, original size,
        ratio or None) an image): the images grouped by bucket into batches
        of ``batch_size``, each batch's model and fetch, then its images'
        host stage, over a pool of TPU.POSTPROCESS_WORKERS threads when
        that is above 1.  ``pipeline`` runs the batches through
        ``pipelined`` (when there are two or more), else in turn."""
        results: List[Optional[Instances]] = [None] * len(prepped)
        order = sorted(range(len(prepped)), key=lambda i: self._pick_bucket(*prepped[i][0].shape[:2]))
        chunks = [order[s : s + batch_size] for s in range(0, len(order), batch_size)]

        def produce(idxs):
            return self.run_batch_on_resized([prepped[i][0] for i in idxs], idxs[0])

        def consume(idxs, preds):
            self._postprocess_chunk(idxs, preds, prepped, results)

        if pipeline and len(chunks) > 1:
            pipelined(chunks, produce, consume, rid_of=lambda idxs: idxs[0])
        else:
            for idxs in chunks:
                consume(idxs, produce(idxs))
        return results

    def _postprocess_chunk(self, idxs, preds, prepped, results) -> None:
        def one(i, pr):
            resized, orig_hw, ratio = prepped[i]
            results[i] = self._post_one(pr, i, resized.shape[:2], orig_hw, ratio)

        workers = int(self.cfg.TPU.POSTPROCESS_WORKERS)
        if workers > 1 and len(idxs) > 1:
            with ThreadPoolExecutor(min(workers, len(idxs))) as ex:
                list(ex.map(lambda t: one(*t), zip(idxs, preds)))
        else:
            for i, pr in zip(idxs, preds):
                one(i, pr)

    def forward_with_given_boxes(self, image: np.ndarray, instances: Instances) -> Instances:
        """The recognizer (and mask head) on boxes given in ``image``'s frame
        (d2's ``forward_with_given_boxes``; the TTA path): the demo scale
        rule, a float32 padded image (no raw-image crop), the first
        DETECTIONS_PER_IMAGE boxes scaled by the ratio into rows padded with
        (0, 0, 1, 1, 0), the backbone, then the heads with class 0.  Returns
        those instances with their text and mask fields, and ``pred_rboxes``
        in the frame they were given in."""
        resized, scale_ratio = self._resize_demo(image)
        h, w = resized.shape[:2]
        bh, bw = self._pick_bucket(h, w)
        padded = np.zeros((bh, bw, 3), np.float32)
        padded[:h, :w] = resized

        d = self.cfg.TEST.DETECTIONS_PER_IMAGE
        n = min(len(instances), d)
        boxes = np.zeros((d, 5), np.float32)
        boxes[:, 2:4] = 1.0
        if n:
            boxes[:n] = scale_rotated_np(np.asarray(instances.pred_boxes)[:n], scale_ratio, scale_ratio)

        model = self.model
        with torch.inference_mode():
            with trace.span("glass.backbone"):
                norm = preprocess(model, torch.from_numpy(padded).to(self.device))
                feats = backbone_features(model, norm)
                pyr = (pack_box_pyramid(model, feats)
                       if self.arch.mask_on and self.arch.mask_inference else None)
            out = glass_heads_stage(model, feats, norm, pyr, torch.from_numpy(boxes).to(self.device))
            out = {k: v.cpu().numpy() for k, v in out.items()}
        instances = instances[np.arange(n)]
        _set_text_fields(instances, out, np.arange(n))
        if "mask_probs" in out:
            instances.pred_masks = _unpack_masks(out["mask_probs"][:n])
            instances.pred_rboxes = np.asarray(instances.pred_boxes)
        return instances

    def decode_texts(self, preds: Instances):
        return decode_instance_texts(preds, self.codec)

"""Per-component times of the port's inference path: the counterpart of
``tools/profile_breakdown.py``.

Each row is one component at the eval shapes of a 736x1280 image (the
ICDAR15 config at MIN/MAX test sizes 1000/1600, seed-0 random weights,
``TPU.COMPUTE_DTYPE`` bfloat16 by default), timed over ``--k`` calls after
a warm-up between two CUDA events: the device time plus the host work it
could not hide.  glass_tpu chains its reps in one ``fori_loop`` program
to get past a remote runtime's per-call cost; eager PyTorch has none.

Rows: the RPN's top-k (``models.rpn.top_k``, the stable-sort top-k the
port's RPN runs) over the p2 anchors and over all five levels; rotated IoU
of 1000 boxes; NMS of 1000, 512 and 256 boxes; the RPN's proposal
selection; and the model stages: backbone, detection (RPN, box head,
NMS), recognizer, the raw-image crops (K2), the recognizer's 8x32 pool
(K1), the local CNN, the greedy decoder, the mask head and the whole
frame.  glass_tpu's ``approx_topk_p2`` row times ``lax.approx_max_k``, a
TPU top-k the port has no counterpart of; it is left out.

Usage: python -m glass_tpu_torch.tools.profile_breakdown [--k 30]
    [--device cuda] [--hw H W] [--opts KEY VALUE ...] [component ...]
Prints one line a component, then one JSON line.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..config import get_cfg
from ..inference.runner import random_init_
from ..models import GlassArch, GlassRCNN, glass_inference_single
from ..models import glass_rcnn as gr
from ..models import rpn as rpn_mod
from ..models.fpn import FPN_LEVEL_STRIDES
from ..models.recognizer import aster_decode_greedy
from ..ops.crop import crop_rois
from ..ops.iou_rotated import pairwise_iou_rotated
from ..ops.nms_rotated import nms_rotated_mask
from ..ops.roi_align_rotated import multilevel_pool, pack_batch_pyramid
from . import common

PAD_HW = (736, 1280)   # the frame: 720x1280 content padded to a multiple of 32
CONTENT_H = 720
TOPK = 1000


def level_sizes(hw):
    return {name: (math.ceil(hw[0] / s), math.ceil(hw[1] / s)) for name, s in FPN_LEVEL_STRIDES.items()}


def rand_boxes(rng: np.random.RandomState, n: int, hw=PAD_HW) -> np.ndarray:
    b = np.zeros((n, 5), np.float32)
    b[:, 0] = rng.uniform(0, hw[1], n)
    b[:, 1] = rng.uniform(0, hw[0], n)
    b[:, 2] = rng.uniform(8, 160, n)
    b[:, 3] = rng.uniform(8, 60, n)
    b[:, 4] = rng.uniform(-90, 90, n)
    return b


def model_state(device=None, hw=PAD_HW, opts=()) -> dict:
    """The model, a seeded frame and its features and boxes, on the
    device: what the stage rows run on."""
    dev = common.setup(device)
    cfg = get_cfg(common.ICDAR15, ["INPUT.MIN_SIZE_TEST", "1000", "INPUT.MAX_SIZE_TEST", "1600", *opts])
    arch = GlassArch.from_config(cfg)
    model = random_init_(GlassRCNN(arch), 0).eval().to(dev)
    rng = np.random.RandomState(0)
    image = torch.from_numpy(rng.rand(hw[0], hw[1], 3).astype(np.float32) * 255).to(dev)
    content_hw = (min(hw[0], CONTENT_H), hw[1])
    with torch.inference_mode():
        norm = gr.preprocess(model, image)
        feats = gr.backbone_features(model, norm)
        boxes = torch.from_numpy(rand_boxes(rng, arch.detections_per_image, hw)).to(dev)
    return dict(cfg=cfg, arch=arch, model=model, image=image, norm=norm, feats=feats, boxes=boxes,
                content_hw=content_hw, device=dev, rng=rng, hw=hw)


# ---- the rows: each function returns a call of no argument (made and
# called under inference mode) ---------------------------------------------

def _level_scores(s, levels):
    a = s["arch"].num_anchors
    sizes = level_sizes(s["hw"])
    return [torch.from_numpy(s["rng"].randn(sizes[f][0] * sizes[f][1] * a).astype(np.float32)).to(s["device"])
            for f in levels]


def build_topk_p2(s):
    (x,) = _level_scores(s, ["p2"])
    return lambda: rpn_mod.top_k(x, min(TOPK, x.shape[0]))


def build_topk_all5(s):
    xs = _level_scores(s, ["p2", "p3", "p4", "p5", "p6"])
    return lambda: [rpn_mod.top_k(x, min(TOPK, x.shape[0])) for x in xs]


def _nms(s, n):
    boxes = torch.from_numpy(rand_boxes(s["rng"], n, s["hw"])).to(s["device"])
    scores = torch.from_numpy(s["rng"].rand(n).astype(np.float32)).to(s["device"])
    return lambda: nms_rotated_mask(boxes, scores, 0.7)


def build_iou1000(s):
    boxes = torch.from_numpy(rand_boxes(s["rng"], 1000, s["hw"])).to(s["device"])
    return lambda: pairwise_iou_rotated(boxes, boxes)


def build_select_proposals(s):
    arch, dev = s["arch"], s["device"]
    sizes = level_sizes(s["hw"])
    logits, deltas, anchors = [], [], []
    for i, f in enumerate(arch.rpn_in_features):
        h, w = sizes[f]
        n = h * w * arch.num_anchors
        logits.append(torch.from_numpy(s["rng"].randn(n).astype(np.float32)).to(dev))
        deltas.append(torch.from_numpy(0.1 * s["rng"].randn(n, 5).astype(np.float32)).to(dev))
        anchors.append(s["model"].anchors(i, h, w, dev))
    return lambda: rpn_mod.select_proposals_single_image(
        logits, deltas, anchors, s["hw"], arch.rpn_bbox_weights, arch.rpn_pre_nms_topk,
        arch.rpn_post_nms_topk, arch.rpn_nms_thresh)


def build_stage_backbone(s):
    return lambda: gr.backbone_features(s["model"], gr.preprocess(s["model"], s["image"]))


def build_stage_detect(s):
    m, f = s["model"], s["feats"]
    return lambda: gr.detect_single_image(m, f, gr.pack_box_pyramid(m, f), s["content_hw"])


def build_stage_recognize(s):
    return lambda: gr.recognize_single_image(s["model"], s["feats"], s["norm"], s["boxes"])


def build_stage_crops(s):
    arch = s["arch"]
    return lambda: crop_rois(s["norm"], s["boxes"], arch.img_crop_hw, arch.img_crop_sampling_ratio,
                             arch.crop_max_sampling_ratio)


def build_stage_global_pool(s):
    arch, rh = s["arch"], s["model"].roi_heads
    fused = rh.recognizer_feature_fusion(s["feats"]["p2"], s["feats"]["p3"]).contiguous(
        memory_format=torch.channels_last)
    pyr = pack_batch_pyramid([fused.permute(0, 2, 3, 1)], [1.0 / FPN_LEVEL_STRIDES["p2"]])
    return lambda: multilevel_pool(pyr, 0, s["boxes"], arch.recognizer_pool_hw, 0, arch.pool_max_sampling_ratio,
                                   arch.recognizer_pool_bulk_sampling_ratio, arch.pool_large_roi_budget,
                                   rois_per_image=s["boxes"].shape[0])


def build_stage_local_cnn(s):
    arch = s["arch"]
    crops = torch.from_numpy(s["rng"].rand(arch.detections_per_image, 3, *arch.img_crop_hw).astype(np.float32))
    crops = crops.to(s["device"], arch.torch_dtype).contiguous(memory_format=torch.channels_last)
    return lambda: s["model"].roi_heads.hybrid_net(crops)


def build_stage_decode(s):
    arch = s["arch"]
    enc = torch.from_numpy(s["rng"].randn(arch.detections_per_image, 32, 256).astype(np.float32)).to(s["device"])
    return lambda: aster_decode_greedy(s["model"].roi_heads.recognizer_head.aster, enc, arch.max_word_len + 1)


def build_stage_mask(s):
    m = s["model"]
    pyr = gr.pack_box_pyramid(m, s["feats"])
    classes = torch.zeros((s["boxes"].shape[0],), dtype=torch.int32, device=s["device"])
    return lambda: gr.mask_single_image(m, pyr, s["boxes"], classes)


def build_stage_full(s):
    return lambda: glass_inference_single(s["model"], s["image"], s["content_hw"])


ROWS = {
    "topk_p2": build_topk_p2,
    "topk_all5": build_topk_all5,
    "iou1000": build_iou1000,
    "nms1000": lambda s: _nms(s, 1000),
    "nms512": lambda s: _nms(s, 512),
    "nms256": lambda s: _nms(s, 256),
    "select_proposals": build_select_proposals,
    "stage_backbone": build_stage_backbone,
    "stage_detect": build_stage_detect,
    "stage_recognize": build_stage_recognize,
    "stage_crops": build_stage_crops,
    "stage_global_pool": build_stage_global_pool,
    "stage_local_cnn": build_stage_local_cnn,
    "stage_decode": build_stage_decode,
    "stage_mask": build_stage_mask,
    "stage_full": build_stage_full,
}


def timed(state, name: str, k: int) -> float:
    with torch.inference_mode():
        return common.event_ms(ROWS[name](state), state["device"], k)


def run(names=None, k=30, device=None, hw=PAD_HW, opts=()) -> dict:
    state = model_state(device, hw, opts)
    rows = {}
    for name in names or list(ROWS):
        rows[name] = timed(state, name, k)
        print(f"{name:34s} {rows[name]:8.3f} ms", flush=True)
    return {"device": common.device_info(state["device"]), "k": k, "hw": list(hw),
            "compute_dtype": state["arch"].compute_dtype, "ms": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("components", nargs="*", default=[],
                    help=f"rows to time (default all): {', '.join(ROWS)}")
    ap.add_argument("--k", type=int, default=30, help="timed calls a row, after a warm-up")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--hw", type=int, nargs=2, default=PAD_HW, metavar=("H", "W"), help="the padded frame")
    ap.add_argument("--opts", nargs="*", default=[], help="config overrides, KEY VALUE ...")
    args = ap.parse_args(argv)
    return common.emit(run(args.components, args.k, args.device, tuple(args.hw), args.opts))


if __name__ == "__main__":
    main()

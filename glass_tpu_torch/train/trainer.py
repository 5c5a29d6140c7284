"""Training orchestration: the reference ``Trainer``/``DefaultTrainer`` loop.

Counterpart of ``glass_tpu/train/trainer.py``: SGD + WarmupMultiStepLR,
scalar logging every 20 iterations (``metrics.json``), periodic checkpoints
in detectron2's layout and periodic evaluation through the port's own
``GlassRunner``, a checkpoint on SIGTERM/SIGINT, the ``VIS_PERIOD``
minibatch dump and precise BN before an evaluation.

Data parallelism (``parallel/mesh.py``): in a ``torch.distributed`` group
of N processes, one per device, each rank loads ``IMS_PER_BATCH / N``
images (``records[rank::N]``, augmentations seeded with ``SEED + rank``),
the ranks pad to one global image size, and the step syncs BN and averages
the gradients.  Rank 0's initial state is broadcast; rank 0 alone writes
``metrics.json`` and the checkpoints; every rank evaluates its strided shard
of the test set and the evaluator gathers them.  PreciseBN averages each
rank's own batches, as glass_tpu's does per process.

``TPU.TRAIN_LOOP_STEPS`` = K runs the loop in chunks of up to K steps
(glass_tpu's in-graph loop; K = 1 is its plain loop): step for step alike
for every K.
"""

from __future__ import annotations

import functools
import logging
import os
import signal
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import CfgNode
from ..data import DatasetManager
from ..data.loader import build_train_loader
from ..data.mapper import DatasetMapper
from ..device import resolve_device
from ..models import GlassArch, GlassRCNN
from ..models.context import BatchNorm2d
from ..parallel import mesh
from ..utils.events import EventStorage
from .checkpoint import last_checkpoint, load_weights_, save_checkpoint
from .optimizer import build_optimizer
from .train_step import (
    Priorities,
    TrainConfig,
    batch_to_device,
    check_trainable,
    glass_train_forward,
    train_step,
)

logger = logging.getLogger(__name__)


def init_weights_(model: GlassRCNN, seed: int = 0) -> GlassRCNN:
    """The port's seeded training init (its own stream, not glass_tpu's):
    ``random_init_``'s N(0, 2/fan_in) weights, then detectron2's small
    normal init of the predictors (RPN and class/orientation scores 0.01,
    box and mask deltas 0.001, zero biases) and identity BN statistics."""
    from ..inference.runner import random_init_

    random_init_(model, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    rh = model.roi_heads
    rpn = model.proposal_generator.rpn_head
    small = [(rpn.conv, 0.01), (rpn.objectness_logits, 0.01), (rpn.anchor_deltas, 0.01),
             (rh.box_predictor.cls_score, 0.01), (rh.box_predictor.bbox_pred, 0.001)]
    if hasattr(rh.box_predictor, "orientation_pred"):
        small.append((rh.box_predictor.orientation_pred, 0.01))
    if hasattr(rh, "mask_head"):
        small.append((rh.mask_head.predictor, 0.001))
    with torch.no_grad():
        for m, std in small:
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
            m.bias.zero_()
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model


class Trainer:
    def __init__(self, cfg: CfgNode, device=None):
        """Trains on ``device`` (``cuda`` unless ``cpu`` is asked for), in
        the ``torch.distributed`` group when one is initialized (the data
        group: one rank per device), else in this one process."""
        check_trainable(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = dist.group.WORLD if mesh.is_distributed() else None
        self.rank, self.world = mesh.rank(), mesh.world_size()
        if cfg.SOLVER.IMS_PER_BATCH % self.world != 0:
            raise ValueError(
                f"SOLVER.IMS_PER_BATCH={cfg.SOLVER.IMS_PER_BATCH} must be divisible by the "
                f"data-mesh size ({self.world} devices); set TPU.TRAIN_DEVICES to train on a "
                "subset of devices"
            )
        self.arch = GlassArch.from_config(cfg)
        self.tcfg = TrainConfig.from_config(cfg)
        self.out_dir = cfg.OUTPUT_DIR
        os.makedirs(self.out_dir, exist_ok=True)
        # d2 JSONWriter semantics: rank 0 streams scalars to metrics.json
        self.storage = EventStorage(
            os.path.join(self.out_dir, "metrics.json") if self.rank == 0 else None)
        self.seed = cfg.SEED if cfg.SEED >= 0 else 0
        model = init_weights_(GlassRCNN(self.arch), self.seed)
        if cfg.MODEL.WEIGHTS:
            load_weights_(model, cfg.MODEL.WEIGHTS)
        self.model = model.to(self.device).train()
        if self.group is not None:
            # DDP's rule: every replica starts from rank 0's state
            mesh.broadcast_state_(self.model, 0, self.group)
            if not mesh.replicas_agree(self.model.state_dict().values(), self.group):
                raise RuntimeError("the replicas' initial states differ after the broadcast")
        self.optimizer = build_optimizer(cfg, self.model)
        self.start_iter = 0
        self._interrupted = False
        self._last_saved_iter = None

    # -- data -------------------------------------------------------------
    def build_train_loader(self):
        DatasetManager(self.cfg).register()
        records = []
        for name in self.cfg.DATASETS.TRAIN:
            records.extend(DatasetManager.load(name))
        # d2 default_setup: SEED >= 0 seeds the augmentations with seed + rank
        aug_rng = np.random.RandomState(self.cfg.SEED + self.rank) if self.cfg.SEED >= 0 else None
        mapper = DatasetMapper(self.cfg, is_train=True, rng=aug_rng)
        # SOLVER.IMS_PER_BATCH is the global batch; each rank loads its share
        if mesh.multi_host() and not self.cfg.TPU.TRAIN_PAD_SIZE:
            raise ValueError(
                "multi-host training requires a fixed TPU.TRAIN_PAD_SIZE "
                "[H, W] so all processes emit identical batch shapes"
            )
        return build_train_loader(self.cfg, records, mapper,
                                  batch_size=self.cfg.SOLVER.IMS_PER_BATCH // self.world,
                                  seed=max(self.cfg.SEED, 0), rank=self.rank, world=self.world)

    def _next_batch(self, loader) -> dict:
        """The rank's next host batch, padded to the global batch's image
        size when the ranks' sizes may differ."""
        batch = next(loader)
        if self.world > 1 and not self.cfg.TPU.TRAIN_PAD_SIZE:
            batch = mesh.agree_batch_shape(batch, self.group)
        return batch

    # -- checkpoint / resume ----------------------------------------------
    def resume_or_load(self, resume: bool = True):
        path = last_checkpoint(self.out_dir) if resume else None
        if path is None:
            return
        state = torch.load(path, map_location="cpu", weights_only=False)
        self.model.load_state_dict(state["model"])
        if "optimizer" in state:
            self.optimizer.load_state_dict(state["optimizer"])
        self.start_iter = int(state.get("iteration", -1)) + 1
        logger.info("Resumed from %s at iteration %d", path, self.start_iter)

    def save(self, iteration: int):
        self._last_saved_iter = iteration
        save_checkpoint(self.out_dir, iteration, self.model, self.optimizer, group=self.group)
        logger.info("Saved checkpoint at iteration %d", iteration)

    # -- precise BN -------------------------------------------------------
    @torch.no_grad()
    def precise_bn(self, num_iter: Optional[int] = None):
        """Set BN running statistics to the true average of the batch
        statistics over ``num_iter`` train batches (d2 ``PreciseBN``), the
        weights held fixed.  Each pass starts from the same running
        statistics, so glass_tpu's inversion of the EMA recovers the mean of
        the batch statistics exactly; frozen stages keep theirs.  With more
        than one process each rank averages its own batches, unsynced, as
        glass_tpu's PreciseBN does per process."""
        num_iter = int(num_iter or self.cfg.TEST.PRECISE_BN.NUM_ITER)
        bns = [m for m in self.model.modules() if isinstance(m, BatchNorm2d)]
        orig = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
        sums = [[torch.zeros_like(a), torch.zeros_like(b)] for a, b in orig]
        loader = iter(self.build_train_loader())
        self.model.train()
        for it in range(num_iter):
            batch = batch_to_device(next(loader), self.device)
            glass_train_forward(self.model, self.tcfg, batch, Priorities(self.seed + 1, it, self.device))
            for m, (m0, v0), acc in zip(bns, orig, sums):
                acc[0] += m.running_mean
                acc[1] += m.running_var
                m.running_mean.copy_(m0)
                m.running_var.copy_(v0)
        momentum = 0.1  # layers.batch_norm_train's EMA constant
        for m, (m0, v0), (sm, sv) in zip(bns, orig, sums):
            m.running_mean.copy_((sm / num_iter - (1 - momentum) * m0) / momentum)
            m.running_var.copy_((sv / num_iter - (1 - momentum) * v0) / momentum)
        logger.info("PreciseBN: %d BN layers over %d train batches", len(bns), num_iter)

    # -- periodic evaluation ----------------------------------------------
    def test(self, max_images: Optional[int] = None):
        """Evaluate the current weights on cfg.DATASETS.TEST with the port's
        ``GlassRunner`` and ``TextEvaluator`` (glass_tpu's in-training eval).

        With more than one process EVERY rank must enter: each evaluates
        its strided shard of the records and the evaluator gathers them, so
        all ranks return the metrics of the whole set."""
        if not self.cfg.DATASETS.TEST:
            return {}
        if self.cfg.TEST.PRECISE_BN.ENABLED and self.cfg.DATASETS.TRAIN:
            self.precise_bn()
        import cv2

        from ..evaluation import TextEvaluator
        from ..inference import GlassRunner
        from ..text import decode_instance_texts

        runner = GlassRunner(cfg=self.cfg, state_dict=self.model.state_dict(), device=self.device)
        results = {}
        for name in self.cfg.DATASETS.TEST:
            records = DatasetManager.load(name)
            if max_images:
                records = records[:max_images]
            records = records[self.rank::self.world]
            evaluator = TextEvaluator(name, self.cfg)
            shown = 0
            for i, record in enumerate(records):
                image = cv2.imread(record["file_name"], cv2.IMREAD_COLOR)
                if image is None:
                    continue
                preds = runner(image)
                evaluator.process(str(record.get("image_id", i)), preds, gt_record=record)
                if shown < 1 and len(preds):
                    texts, scores, _ = decode_instance_texts(preds, runner.codec)
                    gt = [a.get("text", "") for a in record.get("annotations", [])][:7]
                    logger.info("sample preds: %s | gt: %s",
                                [f"{t}({s:.2f})" for t, s in zip(texts[:7], scores[:7])], gt)
                    shown += 1
            results[name] = evaluator.evaluate()
            for group, vals in results[name].items():
                for k, v in vals.items():
                    self.storage.put_scalar(f"{name}/{group}/{k}", v)
        self.model.train()
        return results

    def _maybe_visualize(self, it: int, batch: dict):
        """VIS_PERIOD minibatch dump: the batch's first image with its gt boxes."""
        period = self.cfg.VIS_PERIOD
        if not period or it % period != 0 or self.rank != 0:
            return
        try:
            import cv2

            from ..postprocess.np_geometry import boxes_to_polygons_np

            img = np.asarray(batch["images"][0]).astype(np.uint8).copy()
            boxes = np.asarray(batch["gt_boxes"][0])[np.asarray(batch["gt_valid"][0])]
            polys = boxes_to_polygons_np(boxes).astype(np.int32)
            cv2.polylines(img, list(polys), True, (0, 255, 0), 1)
            cv2.imwrite(os.path.join(self.out_dir, f"vis_{it:07d}.png"), img)
        except Exception as e:  # never break training for a debug image
            logger.debug("vis dump failed: %s", e)

    # -- loop -------------------------------------------------------------
    def _install_signal_handler(self):
        def handler(signum, frame):
            logger.warning("Signal %d received: checkpointing before exit", signum)
            self._interrupted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread

    def _any_interrupted(self) -> bool:
        """A signal on any rank stops every rank at the same iteration."""
        if self.group is None:
            return self._interrupted
        flag = torch.tensor([int(self._interrupted)], device=mesh.collective_device(self.group))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        return bool(flag.item())

    @staticmethod
    def chunk_len(
        it: int,
        max_iter: int,
        loop_k: int,
        ckpt_period: int,
        eval_period: int,
        vis_period: int,
    ) -> int:
        """Iterations to run in the next chunk starting at ``it``.

        Chunk ends land exactly on the K=1 loop's side-effect boundaries:
        checkpoint/eval fire AFTER executing iteration m*p (chunk must
        include it), visualization at the START of iteration m*v (chunk
        must end just before it).  Pure, and glass_tpu's own function
        (``glass_tpu/train/trainer.py``), held to it over its test grid
        (tests/test_torch_train_loop.py)."""
        nxt = max_iter
        for p in (ckpt_period, eval_period):
            if p:
                nxt = min(nxt, (max(it - 1, 0) // p + 1) * p + 1)
        if vis_period:
            nxt = min(nxt, (it // vis_period + 1) * vis_period)
        return max(1, min(loop_k, nxt - it))

    def train(self, max_iter: Optional[int] = None):
        """The loop, in chunks of up to ``TPU.TRAIN_LOOP_STEPS`` = K steps
        (glass_tpu's ``_train_chunked``; K = 1 is one step a chunk, its
        plain loop).  A chunk's batches are loaded and uploaded, then its
        steps run through ``mesh.make_parallel_train_scan`` with the
        metrics left on the device.  Each step's priorities fold its global
        iteration, so every K trains step for step alike.  Chunks end on the
        side effects' boundaries (``chunk_len``): the VIS dump at a chunk's
        first iteration, the checkpoint, the evaluation and the interrupt
        check after its last.  The scalars and a log line go out at
        ``it % 20 == 0``, the chunk's metrics read back once when it holds
        such an iteration.  glass_tpu groups a chunk's same-shape batches
        into one static program; eager PyTorch takes any shape, so a chunk
        is one scan, and not yet one CUDA graph."""
        max_iter = max_iter or self.cfg.SOLVER.MAX_ITER
        loader = self.build_train_loader()
        self._install_signal_handler()
        self._interrupted = False
        ckpt_period = self.cfg.SOLVER.CHECKPOINT_PERIOD
        eval_period = self.cfg.TEST.EVAL_PERIOD
        loop_k = max(1, int(self.cfg.TPU.TRAIN_LOOP_STEPS))
        self.model.train()
        scan = mesh.make_parallel_train_scan(functools.partial(train_step, group=self.group))
        t0 = time.time()
        data_wait = 0.0
        it = self.start_iter
        while it < max_iter:
            chunk = self.chunk_len(it, max_iter, loop_k, ckpt_period, eval_period, self.cfg.VIS_PERIOD)
            td = time.time()
            host_batches = [self._next_batch(loader) for _ in range(chunk)]
            data_wait += time.time() - td
            self._maybe_visualize(it, host_batches[0])
            its = list(range(it, it + chunk))
            stacked = scan(self.model, self.optimizer, self.tcfg,
                           [batch_to_device(b, self.device) for b in host_batches],
                           [Priorities(self.seed + 1, i, self.device, self.rank) for i in its], its)
            values = None
            for j, step_it in enumerate(its):
                self.storage.step(step_it)
                if step_it % 20:
                    continue
                if values is None:  # one read-back for the chunk
                    names = list(stacked)
                    values = torch.stack([stacked[k].to(torch.float64) for k in names]).cpu().tolist()
                metrics = {k: v[j] for k, v in zip(names, values)}
                for k, v in metrics.items():
                    self.storage.put_scalar(k, v)
                lr = self.optimizer.schedule(step_it)
                self.storage.put_scalar("lr", lr)
                self.storage.put_scalar("data_time", data_wait)
                logger.info(
                    "iter %d  %s  lr %.5f  %.2f s/20it (data wait %.2f s)", step_it,
                    "  ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()) if "/" not in k),
                    lr, time.time() - t0, data_wait,
                )
                t0 = time.time()
                data_wait = 0.0
            it += chunk
            last = it - 1
            if ckpt_period and last > 0 and last % ckpt_period == 0:
                self.save(last)
            if eval_period and last > 0 and last % eval_period == 0:
                try:
                    self.test()
                except Exception as e:
                    logger.warning("periodic eval failed: %s", e)
            if self._any_interrupted():
                self.save(last)
                self.storage.flush()
                logger.warning("Exiting on signal at iteration %d", last)
                return
        if self._last_saved_iter != max_iter - 1 and max_iter > self.start_iter:
            self.save(max_iter - 1)
        self.storage.flush()

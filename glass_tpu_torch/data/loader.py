"""Batched data loading with static-shape padding.

A copy of glass_tpu's ``data/loader.py`` (host code, no JAX): the port
trains on the same padded batches, so the padded border and the padded gt
rows give the same batch statistics and the same matching as glass_tpu.
``pad_batch_images`` is the port's: it pads a rank's batch to the size
the ranks agree on (``parallel.mesh.agree_batch_shape``).

The reference uses torch DataLoaders with list-of-dicts collation
(``glass/data/build.py``); on TPU every array entering jit must have a
static shape, so the loader pads:

* images into the configured resolution buckets,
* ground-truth to ``TPU.MAX_GT_INSTANCES`` rows with a validity mask,
* polygons to a fixed vertex count (subsampled if longer).

An infinite shuffled sampler + background prefetch thread replaces the
reference's ``TrainingSampler``/worker processes; per-host sharding
(``every process takes records [rank::world]``) mirrors
``build.num_of_images_per_worker``.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Iterator, List

import numpy as np

logger = logging.getLogger(__name__)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_polygon(points: np.ndarray, k: int) -> np.ndarray:
    """Pad/subsample a polygon to exactly k vertices (preserving shape)."""
    n = len(points)
    out = np.zeros((k, 2), np.float32)
    if n == 0:
        return out, 0
    if n <= k:
        out[:n] = points
        return out, n
    idx = np.linspace(0, n - 1, k).astype(np.int64)
    out[:] = points[idx]
    return out, k


class PaddedBatchBuilder:
    def __init__(self, cfg):
        self.max_gt = cfg.TPU.MAX_GT_INSTANCES
        self.max_poly = int(getattr(cfg.TPU, "MAX_POLY_VERTICES", 64) or 64)
        self.pad_multiple = cfg.TPU.PAD_IMAGE_TO_MULTIPLE
        self.text_len = None  # inferred from first sample
        # Fixed train padding (TPU.TRAIN_PAD_SIZE [H, W]): one static shape
        # for every batch — no per-shape recompiles, and REQUIRED for
        # multi-host training where every process must emit identical
        # non-batch dims (jax.make_array_from_process_local_data).
        pad = list(getattr(cfg.TPU, "TRAIN_PAD_SIZE", []) or [])
        self.fixed_hw = tuple(pad) if pad else None

    def __call__(self, samples: List[dict]) -> dict:
        b = len(samples)
        if self.fixed_hw:
            hmax, wmax = self.fixed_hw
            for s in samples:
                if s["image"].shape[0] > hmax or s["image"].shape[1] > wmax:
                    raise ValueError(
                        f"sample {s['image'].shape[:2]} exceeds "
                        f"TPU.TRAIN_PAD_SIZE {self.fixed_hw}"
                    )
        else:
            hmax = round_up(max(s["image"].shape[0] for s in samples), self.pad_multiple)
            wmax = round_up(max(s["image"].shape[1] for s in samples), self.pad_multiple)
        g = self.max_gt
        t = samples[0]["gt_text"].shape[1] if len(samples[0].get("gt_text", [])) else 27
        k = self.max_poly

        images = np.zeros((b, hmax, wmax, 3), np.float32)
        content_hw = np.zeros((b, 2), np.int32)
        gt_boxes = np.zeros((b, g, 5), np.float32)
        gt_boxes[..., 2:4] = 1.0  # avoid log(0) in delta encoding for pads
        gt_valid = np.zeros((b, g), bool)
        gt_classes = np.zeros((b, g), np.int32)
        gt_orientation = np.zeros((b, g), np.int32)
        gt_text = np.zeros((b, g, t), np.int32)
        gt_polygons = np.zeros((b, g, k, 2), np.float32)
        gt_poly_nv = np.zeros((b, g), np.int32)

        for i, s in enumerate(samples):
            h, w = s["image"].shape[:2]
            images[i, :h, :w] = s["image"]
            content_hw[i] = (h, w)
            n = min(len(s.get("gt_boxes", [])), g)
            if n:
                gt_boxes[i, :n] = s["gt_boxes"][:n]
                gt_valid[i, :n] = True
                gt_classes[i, :n] = s["gt_classes"][:n]
                gt_orientation[i, :n] = s["gt_orientation"][:n]
                gt_text[i, :n] = s["gt_text"][:n]
                for j in range(n):
                    poly, nv = pad_polygon(np.asarray(s["gt_polygons"][j]), k)
                    gt_polygons[i, j] = poly
                    gt_poly_nv[i, j] = nv
        return {
            "images": images,
            "content_hw": content_hw,
            "gt_boxes": gt_boxes,
            "gt_valid": gt_valid,
            "gt_classes": gt_classes,
            "gt_orientation": gt_orientation,
            "gt_text": gt_text,
            "gt_polygons": gt_polygons,
            "gt_poly_nv": gt_poly_nv,
        }


def pad_batch_images(batch: dict, hw) -> dict:
    """The batch with its images zero-padded at the bottom and right to
    ``hw``: what the builder gives when the batch's largest image needs
    ``hw`` (data parallelism: every rank's shard of one global batch
    shares its padded size)."""
    h, w = batch["images"].shape[1:3]
    if (h, w) == tuple(hw):
        return batch
    images = np.zeros((len(batch["images"]), hw[0], hw[1], 3), batch["images"].dtype)
    images[:, :h, :w] = batch["images"]
    return {**batch, "images": images}


def build_train_loader(
    cfg,
    records: List[dict],
    mapper,
    batch_size: int,
    seed: int = 0,
    rank: int = 0,
    world: int = 1,
    prefetch: int = 2,
) -> Iterator[dict]:
    """Infinite shuffled padded-batch iterator.

    DATALOADER.NUM_WORKERS > 0 maps samples on a thread pool (cv2 decode /
    warp release the GIL, so threads scale on multi-core hosts — the
    reference's worker *processes*, build.py:15-75, without the pickling);
    sample order stays deterministic (futures are consumed in submission
    order). A background thread assembles padded batches either way.
    """
    builder = PaddedBatchBuilder(cfg)
    rng = np.random.RandomState(seed + rank)
    num_workers = int(getattr(cfg.DATALOADER, "NUM_WORKERS", 0) or 0)

    if cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS:
        records = [r for r in records if r.get("annotations")]
    assert records, "no training records"

    def index_stream():
        while True:
            order = rng.permutation(len(records))
            for idx in order[rank::world] if world > 1 else order:
                yield int(idx)

    def _map(idx):
        try:
            return mapper(records[idx])
        except FileNotFoundError as e:
            logger.warning("skipping unreadable image: %s", e)
            return None

    def sample_stream():
        idxs = index_stream()
        if num_workers <= 0:
            for idx in idxs:
                s = _map(idx)
                if s is not None:
                    yield s
            return
        from concurrent.futures import ThreadPoolExecutor
        from collections import deque

        pool = ThreadPoolExecutor(num_workers, thread_name_prefix="glass-mapper")
        window = max(2 * num_workers, batch_size)
        pending: deque = deque()
        for _ in range(window):
            pending.append(pool.submit(_map, next(idxs)))
        while True:
            s = pending.popleft().result()
            pending.append(pool.submit(_map, next(idxs)))
            if s is not None:
                yield s

    def batch_stream():
        stream = sample_stream()
        while True:
            yield builder([next(stream) for _ in range(batch_size)])

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)

    def worker():
        try:
            for batch in batch_stream():
                q.put(batch)
        except RuntimeError:
            # interpreter shutdown while the daemon thread was submitting
            # mapper futures — benign (the process is exiting)
            return

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    while True:
        yield q.get()


def build_test_loader(cfg, records: List[dict], mapper) -> Iterator[dict]:
    """One-pass test iterator yielding mapped samples (no batching)."""
    for r in records:
        yield mapper(r)

"""Where the time of one b = 4 eval round goes: the port's counterpart of
``tools/e2e_breakdown.py``.

The round is the product number's (``glass_tpu_torch.bench``): the batched
model program of ``GlassRunner.batch_model_fn`` (``TPU.SERVE_BATCH_MODE``
map or vmap) on a staged uint8 batch, the fetch of its outputs and the host
post-processing (``POST_PROCESSING.ON_DEVICE`` merges on the card).  Five
parts, each the best of several rounds:

* ``device``: the device time of the batch program's kernels and copies
  (``torch.profiler``, as ``chip_smoke.py`` phase 13 (d) reads it);
* ``model``: the host wall time of the batch program, ending in
  ``torch.cuda.synchronize()`` (its host syncs and launches included);
* ``fetch``: the device-to-host copy of the finished output tree (one
  packed copy, ``runner.start_fetch``), with its bytes in total and per
  leaf;
* ``host``: ``collect_batch``, ``_model_postprocess`` and the
  post-processor on a fetched tree;
* ``pipelined``: the real ``eval_batch_call`` loop over ``rounds``
  batches of the same images from host numpy, against max(device,
  fetch + host), a perfect overlap, and device + fetch + host, none.

Usage:  python -m glass_tpu_torch.tools.e2e_breakdown [--rounds 8]
            [--batch 4] [--device cuda] [KEY VALUE ...]
        GLASS_BENCH_OPTS="POST_PROCESSING.ON_DEVICE True" python -m ...
Prints one JSON line.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import cv2
import numpy as np
import torch

from ..inference import GlassRunner
from ..inference.runner import finish_fetch, shortest_edge_size, start_fetch
from . import common

IMAGE_HW = (720, 1280)


def build(extra_opts: Optional[Sequence[str]] = None, device=None) -> Tuple[object, GlassRunner]:
    """The benchmark configuration (``common.bench_cfg``) and a runner with
    the seed-0 random weights."""
    cfg = common.bench_cfg(extra_opts)
    return cfg, GlassRunner(cfg=cfg, device=common.setup(device))


def seeded_images(rng: np.random.RandomState, n: int, hw=IMAGE_HW) -> list:
    """bench.py's images: uint8 noise, ``n`` draws of ``rng``."""
    return [(rng.rand(hw[0], hw[1], 3) * 255).astype(np.uint8) for _ in range(n)]


def staged_batch(runner: GlassRunner, b: int = 4, hw=IMAGE_HW):
    """bench.py's device-resident staging: b seeded images resized by the
    eval rule (``shortest_edge_size``), padded into one bucket as uint8 and
    put on the runner's device once.  Returns (the images, the padded host
    batch, the batch on the device, the (b, 2) content sizes)."""
    images = seeded_images(np.random.RandomState(0), b, hw)
    resized = []
    for img in images:
        bgr = img[:, :, ::-1]
        nh, nw = shortest_edge_size(*bgr.shape[:2], runner.min_target_size, runner.max_target_size)
        resized.append(cv2.resize(bgr, (nw, nh)))
    bh, bw = runner._pick_bucket(*resized[0].shape[:2])
    padded = np.zeros((b, bh, bw, 3), np.uint8)
    hws = np.zeros((b, 2), np.int32)
    for i, im in enumerate(resized):
        padded[i, :im.shape[0], :im.shape[1]] = im
        hws[i] = im.shape[:2]
    return images, padded, torch.from_numpy(padded).to(runner.device), hws


def host_post(runner: GlassRunner, insts: list, images: list) -> list:
    """The host stages after the fetch: ``_model_postprocess`` back to each
    original image's size, then the post-processor."""
    return [runner.post_processor(runner._model_postprocess(pr, *im.shape[:2]))
            for pr, im in zip(insts, images)]


def split(runner: GlassRunner, device_batch: torch.Tensor, hws: np.ndarray, images: list,
          repeats: int = 3) -> dict:
    """device, model, fetch and host of one round (each the best of
    ``repeats``), ms a round."""
    dev, b = runner.device, len(hws)
    program = runner.batch_model_fn()

    def model():
        return program(device_batch, hws)

    def host(fetched):
        host_post(runner, runner.collect_batch((fetched, hws)), images)

    res = {}
    with torch.inference_mode():
        out = model()  # warm-up: the host stages need none
        res["model_ms"] = min(common.wall_ms(model, dev) for _ in range(repeats))
        busy = common.device_busy_ms(model, dev)
        res["device_ms"] = busy["device_ms"]
        res["device_busy_share"] = busy["busy_share"]
        res["device_records"] = busy["device_records"]
        fetch_ms = []
        for _ in range(repeats):
            out = model()
            common.sync(dev)
            fetch_ms.append(common.wall_ms(lambda: finish_fetch(start_fetch(out, dev)), dev))
        res["fetch_ms"] = min(fetch_ms)
    fetched = start_fetch(out, dev)
    finish_fetch(fetched)
    fetched = (fetched[0], None, fetched[2])  # finished: unpacking re-reads host memory only
    leaf = {k: int(np.prod(shape)) * np.dtype(dt).itemsize for k, dt, shape in fetched[2]}
    res["fetch_bytes"] = int(sum(leaf.values()))
    res["fetch_bytes_per_img"] = res["fetch_bytes"] // b
    res["fetch_leaf_bytes_per_img"] = {k: v // b for k, v in leaf.items()}
    host(fetched)  # warm the host path's lazy imports and builds
    res["host_ms"] = min(common.wall_ms(lambda: host(fetched), dev) for _ in range(repeats))
    return res


def pipelined_ms(runner: GlassRunner, images: list, rounds: int, repeats: int = 3) -> float:
    """ms a round of ``eval_batch_call`` over ``rounds`` batches of
    ``images`` (host numpy), best of ``repeats``."""
    b = len(images)
    pool = [images[i % b] for i in range(rounds * b)]
    runner.eval_batch_call(pool[:b], batch_size=b)  # warm-up
    best = float("inf")
    for _ in range(repeats):
        ms = common.wall_ms(lambda: runner.eval_batch_call(pool, batch_size=b), runner.device)
        best = min(best, ms / rounds)
    return best


def measure(rounds: int = 8, b: int = 4, device=None, opts: Optional[Sequence[str]] = None,
            hw=IMAGE_HW) -> dict:
    cfg, runner = build(opts, device)
    images, _, device_batch, hws = staged_batch(runner, b, hw)
    res = {"b": b, "rounds": rounds, "device": common.device_info(runner.device),
           "serve_batch_mode": str(cfg.TPU.SERVE_BATCH_MODE),
           "on_device_merge": bool(cfg.POST_PROCESSING.ON_DEVICE),
           "compute_dtype": cfg.TPU.COMPUTE_DTYPE, "bucket": list(device_batch.shape[1:3])}
    parts = split(runner, device_batch, hws, images, repeats=max(3, rounds // 2))
    parts["pipelined_ms"] = pipelined_ms(runner, images, rounds)
    host_side = parts["fetch_ms"] + parts["host_ms"]
    if parts["device_ms"] is not None:
        parts["perfect_overlap_ms"] = max(parts["device_ms"], host_side)
        parts["no_overlap_ms"] = parts["device_ms"] + host_side
    parts["model_no_overlap_ms"] = parts["model_ms"] + host_side
    for key in ("device_ms", "model_ms", "fetch_ms", "host_ms", "pipelined_ms"):
        if parts[key] is not None:
            res[key.replace("_ms", "_ms_per_img")] = parts[key] / b
    res["rounds_ms"] = parts
    res["e2e_ips"] = b / (parts["pipelined_ms"] / 1e3)
    res["model_only_b4_ips"] = b / (parts["model_ms"] / 1e3)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--hw", type=int, nargs=2, default=IMAGE_HW, metavar=("H", "W"),
                    help="the seeded images' size")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="config overrides, KEY VALUE ...")
    args = ap.parse_args(argv)
    return common.emit(measure(args.rounds, args.batch, args.device, args.opts, tuple(args.hw)))


if __name__ == "__main__":
    main()

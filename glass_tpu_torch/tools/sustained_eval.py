"""Sustained evaluation throughput of the port: the counterpart of
``tools/sustained_eval.py``.

Writes a synthetic COCO-style set (``make_dataset``: noise images with
dark word boxes, at least 200 of 720x1280 by default, every image in one
resize bucket) and drives the real eval CLI (``python -m
glass_tpu_torch.eval``, in-process) over it with ``--bench-log``, every
threshold at 0 so that a random model fills its word slots.  Reports:

* steady img/s, after the first three batches;
* the first-50 against the last-50 images' rate (drift is runtime state,
  since no image changes the bucket);
* peak host RSS and its growth after the first batches;
* ``torch.cuda.max_memory_allocated`` (on the card).

Usage: python -m glass_tpu_torch.tools.sustained_eval [--images 200]
    [--batch 4] [--hw H W] [--keep] [--device cuda] [KEY VALUE ...]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from . import common

THRESHOLD_OPTS = [
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
    "POST_PROCESSING.TEXT_THRESHOLD", "0.0",
    "POST_PROCESSING.DETECT_THRESHOLD", "0.0",
    "POST_PROCESSING.VALID_CONFIDENCE", "0.0",
]


def make_dataset(root: str, name: str, n: int, h=720, w=1280, words_per_img=8):
    """COCO-style synthetic set: noise images + axis-aligned word boxes
    (glass_tpu's generator: the same JSON and image bytes)."""
    import cv2

    os.makedirs(f"{root}/{name}", exist_ok=True)
    rng = np.random.RandomState(0)
    images, annotations = [], []
    aid = 1
    for i in range(n):
        img = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        for _ in range(words_per_img):
            bw, bh = rng.randint(60, 200), rng.randint(20, 50)
            x0 = rng.randint(0, w - bw)
            y0 = rng.randint(0, h - bh)
            img[y0 : y0 + bh, x0 : x0 + bw] = rng.randint(0, 40)
            quad = [[x0, y0], [x0 + bw, y0], [x0 + bw, y0 + bh], [x0, y0 + bh]]
            annotations.append({
                "id": aid, "image_id": i + 1, "category_id": 1,
                "bbox": [x0, y0, bw, bh], "rotated_box": quad,
                "segmentation": [[c for pt in quad for c in pt]],
                "rec": "word", "angle": 0, "orientation": 0,
                "area": bw * bh, "iscrowd": 0,
            })
            aid += 1
        cv2.imwrite(f"{root}/{name}/img_{i:04d}.jpg", img)
        images.append({
            "id": i + 1, "file_name": f"img_{i:04d}.jpg", "height": h, "width": w
        })
    with open(f"{root}/{name}/annotations.json", "w") as f:
        json.dump({
            "images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "word"}],
        }, f)


def summarize(rows: list, images: int, batch: int) -> dict:
    """The rates, drift and host memory of the CLI's ``--bench-log`` rows."""
    res = {"images": images, "batch": batch}
    warm = rows[3:]  # the first batches hold the warm-up
    res["steady_state_ips"] = ((warm[-1]["done"] - warm[0]["done"]) / (warm[-1]["elapsed_s"] - warm[0]["elapsed_s"])
                               if len(warm) > 1 else None)

    def window_rate(lo, hi):
        sel = [r for r in rows if lo <= r["done"] <= hi]
        if len(sel) < 2:
            return None
        return (sel[-1]["done"] - sel[0]["done"]) / (sel[-1]["elapsed_s"] - sel[0]["elapsed_s"])

    n = rows[-1]["done"]
    res["first50_ips"] = window_rate(batch, 50)
    res["last50_ips"] = window_rate(n - 50, n)
    res["rate_drift_pct"] = (100 * (res["last50_ips"] - res["first50_ips"]) / res["first50_ips"]
                             if res["first50_ips"] and res["last50_ips"] else None)
    res["peak_rss_mb"] = max(r["rss_mb"] for r in rows)
    res["rss_growth_mb"] = rows[-1]["rss_mb"] - rows[min(3, len(rows) - 1)]["rss_mb"]
    res["total_s"] = rows[-1]["elapsed_s"]
    return res


def run(images=200, batch=4, hw=(720, 1280), device="cuda", opts=(), keep=False) -> dict:
    from ..eval import main as eval_main

    dev = common.setup(device)
    base = tempfile.mkdtemp(prefix="sustained_eval_")
    try:
        root = os.path.join(base, "ds")
        make_dataset(root, "sustained", images, h=hw[0], w=hw[1])
        ds_yaml = os.path.join(base, "datasets.yaml")
        with open(ds_yaml, "w") as f:
            f.write(f"ROOT: {root}\nDATASETS: []\nVAL_DATASETS:\n  - sustained\n")
        bench_log = os.path.join(base, "bench.jsonl")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        eval_main(["--config", common.ICDAR15, "--datasets", ds_yaml, "--output", os.path.join(base, "out"),
                   "--batch-size", str(batch), "--bench-log", bench_log, "--device", str(dev),
                   *THRESHOLD_OPTS, *opts])
        with open(bench_log) as f:
            rows = [json.loads(line) for line in f]
        res = summarize(rows, images, batch)
        res["device"] = common.device_info(dev)
        res["max_memory_allocated_mib"] = (torch.cuda.max_memory_allocated(dev) / 2**20
                                           if dev.type == "cuda" else None)
        res["host_loadavg_1m"] = os.getloadavg()[0]
        return res
    finally:
        if not keep:
            shutil.rmtree(base, ignore_errors=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--images", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hw", type=int, nargs=2, default=(720, 1280), metavar=("H", "W"))
    ap.add_argument("--keep", action="store_true", help="keep the dataset and outputs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="config overrides, KEY VALUE ...")
    args = ap.parse_args(argv)
    return common.emit(run(args.images, args.batch, tuple(args.hw), args.device, args.opts, args.keep))


if __name__ == "__main__":
    main()

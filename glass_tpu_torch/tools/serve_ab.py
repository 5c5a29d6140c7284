"""Model-only serving A/B of the port: the counterpart of
``tools/serve_ab.py``.  Times ``glass_inference_single`` on bench.py's
seeded 736x1280 uint8 frame (720x1280 content) under config overrides:
three trials of ``--frames`` calls, the host clock ending in a
synchronize.  Run it once per side of the A/B, in one call on one card.

Usage: python -m glass_tpu_torch.tools.serve_ab [--frames 20]
    [--device cuda] [--hw H W] [KEY VALUE ...]
e.g.   python -m glass_tpu_torch.tools.serve_ab TPU.COMPUTE_DTYPE float16
Prints a line a trial, then one JSON line.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import get_cfg
from ..inference import GlassRunner
from ..models import glass_inference_single
from . import common

PAD_HW = (736, 1280)


def run(opts=(), frames=20, device=None, hw=PAD_HW, trials=3) -> dict:
    cfg = get_cfg(common.ICDAR15)
    cfg.INPUT.MIN_SIZE_TEST = 1000
    cfg.INPUT.MAX_SIZE_TEST = 1600
    cfg.MODEL.ROI_MASK_HEAD.MASK_INFERENCE = True
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    if opts:
        cfg.merge_from_list(list(opts))
    runner = GlassRunner(cfg=cfg, device=common.setup(device))
    dev = runner.device
    rng = np.random.RandomState(0)
    image = torch.from_numpy((rng.rand(hw[0], hw[1], 3) * 255).astype(np.uint8)).to(dev)
    content = (min(hw[0], 720), hw[1])

    def frame():
        return glass_inference_single(runner.model, image, content)

    ms = []
    with torch.inference_mode():
        frame()  # warm-up
        for trial in range(trials):
            ms.append(common.wall_ms(lambda: [frame() for _ in range(frames)], dev) / frames)
            print(f"trial {trial}: {ms[-1]:.2f} ms/frame ({1e3 / ms[-1]:.2f} img/s)", flush=True)
    return {"device": common.device_info(dev), "opts": list(opts), "frames": frames,
            "compute_dtype": cfg.TPU.COMPUTE_DTYPE, "ms_per_frame": ms, "best_ips": 1e3 / min(ms)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--hw", type=int, nargs=2, default=PAD_HW, metavar=("H", "W"))
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="config overrides, KEY VALUE ...")
    args = ap.parse_args(argv)
    return common.emit(run(args.opts, args.frames, args.device, tuple(args.hw)))


if __name__ == "__main__":
    main()

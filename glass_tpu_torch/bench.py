"""End-to-end spotting throughput of the port on one card: the counterpart
of the repository's ``bench.py``.

The product number is batched evaluation, ``GlassRunner.eval_batch_call``
at b = 4 (shortest-edge resize, uint8 upload, the batched model program
of ``TPU.SERVE_BATCH_MODE``, one fetch of the batch's outputs, host
post-processing, the next batch's model and fetch overlapping this one's
post-processing), on the ICDAR15 eval configuration with every threshold
at 0 so that all 100 word slots are filled (``tools.common.bench_cfg``;
``GLASS_BENCH_OPTS`` merges more overrides).  Weights are the seed-0
random init; images are ``np.random.RandomState(0)`` uint8 noise.

Measured:

* ``model_only_single_ips``: ``glass_inference_single`` on one padded
  736x1280 image (720x1280 content), ``--frames`` calls a window, the host
  clock ending in a synchronize, best of ``--windows``;
* ``e2e_device_resident_b4_ips`` (the headline): the batch staged on the
  card once, then ``--rounds`` rounds through ``eval_batch_call``'s own
  loop (``inference.runner.pipelined``: the batch program and its fetch
  on a worker thread, the host post-processing on this one), best of
  ``--windows``;
* ``e2e_from_host_b4_ips``: ``eval_batch_call`` on 16 host numpy images;
* ``e2e_split``: device, model, fetch and host ms an image
  (``tools.e2e_breakdown.split``);
* training: ``tools.train_bench.measure`` (``glass_pretrain.yaml``, b = 1,
  1024x1024, 24 words): ms/step, img/s and MFU.

MFU is ``FlopCounterMode``'s count over the card's published peak for the
compute dtype (``tools.common.PEAK_TFLOPS``).  Every failure raises: the
script exits non-zero rather than print a partial record.

Usage: python -m glass_tpu_torch.bench [--device cuda] [--hw H W] ...
Prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": null, "detail": {...}}
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .models import glass_inference_single
from .tools import common, e2e_breakdown, train_bench

IMAGE_HW = (720, 1280)


def bench_images(hw=IMAGE_HW):
    """bench.py's seeded inputs, in its order: one image padded to a
    multiple of 32 rows for the model-only rate, then four for the batch."""
    rng = np.random.RandomState(0)
    h = -(-hw[0] // 32) * 32
    image = (rng.rand(h, hw[1], 3) * 255).astype(np.uint8)
    return image, e2e_breakdown.seeded_images(rng, 4, hw)


def _model_only(runner, image, hw, frames, windows) -> dict:
    dev = runner.device
    img = torch.from_numpy(image).to(dev)

    def call():
        return glass_inference_single(runner.model, img, hw)

    with torch.inference_mode():
        call()  # warm-up
        rates = [frames / (common.wall_ms(lambda: [call() for _ in range(frames)], dev) / 1e3)
                 for _ in range(windows)]
        flops = common.count_flops(call)
    best = max(rates)
    return {"model_only_single_ips": best, "model_only_windows_ips": rates, "serve_flops": flops,
            "serve_model_mfu": common.mfu(flops, 1e3 / best, dev, runner.cfg.TPU.COMPUTE_DTYPE)}


def _device_resident(runner, device_batch, hws, images, rounds, windows) -> list:
    """img/s of the served pipeline on a staged batch: ``pipelined``
    (``eval_batch_call``'s loop) with the batch program and its fetch on
    the worker and the host stages on this thread, ``rounds`` rounds a
    window."""
    from .inference.runner import pipelined, start_fetch

    dev, b = runner.device, len(hws)
    program = runner.batch_model_fn()

    def produce(_):
        with torch.inference_mode():  # per thread
            return runner.collect_batch((start_fetch(program(device_batch, hws), dev), hws))

    rates = []
    for _ in range(windows):
        common.sync(dev)
        t0 = time.perf_counter()
        pipelined(range(rounds), produce, lambda _, insts: e2e_breakdown.host_post(runner, insts, images))
        rates.append(rounds * b / (time.perf_counter() - t0))
    return rates


def run(device="cuda", hw=IMAGE_HW, frames=10, rounds=8, windows=3, train_size=1024, train_steps=10,
        train_opts=()) -> dict:
    cfg, runner = e2e_breakdown.build(device=device)
    dev = runner.device
    image, images = bench_images(hw)
    detail = {"device": common.device_info(dev), "serve_batch_mode": str(cfg.TPU.SERVE_BATCH_MODE),
              "compute_dtype": cfg.TPU.COMPUTE_DTYPE, "on_device_merge": bool(cfg.POST_PROCESSING.ON_DEVICE)}
    detail.update(_model_only(runner, image, hw, frames, windows))

    n_host = 16
    pool = [images[i % len(images)] for i in range(n_host)]
    runner.eval_batch_call(pool[:4], batch_size=4)  # warm-up
    ms = common.wall_ms(lambda: runner.eval_batch_call(pool, batch_size=4), dev)
    detail["e2e_from_host_b4_ips"] = n_host / (ms / 1e3)

    _, _, device_batch, hws = e2e_breakdown.staged_batch(runner, 4, hw)
    windows_ips = _device_resident(runner, device_batch, hws, images, rounds, windows)
    detail["e2e_device_resident_b4_ips"] = max(windows_ips)
    detail["e2e_windows_ips"] = windows_ips

    parts = e2e_breakdown.split(runner, device_batch, hws, images)
    b = len(hws)
    detail["e2e_split"] = {
        "device_ms_per_img": None if parts["device_ms"] is None else parts["device_ms"] / b,
        "model_ms_per_img": parts["model_ms"] / b, "fetch_ms_per_img": parts["fetch_ms"] / b,
        "fetch_bytes_per_img": parts["fetch_bytes_per_img"], "host_postproc_ms_per_img": parts["host_ms"] / b,
        "device_busy_share": parts["device_busy_share"]}
    detail["model_only_b4_ips"] = b / (parts["model_ms"] / 1e3)
    with torch.inference_mode():
        flops4 = common.count_flops(lambda: runner.batch_model_fn()(device_batch, hws))
    detail["serve_flops_b4"] = flops4
    detail["serve_model_mfu_b4"] = common.mfu(flops4, parts["model_ms"], dev, cfg.TPU.COMPUTE_DTYPE)
    del runner, device_batch

    tr = train_bench.measure(steps=train_steps, size=train_size, opts=train_opts, with_flops=True,
                             windows=windows, device=dev)
    detail.update({
        "train_ms_per_step": tr["ms_per_step"], "train_ips_per_chip": tr["ips_per_chip"],
        "train_flops": tr["flops"], "train_mfu": tr["mfu"], "train_size": train_size,
        "train_backends": {"match": tr["match_backend"], "rpn_sampler": tr["rpn_sampler"]},
    })
    detail["host_loadavg_1m"] = os.getloadavg()[0]
    return detail


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--hw", type=int, nargs=2, default=IMAGE_HW, metavar=("H", "W"),
                    help="the seeded images' size")
    ap.add_argument("--frames", type=int, default=10, help="model-only calls a window")
    ap.add_argument("--rounds", type=int, default=8, help="device-resident b = 4 rounds a window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--train-size", type=int, default=1024)
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--train-opts", nargs="*", default=[], help="config overrides of the training part")
    args = ap.parse_args(argv)
    detail = run(args.device, tuple(args.hw), args.frames, args.rounds, args.windows, args.train_size,
                 args.train_steps, args.train_opts)
    on_card = detail["device"]["platform"] == "gpu"
    result = {
        "metric": "e2e_spotting_images_per_sec_single_gpu" if on_card else "e2e_spotting_images_per_sec_cpu_run",
        "value": detail["e2e_device_resident_b4_ips"],
        "unit": "images/sec",
        "vs_baseline": None,
        "detail": detail,
    }
    return common.emit(result)


if __name__ == "__main__":
    main()

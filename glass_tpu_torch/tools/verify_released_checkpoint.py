"""One-command verification of a released checkpoint on the port.

The counterpart of ``tools/verify_released_checkpoint.py``.  Loads the
reference's released ``.pth`` and YAML, runs the official eval protocol
through ``python -m glass_tpu_torch.eval`` and diffs the measured E2E hmean
against the expected value (BASELINE.md: within 0.5 points).
``icdar15_test.yaml`` is a datasets yaml whose VAL_DATASETS is
``ICDAR15_test_coco`` (the layout of ``data_configs/example_datasets.yaml``):

    python -m glass_tpu_torch.tools.verify_released_checkpoint \\
        --checkpoint glass_250k_icdar15_fintune.pth \\
        --config glass_config_icdar15.yaml \\
        --datasets icdar15_test.yaml \\
        --expected-hmean 0.847 --tolerance 0.005 --output verify_out

``--model icdar15`` (or totaltext, textocr) resolves the released URLs; a
file already in ``--cache-dir`` is used as it is, and only a missing one is
downloaded.  The checkpoint is read by the port's own loader
(``train/checkpoint.py::load_torch_checkpoint``) and must hold at least 100
tensors (5 with ``--dry-run``) before the eval starts.  ``--dry-run`` runs
the same resolve, load, eval and report path on local files, e.g. a seeded
model and a synthetic dataset.  Writes ``verification_report.json`` under
``--output`` and exits 1 when the measured hmean is off by more than
``--tolerance``.  Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

# Released artifacts (reference README.md:72-74).
RELEASED = {
    "icdar15": {
        "checkpoint": "https://glass-text-spotting.s3.eu-west-1.amazonaws.com/models/glass_250k_icdar15_fintune.pth",
        "config": "https://glass-text-spotting.s3.eu-west-1.amazonaws.com/configs/glass_config_icdar15.yaml",
    },
    "totaltext": {
        "checkpoint": "https://glass-text-spotting.s3.eu-west-1.amazonaws.com/models/glass_250k_totaltext_finetune.pth",
        "config": "https://glass-text-spotting.s3.eu-west-1.amazonaws.com/configs/glass_config_totaltext.yaml",
    },
    "textocr": {
        "checkpoint": "https://glass-text-spotting.s3.eu-west-1.amazonaws.com/models/glass_250k_full_textocr_finetune.pth",
        "config": "https://glass-text-spotting.s3.eu-west-1.amazonaws.com/configs/glass_config_textocr.yaml",
    },
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=sorted(RELEASED),
                   help="released model to verify (resolves the S3 URLs)")
    p.add_argument("--checkpoint", default=None,
                   help="local .pth path (skips the checkpoint download)")
    p.add_argument("--config", default=None,
                   help="local model yaml (skips the config download)")
    p.add_argument("--datasets", default=None, help="dataset config yaml")
    p.add_argument("--dataset-root", default=None,
                   help="override DATASETS.ROOT")
    p.add_argument("--gt-zip", default=None, help="official RRC gt zip")
    p.add_argument("--cache-dir", default=os.path.expanduser(
        "~/.cache/glass_tpu/released"))
    p.add_argument("--output", default="./verify_output")
    p.add_argument("--expected-hmean", type=float, default=None,
                   help="reference E2E hmean to diff against (fractional); "
                        "omit to just record the measured value")
    p.add_argument("--tolerance", type=float, default=0.005,
                   help="max |measured - expected| (BASELINE.md: 0.5 pts)")
    p.add_argument("--word-spotting", action="store_true")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--dry-run", action="store_true",
                   help="no network: verify plumbing on local artifacts")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def _download(url: str, dest: str) -> str:
    if os.path.exists(dest) and os.path.getsize(dest) > 0:
        print(f"[verify] cached: {dest}")
        return dest
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    print(f"[verify] downloading {url} -> {dest}")
    import urllib.request

    tmp = dest + ".part"
    urllib.request.urlretrieve(url, tmp)
    os.replace(tmp, dest)
    return dest


def resolve_artifacts(args):
    """Return (checkpoint_path, config_path), downloading if needed."""
    ckpt, cfg = args.checkpoint, args.config
    if args.model and (ckpt is None or cfg is None):
        urls = RELEASED[args.model]
        if ckpt is None:
            ckpt = _download(
                urls["checkpoint"],
                os.path.join(args.cache_dir, os.path.basename(urls["checkpoint"])),
            )
        if cfg is None:
            cfg = _download(
                urls["config"],
                os.path.join(args.cache_dir, os.path.basename(urls["config"])),
            )
    if ckpt is None or cfg is None:
        raise SystemExit(
            "need --model (to download) or both --checkpoint and --config"
        )
    return ckpt, cfg


def count_tensors(ckpt: str) -> int:
    """The tensors the port's loader reads from the file: the d2 state dict
    without the buffers the model re-derives (``train/checkpoint.py::_dropped``)."""
    from ..train.checkpoint import load_torch_checkpoint

    return len(load_torch_checkpoint(ckpt))


def eval_argv(args, ckpt: str, cfg_path: str, device: str) -> list:
    """The arguments of ``python -m glass_tpu_torch.eval`` for this run."""
    argv = ["--model", ckpt, "--config", cfg_path, "--output", args.output, "--device", device]
    if args.datasets:
        argv += ["--datasets", args.datasets]
    if args.gt_zip:
        argv += ["--gt-zip", args.gt_zip]
    if args.word_spotting:
        argv += ["--word-spotting"]
    if args.max_images:
        argv += ["--max-images", str(args.max_images)]
    if args.batch_size != 1:
        argv += ["--batch-size", str(args.batch_size)]
    opts = list(args.opts)
    if args.dataset_root:
        opts += ["DATASETS.ROOT", args.dataset_root]
    return argv + opts


def run_eval(args, ckpt: str, cfg_path: str, device: str) -> dict:
    """Run ``glass_tpu_torch.eval.main`` in this process and return the
    results dict it wrote."""
    from .. import eval as port_eval

    port_eval.main(eval_argv(args, ckpt, cfg_path, device))
    with open(os.path.join(args.output, "results.json")) as f:
        return json.load(f)


def extract_hmean(results: dict) -> float:
    """E2E hmean of the first dataset (``TextEvaluator.evaluate`` layout:
    {dataset: {"E2E_RESULTS": {precision, recall, hmean}, ...}})."""
    for _, metrics in results.items():
        e2e = metrics.get("E2E_RESULTS")
        if isinstance(e2e, dict) and "hmean" in e2e:
            return float(e2e["hmean"])
    raise KeyError(f"no hmean in results: {json.dumps(results)[:400]}")


def main(argv=None) -> int:
    from ..device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)

    ckpt, cfg_path = resolve_artifacts(args)

    # Load check before the (long) eval: a released model has hundreds of
    # tensors, a file that is not one has few.
    n_tensors = count_tensors(ckpt)
    print(f"[verify] loaded checkpoint: {n_tensors} tensors")
    if n_tensors < (5 if args.dry_run else 100):
        raise SystemExit(f"conversion produced only {n_tensors} leaves")

    results = run_eval(args, ckpt, cfg_path, str(device))
    measured = extract_hmean(results)

    report = {
        "checkpoint": ckpt,
        "config": cfg_path,
        "measured_hmean": measured,
        "expected_hmean": args.expected_hmean,
        "tolerance": args.tolerance,
        "results": results,
    }
    ok = True
    if args.expected_hmean is not None:
        diff = abs(measured - args.expected_hmean)
        report["diff"] = diff
        ok = diff <= args.tolerance
        print(
            f"[verify] hmean measured={measured:.4f} "
            f"expected={args.expected_hmean:.4f} diff={diff:.4f} "
            f"tolerance={args.tolerance:.4f} -> {'PASS' if ok else 'FAIL'}"
        )
    else:
        print(f"[verify] hmean measured={measured:.4f} (no expected value "
              "given — record it in BASELINE.md)")
    report["pass"] = ok
    with open(os.path.join(args.output, "verification_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Training CLI of the port: ``python -m glass_tpu_torch.train``.

Counterpart of ``tools/train_glass.py`` with the same arguments
(``--config --datasets --output --resume --weights --max-iter --debug``,
then ``KEY VALUE`` opts) plus ``--device`` (``cuda``, the default, or
``cpu``):

    python -m glass_tpu_torch.train --config configs/glass_finetune_icdar15.yaml \\
        --datasets data_configs/example_datasets.yaml --output train_out

Not ported yet, and refused: ``--distributed`` and more than one process
(the distributed slice).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the GLASS text spotter (PyTorch port)")
    p.add_argument("--config", required=True, help="model config yaml")
    p.add_argument("--datasets", default=None, help="dataset config yaml")
    p.add_argument("--output", default="./output", help="output directory")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--weights", default=None, help="initial d2-shaped .pth (partial load)")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--debug", action="store_true", help="batch of 1, no loader workers")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training (not ported yet: raises)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE config overrides")
    return p.parse_args(argv)


def setup(args):
    from ..config import get_cfg, merge_from_dataset_config
    from ..utils.logger import setup_logger

    cfg = get_cfg(args.config)
    if args.datasets:
        merge_from_dataset_config(cfg, args.datasets)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.OUTPUT_DIR = args.output
    if args.weights:
        cfg.MODEL.WEIGHTS = args.weights
    if args.debug:
        cfg.SOLVER.IMS_PER_BATCH = 1
        cfg.DATALOADER.NUM_WORKERS = 0
    cfg.freeze()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    setup_logger(output=cfg.OUTPUT_DIR)
    return cfg


def main(argv=None):
    """Train; returns the ``Trainer`` (its model, optimizer and storage)."""
    args = parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed (multi-process training) is not ported to glass_tpu_torch yet "
            "(the distributed slice)"
        )
    cfg = setup(args)
    from .trainer import Trainer

    trainer = Trainer(cfg, device=args.device)
    trainer.resume_or_load(resume=args.resume)
    trainer.train(max_iter=args.max_iter)
    return trainer

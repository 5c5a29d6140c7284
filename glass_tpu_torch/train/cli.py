"""Training CLI of the port: ``python -m glass_tpu_torch.train``.

Counterpart of ``tools/train_glass.py`` with the same arguments
(``--config --datasets --output --resume --weights --max-iter --debug
--distributed``, then ``KEY VALUE`` opts) plus ``--device`` (``cuda``, the
default, or ``cpu``):

    python -m glass_tpu_torch.train --config configs/glass_finetune_icdar15.yaml \\
        --datasets data_configs/example_datasets.yaml --output train_out

One command drives every local device, as glass_tpu's does: with more than
one device in the data group (``TPU.TRAIN_DEVICES``; 0 = every visible GPU)
it spawns one process per device, joined in a NCCL group (gloo on ``--device
cpu``, where ``TPU.TRAIN_DEVICES`` N spawns N ranks).  ``--distributed``
instead joins the group ``torchrun`` describes in the environment, one
process per GPU on one or more hosts:

    torchrun --nproc_per_node 8 -m glass_tpu_torch.train --distributed \\
        --config configs/glass_finetune_textocr.yaml --datasets ... --output ...
"""

from __future__ import annotations

import argparse
import os

import torch


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
                   help="join the torchrun-style process group of the environment (RANK, "
                        "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE config overrides")
    return p.parse_args(argv)


def load_cfg(args):
    from ..config import get_cfg, merge_from_dataset_config

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
    return cfg


def setup(args):
    """The config, the output directory and the (rank-aware) logger."""
    from ..utils.logger import setup_logger

    cfg = load_cfg(args)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    setup_logger(output=cfg.OUTPUT_DIR)
    return cfg


def data_group_size(cfg, device) -> int:
    """Processes a plain command trains in: ``TPU.TRAIN_DEVICES``, 0 meaning
    every visible GPU (one process on the CPU)."""
    n = int(cfg.TPU.TRAIN_DEVICES or 0)
    if n > 0:
        return n
    return torch.cuda.device_count() if torch.device(device or "cuda").type == "cuda" else 1


def _train(args, device):
    cfg = setup(args)
    from .trainer import Trainer

    trainer = Trainer(cfg, device=device)
    trainer.resume_or_load(resume=args.resume)
    trainer.train(max_iter=args.max_iter)
    return trainer


def _spawned(args) -> None:
    """One spawned rank: its device, then the same training as one process."""
    from ..parallel import mesh

    _train(args, mesh.rank_device(args.device, mesh.rank()))


def main(argv=None):
    """Train.  Returns the ``Trainer`` (its model, optimizer and storage),
    or None when it spawned one process per device (they train and exit)."""
    from ..parallel import mesh

    args = parse_args(argv)
    if args.distributed:
        device = mesh.init_from_env(args.device)
        try:
            return _train(args, device)
        finally:
            mesh.destroy()
    n = data_group_size(load_cfg(args), args.device)
    if n <= 1:
        return _train(args, args.device)
    cpu = torch.device(args.device or "cuda").type == "cpu"
    if not cpu and n > torch.cuda.device_count():
        raise ValueError(f"TPU.TRAIN_DEVICES={n} but only {torch.cuda.device_count()} GPUs are visible")
    mesh.launch(_spawned, n, args=(args,), device=args.device or "cuda",
                threads=max(1, (os.cpu_count() or 1) // n) if cpu else None)
    return None

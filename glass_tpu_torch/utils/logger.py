"""Colored, rank-aware logging (reference glass/utils/logger.py equivalent).

Process 0 logs to stdout + ``log.txt``; other processes log to
``log.txt.rank{N}`` only.  The rank is the ``torch.distributed`` rank when a
process group is initialized, else 0.
"""

from __future__ import annotations

import logging
import os
import sys

try:
    from termcolor import colored
except ImportError:  # pragma: no cover
    def colored(text, *a, **k):
        return text


class _ColorfulFormatter(logging.Formatter):
    def formatMessage(self, record):
        log = super().formatMessage(record)
        if record.levelno == logging.WARNING:
            prefix = colored("WARNING", "red", attrs=["blink"])
        elif record.levelno >= logging.ERROR:
            prefix = colored("ERROR", "red", attrs=["blink", "underline"])
        else:
            return log
        return prefix + " " + log


def _process_rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def setup_logger(output: str | None = None, name: str = "glass_tpu_torch",
                 rank: int | None = None, level=logging.INFO) -> logging.Logger:
    if rank is None:
        rank = _process_rank()

    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if logger.handlers:
        return logger

    plain = logging.Formatter(
        "[%(asctime)s %(name)s %(levelname)s] %(message)s", datefmt="%m/%d %H:%M:%S"
    )
    if rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setFormatter(
            _ColorfulFormatter(
                colored("[%(asctime)s %(name)s]", "green") + " %(message)s",
                datefmt="%m/%d %H:%M:%S",
            )
        )
        logger.addHandler(ch)

    if output:
        os.makedirs(output, exist_ok=True)
        filename = os.path.join(output, "log.txt")
        if rank > 0:
            filename = f"{filename}.rank{rank}"
        fh = logging.FileHandler(filename)
        fh.setFormatter(plain)
        logger.addHandler(fh)

    # Route the package root logger through the same handlers.
    root = logging.getLogger("glass_tpu_torch")
    if root is not logger and not root.handlers:
        for h in logger.handlers:
            root.addHandler(h)
        root.setLevel(level)
    return logger

"""The training path of the port: the training forward and step, matching,
losses, targets, optimizer, checkpoints, the ``Trainer`` and the CLI
(``python -m glass_tpu_torch.train``, ``glass_tpu_torch.train.main``)."""

from .cli import main

__all__ = ["main"]

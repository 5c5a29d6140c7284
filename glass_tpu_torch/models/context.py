"""Conv + norm building blocks with detectron2's parameter names.

Counterpart of ``glass_tpu/models/context.py`` (``conv_norm`` /
``apply_bn``): a d2 ``Conv2d`` carries its norm as a ``norm``
child, so a released checkpoint's ``<conv>.weight`` and
``<conv>.norm.{weight,bias,running_mean,running_var}`` load unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L


class BatchNorm2d(nn.Module):
    """Batch norm with PyTorch/d2 parameter names: running statistics in
    eval mode; in training mode (``module.train()``) batch statistics, with
    the running statistics updated in place (``L.batch_norm_train``, the
    arithmetic of glass_tpu's ``batch_norm(train=True)``).

    ``process_group`` (glass_tpu's ``Ctx.axis_name``) syncs the training
    statistics over that group's ranks; None, the default, keeps them per
    process (``parallel.mesh.sync_batch_norm`` sets it for a step)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.process_group = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.training:
            return L.batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                      self.running_var, self.eps, group=self.process_group)
        return L.batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var, self.eps)


class Conv2d(nn.Conv2d):
    """d2 ``Conv2d``: convolution, then the optional ``norm`` child, then
    the optional ReLU."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, bias=True,
                 norm: bool = False, relu: bool = False):
        super().__init__(cin, cout, kernel_size, stride, padding, bias=bias)
        if norm:
            self.norm = BatchNorm2d(cout)
        self.relu = relu

    def forward(self, x):
        out = L.conv2d(x, self.weight, self.bias, self.stride, self.padding)
        if hasattr(self, "norm"):
            out = self.norm(out)
        return L.relu(out) if self.relu else out


def conv_norm(cin, cout, kernel_size, stride=1, padding=0, relu=False) -> Conv2d:
    """Bias-free conv with an attached BN (d2 NORM=BN/SyncBN)."""
    return Conv2d(cin, cout, kernel_size, stride, padding, bias=False, norm=True, relu=relu)

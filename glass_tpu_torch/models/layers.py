"""The neural-net primitives, in PyTorch.

Counterpart of ``glass_tpu/models/layers.py``.  Activations are NCHW
tensors (kept in channels-last memory on the backbone path, so a feature
map's ``permute(0, 2, 3, 1)`` is the contiguous NHWC map the poolers read);
weights keep PyTorch's layouts (conv OIHW, linear (out, in), recurrent
weights gate-packed).  As in glass_tpu, parameters stay float32 and each
op casts its weights to the activation dtype, so ``TPU.COMPUTE_DTYPE``
bfloat16 or float16 runs the convolutions, products and recurrences in that
dtype; batch-norm statistics are taken in f32 (``batch_norm``,
``batch_norm_train``), and losses read f32 logits.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return F.conv2d(
        x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
        stride, padding, dilation, groups,
    )


def conv_transpose2d(x, weight, bias=None, stride=2):
    """``ConvTranspose2d`` with PyTorch's (in, out, kh, kw) weight."""
    return F.conv_transpose2d(
        x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), stride
    )


def linear(x, weight, bias=None):
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def relu(x):
    """glass_tpu's ReLU, ``jnp.maximum(x, 0)``: the gradient at x == 0 is
    1/2 (a tie of the maximum splits it), where ``torch.relu``'s is 0.
    ``torch.maximum`` splits ties the same way."""
    return torch.maximum(x, x.new_zeros(()))


def max_pool2d(x, kernel, stride=None, padding=0):
    return F.max_pool2d(x, kernel, stride, padding)


def upsample_nearest_2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def batch_norm(x, weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Eval-mode BatchNorm over dim 1: scale and shift are folded in f32,
    then cast to the activation dtype (glass_tpu's ``batch_norm``)."""
    denom = torch.sqrt(running_var + eps)
    scale = (weight / denom).to(x.dtype)
    shift = (bias - running_mean * weight / denom).to(x.dtype)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.reshape(shape) + shift.reshape(shape)


_recompute = threading.local()


@contextlib.contextmanager
def recomputing():
    """The recomputation of a checkpointed forward (``TPU.REMAT_BACKBONE``):
    inside it, training-mode batch norm leaves the running statistics as
    the first pass left them, so each step updates them once, as
    glass_tpu's rematerialized backbone returns its BN updates once.  Per
    thread: the backward may recompute on autograd's own."""
    prev = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = prev


def batch_norm_train(x, weight, bias, running_mean, running_var, eps: float = 1e-5,
                     momentum: float = 0.1, group=None):
    """Training-mode BatchNorm over dim 1 with glass_tpu's arithmetic: mean
    and mean of squares in f32 over the whole batch (padding included), the
    biased variance to normalize, ``(x - mean) * inv + b`` in the activation
    dtype, and the running statistics EMA-updated in place with the
    *unbiased* variance (not while ``recomputing``).

    With a process ``group`` (SyncBN, glass_tpu's ``axis_name``), the mean
    and the mean of squares are each averaged over the ranks, every rank
    weighing equally, and the gradient flows back through the average.  As
    in glass_tpu, the unbiased correction uses this rank's element count,
    not the group's."""
    dims = (0,) + tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=dims, dtype=torch.float32)
    mean_sq = torch.mean(torch.square(x.to(torch.float32)), dim=dims)
    if group is not None:
        from ..parallel.mesh import all_reduce_mean

        mean, mean_sq = all_reduce_mean(torch.cat([mean, mean_sq]), group).chunk(2)
    var = mean_sq - mean ** 2
    inv = weight / torch.sqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    out = (x - mean.to(x.dtype).reshape(shape)) * inv.to(x.dtype).reshape(shape) \
        + bias.to(x.dtype).reshape(shape)
    n = x.numel() // x.shape[1]
    if getattr(_recompute, "on", False):
        return out
    with torch.no_grad():
        unbiased = var * n / max(n - 1, 1)
        running_mean.copy_((1 - momentum) * running_mean + momentum * mean)
        running_var.copy_((1 - momentum) * running_var + momentum * unbiased)
    return out


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last dim."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight.to(x.dtype) + bias.to(x.dtype)


def bilstm(x: torch.Tensor, lstm: nn.LSTM) -> torch.Tensor:
    """Bidirectional single-layer LSTM over (B, T, I) -> (B, T, 2H), run by
    PyTorch's LSTM with the module's gate-packed weights cast to x.dtype."""
    params = {n: p.to(x.dtype) for n, p in lstm.named_parameters()}
    out, _ = torch.func.functional_call(lstm, params, (x,))
    return out


def gru_cell(x: torch.Tensor, h: torch.Tensor, gru: nn.GRU) -> torch.Tensor:
    """One GRU step (B, I), (B, H) -> (B, H); PyTorch gate order r, z, n:
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))."""
    gi = linear(x, gru.weight_ih_l0, gru.bias_ih_l0)
    gh = linear(h, gru.weight_hh_l0, gru.bias_hh_l0)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h

"""The neural-net primitives, in PyTorch (a frozen copy of the port's).

``PRECISION`` is the reference's arithmetic: "f32" (the reference) or
"fp8" (the control, the nearest precision below the configuration's
bfloat16: every convolution, product and recurrence takes its operands
rounded to float8 e4m3 with a per-tensor scale, and in the backward the
gradient arriving at its output is rounded the same way, so that both
products of its backward take float8 operands too; the float32 stages
stay float32, as in the program).  Activations are NCHW
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


PRECISION = {"mode": "f32"}
E4M3_MAX = 448.0


@contextlib.contextmanager
def control_precision():
    """The control's arithmetic inside the block, the reference's after it."""
    PRECISION["mode"] = "fp8"
    try:
        yield
    finally:
        PRECISION["mode"] = "f32"


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, in its own
    dtype."""
    if t.numel() == 0:
        return t
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _Fp8Operand(torch.autograd.Function):
    """An operand rounded to float8 on its way in; its gradient, computed
    from float8 operands already, passes through."""

    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Gradient(torch.autograd.Function):
    """The identity on the way in; the gradient rounded to float8 on its
    way back into the product that made ``t``."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


def _fp8_mode(t: torch.Tensor) -> bool:
    return PRECISION["mode"] == "fp8" and t.is_floating_point()


def q(t: torch.Tensor) -> torch.Tensor:
    """An operand of a convolution, product or recurrence."""
    return _Fp8Operand.apply(t) if _fp8_mode(t) else t


def qg(t: torch.Tensor) -> torch.Tensor:
    """The output of a convolution, product or recurrence."""
    return _Fp8Gradient.apply(t) if _fp8_mode(t) and t.requires_grad else t


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return qg(F.conv2d(
        q(x), q(weight.to(x.dtype)), None if bias is None else bias.to(x.dtype),
        stride, padding, dilation, groups,
    ))


def _bilinear_zero(x, y, xs):
    """x (N, G, C, H, W) sampled at the points y, xs (N, G, P): (N, G, C, P),
    bilinearly, each of the four corners that lies outside the map reading
    0 (the sampling of detectron2's deformable convolution)."""
    n, g, c, h, w = x.shape
    flat = x.reshape(n, g, c, h * w)
    y0, x0 = torch.floor(y), torch.floor(xs)
    ly, lx = y - y0, xs - x0
    y0, x0 = y0.long(), x0.long()
    out = 0
    for dy, wy in ((0, 1 - ly), (1, ly)):
        for dx, wx in ((0, 1 - lx), (1, lx)):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))[:, :, None].expand(n, g, c, -1)
            tap = (wy * wx * inside).to(x.dtype)[:, :, None]
            out = out + torch.gather(flat, 3, idx) * tap
    return out


def deform_conv2d(x, offset, mask, weight, stride=1, dilation=1, groups=1):
    """detectron2's deformable 3x3 convolution (``DeformConv``, and with a
    ``mask`` ``ModulatedDeformConv``), padding ``dilation``, no bias:

        y[o, p] = sum_k sum_{c in o's group} w[o, c, k] m_k(p) x_c(p s - d + k d + D_k(p))

    ``offset`` (N, 2 G K, Ho, Wo) holds D_k = (dy, dx) of tap k in channels
    2k and 2k + 1 of each deformable group's 2K (G groups of the input
    channels, taken in order); ``mask`` (N, G K, Ho, Wo) or None (m = 1).
    The taps are gathered (``_bilinear_zero``) into columns, then one
    product per convolution group."""
    n, c, h, w = x.shape
    cout, cg, kh, kw = weight.shape
    k = kh * kw
    ho, wo = offset.shape[2:]
    g = offset.shape[1] // (2 * k)
    rows = torch.arange(ho, device=x.device, dtype=torch.float32) * stride - dilation
    cols = torch.arange(wo, device=x.device, dtype=torch.float32) * stride - dilation
    ki = torch.arange(kh, device=x.device, dtype=torch.float32).repeat_interleave(kw) * dilation
    kj = torch.arange(kw, device=x.device, dtype=torch.float32).repeat(kh) * dilation
    off = offset.to(torch.float32).reshape(n, g, k, 2, ho, wo)
    y = rows[None, None, None, :, None] + ki[None, None, :, None, None] + off[:, :, :, 0]
    xs = cols[None, None, None, None, :] + kj[None, None, :, None, None] + off[:, :, :, 1]
    taps = _bilinear_zero(x.reshape(n, g, c // g, h, w), y.reshape(n, g, -1), xs.reshape(n, g, -1))
    taps = taps.reshape(n, g, c // g, k, ho * wo)
    if mask is not None:
        taps = taps * mask.reshape(n, g, 1, k, ho * wo).to(x.dtype)
    taps = taps.reshape(n, groups, cg * k, ho * wo)
    wg = weight.to(x.dtype).reshape(groups, cout // groups, cg * k)
    return einsum("goc,ngcl->ngol", wg, taps).reshape(n, cout, ho, wo)


def conv_transpose2d(x, weight, bias=None, stride=2):
    """``ConvTranspose2d`` with PyTorch's (in, out, kh, kw) weight."""
    return qg(F.conv_transpose2d(
        q(x), q(weight.to(x.dtype)), None if bias is None else bias.to(x.dtype), stride
    ))


def linear(x, weight, bias=None):
    return qg(F.linear(q(x), q(weight.to(x.dtype)), None if bias is None else bias.to(x.dtype)))


def einsum(equation: str, *operands):
    """``torch.einsum``, its operands and gradient rounded as a product's."""
    return qg(torch.einsum(equation, *(q(t) for t in operands)))


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
                     momentum: float = 0.1):
    """Training-mode BatchNorm over dim 1 with glass_tpu's arithmetic: mean
    and mean of squares in f32 over the whole batch (padding included), the
    biased variance to normalize, ``(x - mean) * inv + b`` in the activation
    dtype, and the running statistics EMA-updated in place with the
    *unbiased* variance (not while ``recomputing``)."""
    dims = (0,) + tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=dims, dtype=torch.float32)
    mean_sq = torch.mean(torch.square(x.to(torch.float32)), dim=dims)
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
    params = {n: q(p.to(x.dtype)) for n, p in lstm.named_parameters()}
    out, _ = torch.func.functional_call(lstm, params, (q(x),))
    return qg(out)


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

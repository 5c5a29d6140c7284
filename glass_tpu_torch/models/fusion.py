"""Global-to-local feature fusion: P2P3Fusion and the hybrid fusion modules.

Counterpart of ``glass_tpu/models/fusion.py`` (``FUSION_MODULES``), with the
module names of reference ``glass/modeling/fusion/fusion_modules.py``:

* ``MultiAspectGCAttention`` with ``fusion_type`` ``channel_add`` (the
  ICDAR15 model), ``channel_mul`` (a sigmoid-gated channel scaling) or
  ``channel_concat`` (the context broadcast and concatenated, a 1x1
  ``cat_conv``, LayerNorm over (C, H, W), ReLU);
* ``SimpleAttention`` (x * linear(x), then a 1x1 conv), ``LocalOnly`` (the
  local half of the channels) and ``Conv1x1``.

``build_fusion`` picks one from ``MODEL.HYBRID_FUSION.{NAME,FUSION_TYPE}``.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L


class P2P3Fusion(nn.Module):
    """1x1 conv each on p2 and on 2x-upsampled p3, summed."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 1, bias=False)
        self.conv2 = nn.Conv2d(channels, channels, 1, bias=False)

    def forward(self, p2: torch.Tensor, p3: torch.Tensor) -> torch.Tensor:
        """p2 (N, C, H, W), p3 (N, C, H/2, W/2) -> (N, C, H, W)."""
        x1 = L.conv2d(p2, self.conv1.weight)
        x2 = L.upsample_nearest_2x(L.conv2d(p3, self.conv2.weight))
        return x1 + x2[:, :, : x1.shape[2], : x1.shape[3]]


# the bottleneck's module name for each GC fusion type (fusion_modules.py:60-79)
GC_BOTTLENECK = {
    "channel_add": "channel_add_conv",
    "channel_mul": "channel_mul_conv",
    "channel_concat": "channel_concat_conv",
}


class MultiAspectGCAttention(nn.Module):
    """Channel-interleave local/global features, 8-header global-context
    attention, the ``fusion_type`` bottleneck, 3x3 output conv."""

    def __init__(self, inplanes: int = 512, ratio: float = 0.5, headers: int = 8,
                 outplane: int = 256, fusion_type: str = "channel_add"):
        super().__init__()
        if fusion_type not in GC_BOTTLENECK:
            raise NotImplementedError(f"fusion MultiAspectGCAttention/{fusion_type}")
        planes = int(inplanes * ratio)
        self.fusion_type = fusion_type
        self.headers = headers
        self.single = inplanes // headers
        self.conv_mask = nn.Conv2d(self.single, 1, 1)
        setattr(self, GC_BOTTLENECK[fusion_type], nn.Sequential(
            nn.Conv2d(inplanes, planes, 1),
            nn.LayerNorm([planes, 1, 1]),
            nn.ReLU(),
            nn.Conv2d(planes, inplanes, 1),
        ))
        if fusion_type == "channel_concat":
            self.cat_conv = nn.Conv2d(2 * inplanes, inplanes, 1)
        self.out = nn.Conv2d(inplanes, outplane, 3, padding=1)
        half = inplanes // 2
        # even channels <- local half, odd <- global half (reference `order`)
        self.order = torch.stack([torch.arange(half), torch.arange(half) + half], 1).reshape(-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C, H, W), local channels first -> (N, outplane, H, W)."""
        x = x[:, self.order.to(x.device)]
        n, c, h, w = x.shape
        xh = x.reshape(n, self.headers, self.single, h * w)
        w_mask = self.conv_mask.weight.reshape(self.single).to(x.dtype)
        mask = torch.einsum("nkcp,c->nkp", xh, w_mask) + self.conv_mask.bias.to(x.dtype)
        mask = torch.softmax(mask, dim=2)
        context = torch.einsum("nkcp,nkp->nkc", xh, mask).reshape(n, c)
        c0, ln, _, c3 = getattr(self, GC_BOTTLENECK[self.fusion_type])
        t = L.linear(context, c0.weight.reshape(-1, c), c0.bias)
        t = L.relu(L.layer_norm(t, ln.weight.reshape(-1), ln.bias.reshape(-1)))
        t = L.linear(t, c3.weight.reshape(c, -1), c3.bias)
        if self.fusion_type == "channel_add":
            out = x + t[:, :, None, None]
        elif self.fusion_type == "channel_mul":
            out = x * torch.sigmoid(t)[:, :, None, None]
        else:
            out = torch.cat([x, t[:, :, None, None].expand(n, c, h, w)], dim=1)
            out = L.conv2d(out, self.cat_conv.weight, self.cat_conv.bias)
            # F.layer_norm over [C, H, W], no affine
            mean = out.mean(dim=(1, 2, 3), keepdim=True)
            var = out.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
            out = L.relu((out - mean) / torch.sqrt(var + 1e-5))
        return L.conv2d(out, self.out.weight, self.out.bias, padding=1)


class SimpleAttention(nn.Module):
    """x * linear(x) over the channels, then a 1x1 conv (fusion_modules.py:161-186)."""

    def __init__(self, inplanes: int = 512, outplane: int = 256):
        super().__init__()
        self.linear = nn.Linear(inplanes, inplanes, bias=False)
        self.conv = nn.Conv2d(inplanes, outplane, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = L.linear(x.permute(0, 2, 3, 1), self.linear.weight).permute(0, 3, 1, 2) * x
        return L.conv2d(t, self.conv.weight)


class LocalOnly(nn.Module):
    """The local half of the channels (fusion_modules.py:190-218)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, : x.shape[1] // 2]


class Conv1x1(nn.Module):
    """A bias-free 1x1 conv (fusion_modules.py:222-247)."""

    def __init__(self, inplanes: int = 512, outplane: int = 256):
        super().__init__()
        self.conv = nn.Conv2d(inplanes, outplane, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.conv2d(x, self.conv.weight)


def build_fusion(name: str = "MultiAspectGCAttention", fusion_type: str = "channel_add",
                 inplanes: int = 512, ratio: float = 0.5, headers: int = 8,
                 outplane: int = 256) -> nn.Module:
    """The fusion module of ``MODEL.HYBRID_FUSION`` (glass_tpu's
    ``apply_fusion``/``init_fusion``); ``FUSION_TYPE`` is read only by
    MultiAspectGCAttention."""
    if name == "MultiAspectGCAttention":
        return MultiAspectGCAttention(inplanes, ratio, headers, outplane, fusion_type)
    if name == "SimpleAttention":
        return SimpleAttention(inplanes, outplane)
    if name == "LocalOnly":
        return LocalOnly()
    if name == "Conv1x1":
        return Conv1x1(inplanes, outplane)
    raise NotImplementedError(f"fusion {name}/{fusion_type}")

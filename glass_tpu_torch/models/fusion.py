"""Global-to-local feature fusion: P2P3Fusion + MultiAspectGCAttention.

Counterpart of ``glass_tpu/models/fusion.py`` for the configuration the
ICDAR15 model uses (``MultiAspectGCAttention`` with ``channel_add``), with
the module names of reference ``glass/modeling/fusion/fusion_modules.py``.
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


class MultiAspectGCAttention(nn.Module):
    """Channel-interleave local/global features, 8-header global-context
    attention, ``channel_add`` bottleneck, 3x3 output conv."""

    def __init__(self, inplanes: int = 512, ratio: float = 0.5, headers: int = 8,
                 outplane: int = 256, fusion_type: str = "channel_add"):
        super().__init__()
        if fusion_type != "channel_add":
            raise NotImplementedError(
                f"HYBRID_FUSION.FUSION_TYPE {fusion_type!r} is not ported yet (channel_add is)"
            )
        planes = int(inplanes * ratio)
        self.headers = headers
        self.single = inplanes // headers
        self.conv_mask = nn.Conv2d(self.single, 1, 1)
        self.channel_add_conv = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1),
            nn.LayerNorm([planes, 1, 1]),
            nn.ReLU(),
            nn.Conv2d(planes, inplanes, 1),
        )
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
        c0, ln, _, c3 = self.channel_add_conv
        t = L.linear(context, c0.weight.reshape(-1, c), c0.bias)
        t = L.relu(L.layer_norm(t, ln.weight.reshape(-1), ln.bias.reshape(-1)))
        t = L.linear(t, c3.weight.reshape(c, -1), c3.bias)
        out = x + t[:, :, None, None]
        return L.conv2d(out, self.out.weight, self.out.bias, padding=1)

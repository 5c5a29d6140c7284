"""Feature Pyramid Network over the ResNet trunk (detectron2 names).

Counterpart of ``glass_tpu/models/fpn.py``: ``fpn_lateral{2..5}`` and
``fpn_output{2..5}`` convs with attached norm, sum fusion with nearest 2x
upsampling, and a ``LastLevelMaxPool`` P6.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from . import layers as L
from .context import conv_norm
from .resnet import ResNet50, STAGE_CHANNELS

FPN_LEVEL_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
_STAGES = ("res2", "res3", "res4", "res5")


class ResNetFPN(nn.Module):
    def __init__(self, out_channels: int = 256, freeze_at: int = 0):
        super().__init__()
        self.bottom_up = ResNet50(freeze_at)
        for i, s in enumerate(_STAGES, start=2):
            setattr(self, f"fpn_lateral{i}", conv_norm(STAGE_CHANNELS[s], out_channels, 1))
            setattr(self, f"fpn_output{i}", conv_norm(out_channels, out_channels, 3, 1, 1))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: (N, 3, H, W) normalized image -> p2..p6 (NCHW)."""
        bottom_up = self.bottom_up(x)
        lat = {s: getattr(self, f"fpn_lateral{i}")(bottom_up[s]) for i, s in enumerate(_STAGES, 2)}
        merged = {"res5": lat["res5"]}
        for prev, cur in (("res5", "res4"), ("res4", "res3"), ("res3", "res2")):
            merged[cur] = lat[cur] + L.upsample_nearest_2x(merged[prev])
        out = {f"p{i}": getattr(self, f"fpn_output{i}")(merged[s]) for i, s in enumerate(_STAGES, 2)}
        out["p6"] = L.max_pool2d(out["p5"], 1, 2, 0)
        return out

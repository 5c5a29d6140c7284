"""ResNet-50 bottom-up backbone (detectron2 parameter names).

Counterpart of ``glass_tpu/models/resnet.py`` at inference: the plain
7x7/2 stem (glass_tpu uses its space-to-depth stems only for training),
stride in the 1x1 conv of each block (d2 ``stride_in_1x1``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from . import layers as L
from .context import conv_norm

# (name, num_blocks, bottleneck_channels, out_channels, first stride)
RESNET50_STAGES = [
    ("res2", 3, 64, 256, 1),
    ("res3", 4, 128, 512, 2),
    ("res4", 6, 256, 1024, 2),
    ("res5", 3, 512, 2048, 2),
]
STAGE_CHANNELS = {name: out for name, _, _, out, _ in RESNET50_STAGES}


class BottleneckBlock(nn.Module):
    def __init__(self, cin, mid, cout, stride):
        super().__init__()
        self.conv1 = conv_norm(cin, mid, 1, stride, relu=True)
        self.conv2 = conv_norm(mid, mid, 3, 1, 1, relu=True)
        self.conv3 = conv_norm(mid, cout, 1)
        if stride != 1 or cin != cout:
            self.shortcut = conv_norm(cin, cout, 1, stride)

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        shortcut = self.shortcut(x) if hasattr(self, "shortcut") else x
        return torch.relu(out + shortcut)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        stem = nn.Module()
        stem.conv1 = conv_norm(3, 64, 7, 2, 3, relu=True)
        self.stem = stem
        cin = 64
        for name, n_blocks, mid, cout, stride in RESNET50_STAGES:
            blocks = [BottleneckBlock(cin if i == 0 else cout, mid, cout, stride if i == 0 else 1)
                      for i in range(n_blocks)]
            setattr(self, name, nn.Sequential(*blocks))
            cin = cout

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: (N, 3, H, W) normalized image -> res2..res5 (NCHW)."""
        x = L.max_pool2d(self.stem.conv1(x), 3, 2, 1)
        feats = {}
        for name, *_ in RESNET50_STAGES:
            x = getattr(self, name)(x)
            feats[name] = x
        return feats

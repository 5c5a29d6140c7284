"""ResNet-50 bottom-up backbone (detectron2 parameter names).

Counterpart of ``glass_tpu/models/resnet.py``: the plain 7x7/2 stem for
every ``TPU.STEM_BACKEND`` (glass_tpu's space-to-depth training stems are
the same function, laid out for the TPU's matrix unit), stride in the 1x1
conv of each block (d2 ``stride_in_1x1``), and d2's
``MODEL.BACKBONE.FREEZE_AT``: in training the frozen stages run their BN on
the running statistics and take no gradient.
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
        return L.relu(out + shortcut)


class ResNet50(nn.Module):
    def __init__(self, freeze_at: int = 0):
        super().__init__()
        self.freeze_at = freeze_at
        stem = nn.Module()
        stem.conv1 = conv_norm(3, 64, 7, 2, 3, relu=True)
        self.stem = stem
        cin = 64
        for name, n_blocks, mid, cout, stride in RESNET50_STAGES:
            blocks = [BottleneckBlock(cin if i == 0 else cout, mid, cout, stride if i == 0 else 1)
                      for i in range(n_blocks)]
            setattr(self, name, nn.Sequential(*blocks))
            cin = cout

    def _frozen(self, stage_index: int) -> bool:
        """Stage 1 is the stem, 2 res2, ... (d2 ``freeze_at``)."""
        return self.training and self.freeze_at >= stage_index

    def train(self, mode: bool = True):
        super().train(mode)
        for i, stage in enumerate([self.stem] + [getattr(self, n) for n, *_ in RESNET50_STAGES], 1):
            if self._frozen(i):
                stage.eval()  # FrozenBN: running statistics, no update
        return self

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: (N, 3, H, W) normalized image -> res2..res5 (NCHW)."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self._frozen(1)):
            x = L.max_pool2d(self.stem.conv1(x), 3, 2, 1)
        feats = {}
        for i, (name, *_) in enumerate(RESNET50_STAGES, 2):
            with torch.set_grad_enabled(torch.is_grad_enabled() and not self._frozen(i)):
                x = getattr(self, name)(x)
            feats[name] = x
        return feats

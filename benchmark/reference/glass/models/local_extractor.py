"""Local feature extractor: the ResNet [1, 2, 5, 3] over raw-image crops.

Counterpart of ``glass_tpu/models/local_extractor.py`` (reference
``glass/modeling/fusion/local_feature_extraction.py``):

* ``ResNetFeatureExtractor``: three max-pools (the last with stride (2, 1)
  and width padding) and a final 2x2 stride-(2, 1) conv take a 128 x 128
  crop to the (256, 8, 32) shape of the pooled global features;
* ``ResNetFeatureExtractorV2`` (:191-288): the same blocks with only the
  first two max-pools and a 3x3 ``conv4_1``, so a 128 x 128 crop maps to
  (256, 32, 32).  Its crop/4 output never matches the recognizer's pool,
  so ``GlassArch.from_config`` refuses it with the recognizer on, as
  glass_tpu does; it is a module of its own.

``LOCAL_EXTRACTORS`` is glass_tpu's ``LOCAL_EXTRACTOR_REGISTRY``.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .context import BatchNorm2d

LAYERS = (1, 2, 5, 3)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        if cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, bias=False), BatchNorm2d(cout))

    def forward(self, x):
        out = L.relu(self.bn1(L.conv2d(x, self.conv1.weight, padding=1)))
        out = self.bn2(L.conv2d(out, self.conv2.weight, padding=1))
        if hasattr(self, "downsample"):
            conv, bn = self.downsample
            residual = bn(L.conv2d(x, conv.weight))
        else:
            residual = x
        return L.relu(out + residual)


class LocalResNet(nn.Module):
    """The ``ResNet`` inside ``ResNetFeatureExtractor`` (output 256); with
    ``v2``, the one inside ``ResNetFeatureExtractorV2``."""

    def __init__(self, out: int = 256, v2: bool = False):
        super().__init__()
        self.v2 = v2
        block_ch = (out // 4, out // 2, out, out)
        inplanes = out // 8

        def stage(cin, cout, n):
            return nn.Sequential(*[BasicBlock(cin if i == 0 else cout, cout) for i in range(n)])

        self.conv0_1 = nn.Conv2d(3, out // 16, 3, padding=1, bias=False)
        self.bn0_1 = BatchNorm2d(out // 16)
        self.conv0_2 = nn.Conv2d(out // 16, inplanes, 3, padding=1, bias=False)
        self.bn0_2 = BatchNorm2d(inplanes)
        self.layer1 = stage(inplanes, block_ch[0], LAYERS[0])
        self.conv1 = nn.Conv2d(block_ch[0], block_ch[0], 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(block_ch[0])
        self.layer2 = stage(block_ch[0], block_ch[1], LAYERS[1])
        self.conv2 = nn.Conv2d(block_ch[1], block_ch[1], 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(block_ch[1])
        self.layer3 = stage(block_ch[1], block_ch[2], LAYERS[2])
        self.conv3 = nn.Conv2d(block_ch[2], block_ch[2], 3, padding=1, bias=False)
        self.bn3 = BatchNorm2d(block_ch[2])
        self.layer4 = stage(block_ch[2], block_ch[3], LAYERS[3])
        self.conv4_1 = nn.Conv2d(block_ch[3], block_ch[3], 3 if v2 else 2, bias=False)
        self.bn4_1 = BatchNorm2d(block_ch[3])

    def _conv_bn_relu(self, x, conv, bn, **kw):
        return L.relu(bn(L.conv2d(x, conv.weight, **kw)))

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        """crops (N, 3, 128, 128) normalized -> (N, 256, 8, 32); V2: (N, 256, 32, 32)."""
        x = self._conv_bn_relu(crops, self.conv0_1, self.bn0_1, padding=1)
        x = self._conv_bn_relu(x, self.conv0_2, self.bn0_2, padding=1)
        x = self.layer1(L.max_pool2d(x, 2, 2, 0))
        x = self._conv_bn_relu(x, self.conv1, self.bn1, padding=1)
        x = self.layer2(L.max_pool2d(x, 2, 2, 0))
        x = self._conv_bn_relu(x, self.conv2, self.bn2, padding=1)
        x = self.layer3(x if self.v2 else L.max_pool2d(x, 2, (2, 1), (0, 1)))
        x = self._conv_bn_relu(x, self.conv3, self.bn3, padding=1)
        x = self.layer4(x)
        if self.v2:
            return self._conv_bn_relu(x, self.conv4_1, self.bn4_1, padding=1)
        return self._conv_bn_relu(x, self.conv4_1, self.bn4_1, stride=(2, 1))


class ResNetFeatureExtractor(nn.Module):
    """Reference wrapper: the network is the ``ConvNet`` child."""

    v2 = False

    def __init__(self, out: int = 256):
        super().__init__()
        self.ConvNet = LocalResNet(out, self.v2)

    def forward(self, crops):
        return self.ConvNet(crops)


class ResNetFeatureExtractorV2(ResNetFeatureExtractor):
    v2 = True


LOCAL_EXTRACTORS = {
    "ResNetFeatureExtractor": ResNetFeatureExtractor,
    "ResNetFeatureExtractorV2": ResNetFeatureExtractorV2,
}


def build_local_extractor(name: str = "ResNetFeatureExtractor", out: int = 256) -> nn.Module:
    """The extractor of ``MODEL.LOCAL_FEATURE_EXTRACTOR.NAME``."""
    if name not in LOCAL_EXTRACTORS:
        raise ValueError(
            f"Unknown MODEL.LOCAL_FEATURE_EXTRACTOR.NAME {name!r}; supported: "
            f"{sorted(LOCAL_EXTRACTORS)} (GRCL/ResNet_ASTER/FeatureAttention are library "
            "modules, models/local_extractor_variants.py, selected by no config key)")
    return LOCAL_EXTRACTORS[name](out)

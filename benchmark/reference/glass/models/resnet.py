"""The ResNet bottom-up trunk that ``MODEL.RESNETS`` names (detectron2
parameter names), after detectron2's ``build_resnet_backbone``.

The plain 7x7/2 stem for every ``TPU.STEM_BACKEND`` (glass_tpu's
space-to-depth training stems are the same function, laid out for the TPU's
matrix unit); the bottleneck stages of ``DEPTH`` 50, 101 or 152, with
``NUM_GROUPS`` x ``WIDTH_PER_GROUP`` channels in res2's bottleneck, doubled
each stage, and its 3x3 convolution grouped by ``NUM_GROUPS``; the first
block's stride in the 1x1 or the 3x3 convolution (``STRIDE_IN_1X1``); res5 at
``RES5_DILATION`` 1 or 2 (then at stride 1); the deformable 3x3 convolution
of d2's ``DeformBottleneckBlock`` in the stages ``DEFORM_ON_PER_STAGE``
names; and d2's ``MODEL.BACKBONE.FREEZE_AT``: in training the frozen stages
run their BN on the running statistics and take no gradient.  A value the
reference does not build raises a ``ValueError`` that names its key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from . import layers as L
from .context import BatchNorm2d, Conv2d, conv_norm

STAGES = ("res2", "res3", "res4", "res5")
BLOCKS_PER_STAGE = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
NORMS = ("BN", "SyncBN")  # one process: SyncBN is BN


def _refuse(key, value, built):
    raise ValueError(f"MODEL.RESNETS.{key}={value!r}: the reference builds {built}")


@dataclass(frozen=True)
class Trunk:
    """The ``MODEL.RESNETS`` keys the reference builds; the defaults are
    ResNet-50's."""

    depth: int = 50
    num_groups: int = 1
    width_per_group: int = 64
    stride_in_1x1: bool = True
    stem_out_channels: int = 64
    res2_out_channels: int = 256
    res5_dilation: int = 1
    deform_on_per_stage: Tuple[bool, ...] = (False, False, False, False)
    deform_modulated: bool = False
    deform_num_groups: int = 1

    @classmethod
    def from_config(cls, r) -> "Trunk":
        if r.DEPTH not in BLOCKS_PER_STAGE:
            _refuse("DEPTH", r.DEPTH, f"the bottleneck trunks {sorted(BLOCKS_PER_STAGE)}")
        if r.RES5_DILATION not in (1, 2):
            _refuse("RES5_DILATION", r.RES5_DILATION, "1 or 2")
        if r.NORM not in NORMS:
            _refuse("NORM", r.NORM, f"one of {NORMS}")
        if list(r.OUT_FEATURES) != list(STAGES):
            _refuse("OUT_FEATURES", r.OUT_FEATURES, f"{list(STAGES)}")
        if len(r.DEFORM_ON_PER_STAGE) != len(STAGES):
            _refuse("DEFORM_ON_PER_STAGE", r.DEFORM_ON_PER_STAGE, "one flag for each of res2..res5")
        for key in ("NUM_GROUPS", "WIDTH_PER_GROUP", "STEM_OUT_CHANNELS", "RES2_OUT_CHANNELS", "DEFORM_NUM_GROUPS"):
            if not isinstance(r[key], int) or r[key] < 1:
                _refuse(key, r[key], "a positive whole number")
        trunk = cls(depth=r.DEPTH, num_groups=r.NUM_GROUPS, width_per_group=r.WIDTH_PER_GROUP,
                    stride_in_1x1=bool(r.STRIDE_IN_1X1), stem_out_channels=r.STEM_OUT_CHANNELS,
                    res2_out_channels=r.RES2_OUT_CHANNELS, res5_dilation=r.RES5_DILATION,
                    deform_on_per_stage=tuple(bool(v) for v in r.DEFORM_ON_PER_STAGE),
                    deform_modulated=bool(r.DEFORM_MODULATED), deform_num_groups=r.DEFORM_NUM_GROUPS)
        if any(trunk.deform_on_per_stage) and trunk.bottleneck_channels % trunk.deform_num_groups:
            _refuse("DEFORM_NUM_GROUPS", r.DEFORM_NUM_GROUPS,
                    f"a divisor of res2's bottleneck width {trunk.bottleneck_channels}")
        return trunk

    @property
    def bottleneck_channels(self) -> int:
        """res2's bottleneck width; each later stage doubles it."""
        return self.num_groups * self.width_per_group

    @property
    def stage_channels(self) -> Dict[str, int]:
        return {name: self.res2_out_channels * 2 ** i for i, name in enumerate(STAGES)}


class DeformConv(nn.Module):
    """d2's ``DeformConv`` / ``ModulatedDeformConv`` 3x3 with its ``norm``
    child and no bias, fed by the block's ``conv2_offset``: in the
    modulated form the first two thirds of that output are the offsets and
    the sigmoid of the last third the mask."""

    def __init__(self, cin, cout, stride, dilation, groups, modulated):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)  # nn.Conv2d's; the seeded weights replace it
        self.norm = BatchNorm2d(cout)
        self.stride, self.dilation, self.groups, self.modulated = stride, dilation, groups, modulated

    def forward(self, x, offset_mask):
        if self.modulated:
            n_off = offset_mask.shape[1] // 3 * 2
            offset, mask = offset_mask[:, :n_off], torch.sigmoid(offset_mask[:, n_off:])
        else:
            offset, mask = offset_mask, None
        out = L.deform_conv2d(x, offset, mask, self.weight, self.stride, self.dilation, self.groups)
        return L.relu(self.norm(out))


class BottleneckBlock(nn.Module):
    """d2's ``BottleneckBlock``; with ``deform`` (modulated, deformable
    groups) its ``DeformBottleneckBlock``, whose conv2 is a deformable
    convolution of the same stride, dilation and groups, its offsets from
    ``conv2_offset``, a plain 3x3 convolution with a bias and 18 (27
    modulated) outputs a deformable group."""

    def __init__(self, cin, mid, cout, stride, groups=1, stride_in_1x1=True, dilation=1, deform=None):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = conv_norm(cin, mid, 1, s1, relu=True)
        if deform is None:
            self.conv2 = conv_norm(mid, mid, 3, s3, dilation, relu=True, dilation=dilation, groups=groups)
        else:
            modulated, deform_groups = deform
            self.conv2_offset = Conv2d(mid, (27 if modulated else 18) * deform_groups, 3, s3, dilation,
                                       dilation=dilation)
            self.conv2 = DeformConv(mid, mid, s3, dilation, groups, modulated)
        self.conv3 = conv_norm(mid, cout, 1)
        if cin != cout:
            self.shortcut = conv_norm(cin, cout, 1, stride)

    def forward(self, x):
        out = self.conv1(x)
        out = self.conv2(out, self.conv2_offset(out)) if hasattr(self, "conv2_offset") else self.conv2(out)
        out = self.conv3(out)
        shortcut = self.shortcut(x) if hasattr(self, "shortcut") else x
        return L.relu(out + shortcut)


class ResNet(nn.Module):
    def __init__(self, trunk: Trunk = Trunk(), freeze_at: int = 0):
        super().__init__()
        self.trunk, self.freeze_at = trunk, freeze_at
        stem = nn.Module()
        stem.conv1 = conv_norm(3, trunk.stem_out_channels, 7, 2, 3, relu=True)
        self.stem = stem
        cin, mid = trunk.stem_out_channels, trunk.bottleneck_channels
        for i, (name, n_blocks) in enumerate(zip(STAGES, BLOCKS_PER_STAGE[trunk.depth])):
            cout = trunk.stage_channels[name]
            dilation = trunk.res5_dilation if name == "res5" else 1
            first_stride = 1 if i == 0 or dilation == 2 else 2
            deform = (trunk.deform_modulated, trunk.deform_num_groups) if trunk.deform_on_per_stage[i] else None
            blocks = [BottleneckBlock(cin if b == 0 else cout, mid, cout, first_stride if b == 0 else 1,
                                      trunk.num_groups, trunk.stride_in_1x1, dilation, deform)
                      for b in range(n_blocks)]
            setattr(self, name, nn.Sequential(*blocks))
            cin, mid = cout, mid * 2

    def _frozen(self, stage_index: int) -> bool:
        """Stage 1 is the stem, 2 res2, ... (d2 ``freeze_at``)."""
        return self.training and self.freeze_at >= stage_index

    def train(self, mode: bool = True):
        super().train(mode)
        for i, stage in enumerate([self.stem] + [getattr(self, n) for n in STAGES], 1):
            if self._frozen(i):
                stage.eval()  # FrozenBN: running statistics, no update
        return self

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: (N, 3, H, W) normalized image -> res2..res5 (NCHW)."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self._frozen(1)):
            x = L.max_pool2d(self.stem.conv1(x), 3, 2, 1)
        feats = {}
        for i, name in enumerate(STAGES, 2):
            with torch.set_grad_enabled(torch.is_grad_enabled() and not self._frozen(i)):
                x = getattr(self, name)(x)
            feats[name] = x
        return feats

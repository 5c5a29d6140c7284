"""Alternative local-feature-extractor bodies, as a library.

Counterpart of ``glass_tpu/models/local_extractor_variants.py`` (reference
``glass/modeling/fusion/local_feature_extraction.py``): the gated recurrent
conv layer (GRCL, :44-92), the ASTER trunk (AsterBlock/ResNet_ASTER,
:360-448) and the sigmoid FeatureAttention gate (:326-333).  No config key
selects them, in glass_tpu or here; their parameter names are glass_tpu's
tree's, so ``glass_tpu_torch.weights`` carries a tree across.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .context import BatchNorm2d


class GRCLUnit(nn.Module):
    """The five batch norms of one recurrence step."""

    def __init__(self, cout: int):
        super().__init__()
        for name in ("BN_gfu", "BN_grx", "BN_fu", "BN_rx", "BN_Gx"):
            setattr(self, name, BatchNorm2d(cout))


class GRCL(nn.Module):
    """Gated recurrent convolution layer: the input projections are
    constant over the recurrence; each step gates the recurrent state."""

    def __init__(self, cin: int, cout: int, num_iteration: int, kernel: int):
        super().__init__()
        self.num_iteration = num_iteration
        self.wgf_u = nn.Conv2d(cin, cout, 1, bias=False)
        self.wgr_x = nn.Conv2d(cout, cout, 1, bias=False)
        self.wf_u = nn.Conv2d(cin, cout, kernel, bias=False)
        self.wr_x = nn.Conv2d(cout, cout, kernel, bias=False)
        self.BN_x_init = BatchNorm2d(cout)
        self.GRCL = nn.ModuleList([GRCLUnit(cout) for _ in range(num_iteration)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, cin, H, W) -> (N, cout, H, W)."""
        wgf_u = L.conv2d(x, self.wgf_u.weight)
        wf_u = L.conv2d(x, self.wf_u.weight, padding=self.wf_u.weight.shape[2] // 2)
        state = L.relu(self.BN_x_init(wf_u))
        for unit in self.GRCL:
            wgr_x = L.conv2d(state, self.wgr_x.weight)
            wr_x = L.conv2d(state, self.wr_x.weight, padding=self.wr_x.weight.shape[2] // 2)
            g = torch.sigmoid(unit.BN_gfu(wgf_u) + unit.BN_grx(wgr_x))
            gated = unit.BN_Gx(unit.BN_rx(wr_x) * g)
            state = L.relu(unit.BN_fu(wf_u) + gated)
        return state


# (planes, blocks, stride) of each ResNet_ASTER stage
ASTER_STAGES = (
    (32, 3, (2, 2)),
    (64, 4, (2, 2)),
    (128, 6, (2, 1)),
    (256, 6, (2, 1)),
    (512, 3, (2, 1)),
)


class AsterBlock(nn.Module):
    """1x1 conv (strided) + 3x3 conv, each with BN, and a residual."""

    def __init__(self, cin: int, planes: int, stride, downsample: bool):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, bias=False)
        self.bn2 = BatchNorm2d(planes)
        if downsample:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, bias=False), BatchNorm2d(planes))

    def forward(self, x):
        out = L.relu(self.bn1(L.conv2d(x, self.conv1.weight, stride=self.stride)))
        out = self.bn2(L.conv2d(out, self.conv2.weight, padding=1))
        if hasattr(self, "downsample"):
            conv, bn = self.downsample
            residual = bn(L.conv2d(x, conv.weight, stride=self.stride))
        else:
            residual = x
        return L.relu(out + residual)


class ResNet_ASTER(nn.Module):
    """The ASTER trunk: a 3x3 stem and five stages; (N, C_in, 32, W) ->
    (N, W / 4, 512) sequence features (the height collapsed to 1)."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.layer0 = nn.Sequential(nn.Conv2d(in_channels, 32, 3, bias=False), BatchNorm2d(32))
        inplanes = 32
        for si, (planes, blocks, stride) in enumerate(ASTER_STAGES, start=1):
            setattr(self, f"layer{si}", nn.Sequential(*[
                AsterBlock(inplanes if bi == 0 else planes, planes, stride if bi == 0 else 1,
                           bi == 0 and (stride != (1, 1) or inplanes != planes))
                for bi in range(blocks)
            ]))
            inplanes = planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.layer0
        out = L.relu(bn(L.conv2d(x, conv.weight, padding=1)))
        for si in range(1, len(ASTER_STAGES) + 1):
            out = getattr(self, f"layer{si}")(out)
        return out[:, :, 0].transpose(1, 2)


class FeatureAttention(nn.Module):
    """A sigmoid gate from a 3x3 conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(L.conv2d(x, self.conv.weight, self.conv.bias, padding=1))

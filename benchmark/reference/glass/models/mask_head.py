"""Rotated Mask R-CNN conv-upsample head at inference.

Counterpart of ``glass_tpu/models/mask_head.py``: d2
``MaskRCNNConvUpsampleHead`` (NUM_CONV 3x3 convs, 2x2 stride-2 deconv,
ReLU, 1x1 predictor) on the 14 x 14 rotated pools, then
``mask_rcnn_inference``'s per-instance class channel and sigmoid.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L


class MaskRCNNConvUpsampleHead(nn.Module):
    def __init__(self, channels: int = 256, conv_dim: int = 256, num_conv: int = 4,
                 num_classes: int = 1):
        super().__init__()
        self.num_conv = num_conv
        cin = channels
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", nn.Conv2d(cin, conv_dim, 3, padding=1))
            cin = conv_dim
        self.deconv = nn.ConvTranspose2d(conv_dim, conv_dim, 2, 2)
        self.predictor = nn.Conv2d(conv_dim, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C, 14, 14) -> mask logits (N, K, 28, 28)."""
        for i in range(self.num_conv):
            conv = getattr(self, f"mask_fcn{i + 1}")
            x = L.relu(L.conv2d(x, conv.weight, conv.bias, padding=1))
        x = L.relu(L.conv_transpose2d(x, self.deconv.weight, self.deconv.bias, 2))
        return L.conv2d(x, self.predictor.weight, self.predictor.bias)


def mask_inference_probs(logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """logits (N, K, H, W), classes (N,) -> (N, H, W) probabilities."""
    idx = classes.to(torch.int64)[:, None, None, None].expand(-1, 1, *logits.shape[2:])
    return torch.sigmoid(torch.gather(logits, 1, idx)[:, 0])

"""ResNet-50 backbone (pytorch style, frozen BN), NCHW channels_last.

Counterpart of nsgp_repre_tpu/models/resnet.py in its Faster R-CNN
R-50-FPN form (``out_indices=(0,1,2,3)``, stride in the 3x3 conv).
Module names follow torchvision / mmdet (``layer1.0.conv1``,
``layer1.0.downsample.0``) so reference weights load by name. The JAX
stem's space-to-depth option is an exact rewrite for the TPU; a plain
7x7/2 conv computes the same function.

``frozen_stages`` cuts the gradient after the last frozen stage
(resnet.py:159-160 in JAX): no gradient flows into the stem and the
frozen stages, and the optimizer gives them no entry
(engine/train.py::trainable_mask).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import CovConv, FrozenBatchNorm


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = CovConv(in_channels, mid_channels, 1, bias=False)
        self.bn1 = FrozenBatchNorm(mid_channels)
        self.conv2 = CovConv(mid_channels, mid_channels, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(mid_channels)
        self.conv3 = CovConv(mid_channels, out_channels, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_channels)
        self.downsample = None
        if in_channels != out_channels or stride != 1:
            self.downsample = nn.Sequential(
                CovConv(in_channels, out_channels, 1, stride=stride, bias=False),
                FrozenBatchNorm(out_channels),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class ResNet50(nn.Module):
    """Returns the four stage outputs (C2..C5)."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3), base_channels: int = 64,
                 frozen_stages: int = 1):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.conv1 = CovConv(3, base_channels, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(base_channels)
        in_ch = base_channels
        self.stage_names = []
        for stage, n in enumerate(stage_blocks):
            mid = base_channels * 2 ** stage
            blocks = []
            for b in range(n):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                blocks.append(Bottleneck(in_ch, mid, mid * 4, stride))
                in_ch = mid * 4
            name = f"layer{stage + 1}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outs = []
        for stage, name in enumerate(self.stage_names):
            y = getattr(self, name)(y)
            if stage + 1 == self.frozen_stages:
                y = y.detach()
            outs.append(y)
        return tuple(outs)

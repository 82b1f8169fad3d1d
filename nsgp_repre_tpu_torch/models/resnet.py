"""ResNet-50 backbone family (frozen BN), NCHW channels_last.

Counterpart of nsgp_repre_tpu/models/resnet.py:
- the R-50-FPN trunk (``style='pytorch'``, ``out_indices=(0,1,2,3)``,
  the stride in the 3x3 conv);
- ``style='caffe'``: the stride in each stage's first 1x1 conv
  (resnet.py:47-48 in JAX), with ``strides``, ``dilations``,
  ``out_indices`` and fewer than four stages: the C4 trunk
  (``num_stages=3, strides=(1,2,2), out_indices=(2,)``) and the DC5
  trunk (``strides=(1,2,2,1), dilations=(1,1,1,2), out_indices=(3,)``);
- :class:`ResLayer`, one stage as a module (resnet.py:70-97): the C4
  RoI head's shared res5, ``roi_head.shared_head.layer4.{b}`` in mmdet.

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

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import CovConv, FrozenBatchNorm


class Bottleneck(nn.Module):
    """1x1 → 3x3 → 1x1 with an identity or projection shortcut; 'pytorch'
    style strides the 3x3, 'caffe' style the first 1x1."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int, stride: int = 1,
                 dilation: int = 1, style: str = "pytorch"):
        super().__init__()
        if style not in ("pytorch", "caffe"):
            raise ValueError(f"style {style!r}")
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = CovConv(in_channels, mid_channels, 1, stride=s1, bias=False)
        self.bn1 = FrozenBatchNorm(mid_channels)
        self.conv2 = CovConv(mid_channels, mid_channels, 3, stride=s2, padding=dilation,
                             dilation=dilation, bias=False)
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


def _stage(in_channels: int, stage: int, num_blocks: int, base_channels: int, stride: int,
           dilation: int, style: str) -> nn.Sequential:
    mid = base_channels * 2 ** stage
    return nn.Sequential(*[
        Bottleneck(in_channels if b == 0 else mid * 4, mid, mid * 4, stride if b == 0 else 1,
                   dilation, style)
        for b in range(num_blocks)])


class ResNet50(nn.Module):
    """Returns the outputs of the stages in ``out_indices`` (default: all)."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3), base_channels: int = 64,
                 frozen_stages: int = 1, style: str = "pytorch",
                 strides: Optional[Sequence[int]] = None,
                 dilations: Optional[Sequence[int]] = None,
                 out_indices: Optional[Sequence[int]] = None):
        super().__init__()
        n = len(stage_blocks)
        strides = tuple(strides) if strides else (1,) + (2,) * (n - 1)
        dilations = tuple(dilations) if dilations else (1,) * n
        self.out_indices = tuple(out_indices) if out_indices is not None else tuple(range(n))
        self.frozen_stages = frozen_stages
        self.conv1 = CovConv(3, base_channels, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(base_channels)
        in_ch = base_channels
        self.stage_names = []
        for stage, num_blocks in enumerate(stage_blocks):
            name = f"layer{stage + 1}"
            self.add_module(name, _stage(in_ch, stage, num_blocks, base_channels, strides[stage],
                                         dilations[stage], style))
            self.stage_names.append(name)
            in_ch = base_channels * 2 ** stage * 4

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outs = []
        for stage, name in enumerate(self.stage_names):
            y = getattr(self, name)(y)
            if stage + 1 == self.frozen_stages:
                y = y.detach()
            if stage in self.out_indices:
                outs.append(y)
        return tuple(outs)


class ResLayer(nn.Module):
    """One ResNet stage as a module (the C4 RoI head's shared res5): (R,
    1024, 14, 14) RoI features → (R, 2048, 7, 7). The stage is
    ``layer{stage + 1}``, as mmdet's ResLayer shared head names it."""

    def __init__(self, stage: int = 3, num_blocks: int = 3, base_channels: int = 64,
                 stride: int = 2, dilation: int = 1, style: str = "caffe"):
        super().__init__()
        self.stage_name = f"layer{stage + 1}"
        in_ch = base_channels * 2 ** (stage - 1) * 4
        self.add_module(self.stage_name, _stage(in_ch, stage, num_blocks, base_channels, stride,
                                                dilation, style))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.stage_name)(x)

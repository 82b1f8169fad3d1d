"""Feature Pyramid Network, Faster R-CNN form.

Counterpart of nsgp_repre_tpu/models/fpn.py with
``in_channels=[256,512,1024,2048], out_channels=256, num_outs=5``:
lateral 1x1 convs, nearest 2x top-down pathway cropped to the lateral's
size (fpn.py:24-29), 3x3 output convs and P6 = max_pool(k=1, s=2) of P5
(fpn.py:74). The RetinaNet variants (extra convs) are not ported yet.
Module names follow mmdet (``lateral_convs.0.conv``, ``fpn_convs.0.conv``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import CovConv


class ConvModule(nn.Module):
    """mmcv ConvModule without norm/activation: only ``.conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int = 0):
        super().__init__()
        self.conv = CovConv(in_channels, out_channels, kernel_size, padding=padding)

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        return self.conv(x, fused=fused)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, padding=1) for _ in in_channels])

    def forward(self, inputs: Sequence[torch.Tensor], fused: bool = False) -> Tuple[torch.Tensor, ...]:
        """``fused=True`` runs the 3x3 output convs through the conv3x3
        kernel (inference only); laterals stay library convs."""
        laterals = [m(x) for m, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            th, tw = laterals[i - 1].shape[2:]
            up = F.interpolate(laterals[i], scale_factor=2, mode="nearest")[:, :, :th, :tw]
            laterals[i - 1] = laterals[i - 1] + up
        outs = [m(x, fused=fused) for m, x in zip(self.fpn_convs, laterals)]
        for _ in range(self.num_outs - len(outs)):
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)

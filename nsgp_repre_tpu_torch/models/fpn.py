"""Feature Pyramid Network.

Counterpart of nsgp_repre_tpu/models/fpn.py:
- Faster/Mask/Cascade R-CNN: ``in_channels=[256,512,1024,2048],
  out_channels=256, num_outs=5``: lateral 1x1 convs, nearest 2x top-down
  pathway cropped to the lateral's size (fpn.py:24-29), 3x3 output convs
  and P6 = max_pool(k=1, s=2) of P5 (fpn.py:74);
- RetinaNet: ``start_level=1, add_extra_convs='on_input'``: the extra
  levels are stride-2 3x3 convs, the first on the last backbone map
  ('on_input') or on the last output ('on_output'), each later one on the
  previous extra level (ReLU'd first with ``relu_before_extra_convs``),
  fpn.py:76-90.

Module names follow mmdet (``lateral_convs.0.conv``, ``fpn_convs.0.conv``;
the extra convs are ``fpn_convs.{num_ins + j}``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import CovConv


class ConvModule(nn.Module):
    """mmcv ConvModule without norm/activation: only ``.conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int = 0,
                 stride: int = 1):
        super().__init__()
        self.conv = CovConv(in_channels, out_channels, kernel_size, stride=stride, padding=padding)

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        return self.conv(x, fused=fused)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5, start_level: int = 0,
                 add_extra_convs: Optional[str] = None, relu_before_extra_convs: bool = False):
        super().__init__()
        if add_extra_convs not in (None, "on_input", "on_output"):
            raise ValueError(f"add_extra_convs {add_extra_convs!r}")
        ins = list(in_channels[start_level:])
        self.num_outs = num_outs
        self.start_level = start_level
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        self.lateral_convs = nn.ModuleList([ConvModule(c, out_channels, 1) for c in ins])
        convs = [ConvModule(out_channels, out_channels, 3, padding=1) for _ in ins]
        if add_extra_convs is not None:
            for j in range(num_outs - len(ins)):
                src = ins[-1] if j == 0 and add_extra_convs == "on_input" else out_channels
                convs.append(ConvModule(src, out_channels, 3, padding=1, stride=2))
        self.fpn_convs = nn.ModuleList(convs)

    def forward(self, inputs: Sequence[torch.Tensor], fused: bool = False) -> Tuple[torch.Tensor, ...]:
        """``fused=True`` runs the stride-1 3x3 output convs through the
        conv3x3 kernel (inference only); laterals and extra convs stay
        library convs."""
        inputs = list(inputs[self.start_level:])
        n = len(inputs)
        laterals = [m(x) for m, x in zip(self.lateral_convs, inputs)]
        for i in range(n - 1, 0, -1):
            th, tw = laterals[i - 1].shape[2:]
            up = F.interpolate(laterals[i], scale_factor=2, mode="nearest")[:, :, :th, :tw]
            laterals[i - 1] = laterals[i - 1] + up
        outs = [m(x, fused=fused) for m, x in zip(self.fpn_convs[:n], laterals)]
        for j in range(self.num_outs - n):
            if self.add_extra_convs is None:
                outs.append(outs[-1][:, :, ::2, ::2])
                continue
            src = inputs[-1] if self.add_extra_convs == "on_input" else outs[-1]
            if j > 0:
                src = torch.relu(outs[-1]) if self.relu_before_extra_convs else outs[-1]
            outs.append(self.fpn_convs[n + j](src))
        return tuple(outs)

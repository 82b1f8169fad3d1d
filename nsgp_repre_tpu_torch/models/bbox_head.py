"""Task-split Shared2FC bbox head.

Counterpart of nsgp_repre_tpu/models/bbox_head.py (mmdet
``Shared2FCBBoxHeadTask``): two shared FCs 7*7*256 → 1024 → 1024 with
ReLU, one cls Linear per task slice plus a background one LAST
(``fc_cls.{T}``), one reg Linear per task. Future tasks (i + 1 >
task_id) get cls logits -1e10 (not -inf, bbox_head.py:32,113-114) and
zero regs. ``shared_fcs.0`` keeps torch's (C, H, W) input order; NHWC
RoI features are fed by permuting its weight columns (bbox_head.py:73-82).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from .layers import CovDense

NEG_INF_SCORE = -1.0e10


class Shared2FCBBoxHeadTask(nn.Module):
    def __init__(self, task_split: Sequence[int] = (0, 10, 20), task_id: int = 1,
                 num_classes: int = 20, in_channels: int = 256, roi_feat_size: int = 7,
                 fc_out_channels: int = 1024):
        super().__init__()
        self.task_split = tuple(task_split)
        self.task_id = task_id
        self.num_classes = num_classes
        n_tasks = len(self.task_split) - 1
        sizes = [self.task_split[i + 1] - self.task_split[i] for i in range(n_tasks)]
        self.shared_fcs = nn.ModuleList([
            CovDense(in_channels * roi_feat_size ** 2, fc_out_channels),
            CovDense(fc_out_channels, fc_out_channels),
        ])
        self.fc_cls = nn.ModuleList(
            [CovDense(fc_out_channels, n) for n in sizes] + [CovDense(fc_out_channels, 1)])
        self.fc_reg = nn.ModuleList([CovDense(fc_out_channels, 4 * n) for n in sizes])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, 7, 7, C) NHWC RoI features, or (R, C*7*7) in torch order →
        (cls_score (R, num_classes + 1), bbox_pred (R, 4 * num_classes))."""
        if x.dim() == 4:
            r, h, w, c = x.shape
            x = self.shared_fcs[0](x.reshape(r, -1), row_chw=(c, h, w))
        else:
            x = self.shared_fcs[0](x)
        x = torch.relu(self.shared_fcs[1](torch.relu(x)))
        n_tasks = len(self.fc_reg)
        cls_parts = []
        for i in range(n_tasks):
            o = self.fc_cls[i](x)
            if i + 1 > self.task_id:
                o = torch.full_like(o, NEG_INF_SCORE)
            cls_parts.append(o)
        cls_parts.append(self.fc_cls[n_tasks](x))
        reg_parts = []
        for i in range(n_tasks):
            o = self.fc_reg[i](x)
            if i + 1 > self.task_id:
                o = torch.zeros_like(o)
            reg_parts.append(o)
        return torch.cat(cls_parts, dim=-1), torch.cat(reg_parts, dim=-1)

"""Task-split Shared2FC bbox head.

Counterpart of nsgp_repre_tpu/models/bbox_head.py (mmdet
``Shared2FCBBoxHeadTask``): two shared FCs 7*7*256 → 1024 → 1024 with
ReLU, one cls Linear per task slice plus a background one LAST
(``fc_cls.{T}``), one reg Linear per task. Future tasks (i + 1 >
task_id) get cls logits -1e10 (not -inf, bbox_head.py:32,113-114) and
zero regs. ``reg_class_agnostic`` (the cascade's stage heads,
bbox_head.py:40,61,107-126) replaces the per-task regressors by one
4-output ``fc_reg.0`` that no task mask touches. ``shared_fcs.0`` keeps
torch's (C, H, W) input order; NHWC RoI features are fed by permuting
its weight columns (bbox_head.py:84-105), except while a CovCollector
taps the layers, when they are transposed to torch order first
(:mid_features), as in JAX.
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
                 fc_out_channels: int = 1024, reg_class_agnostic: bool = False):
        super().__init__()
        self.task_split = tuple(task_split)
        self.task_id = task_id
        self.num_classes = num_classes
        self.reg_class_agnostic = reg_class_agnostic
        n_tasks = len(self.task_split) - 1
        sizes = [self.task_split[i + 1] - self.task_split[i] for i in range(n_tasks)]
        self.shared_fcs = nn.ModuleList([
            CovDense(in_channels * roi_feat_size ** 2, fc_out_channels),
            CovDense(fc_out_channels, fc_out_channels),
        ])
        self.fc_cls = nn.ModuleList(
            [CovDense(fc_out_channels, n) for n in sizes] + [CovDense(fc_out_channels, 1)])
        reg_sizes = [4] if reg_class_agnostic else [4 * n for n in sizes]
        self.fc_reg = nn.ModuleList([CovDense(fc_out_channels, n) for n in reg_sizes])

    @staticmethod
    def mid_features(x: torch.Tensor) -> torch.Tensor:
        """Flattened pre-FC RoI features (R, C*7*7) in torch's (C, H, W)
        order (bbox_head.py:73-82), the layout of stored RoI features and
        prototypes; (R, 7, 7, C) NHWC inputs are transposed."""
        if x.dim() > 2:
            x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, 7, 7, C) NHWC RoI features, or (R, C*7*7) in torch order →
        (cls_score (R, num_classes + 1), bbox_pred (R, 4 * num_classes), or
        (R, 4) class-agnostic)."""
        if x.dim() == 4 and self.shared_fcs[0].cov_tap is None:
            r, h, w, c = x.shape
            x = self.shared_fcs[0](x.reshape(r, -1), row_chw=(c, h, w))
        else:
            x = self.shared_fcs[0](self.mid_features(x))
        x = torch.relu(self.shared_fcs[1](torch.relu(x)))
        n_tasks = len(self.fc_cls) - 1
        cls_parts = []
        for i in range(n_tasks):
            o = self.fc_cls[i](x)
            if i + 1 > self.task_id:
                o = torch.full_like(o, NEG_INF_SCORE)
            cls_parts.append(o)
        cls_parts.append(self.fc_cls[n_tasks](x))
        reg_parts = []
        for i, fc in enumerate(self.fc_reg):
            o = fc(x)
            if i + 1 > self.task_id and not self.reg_class_agnostic:
                o = torch.zeros_like(o)
            reg_parts.append(o)
        return torch.cat(cls_parts, dim=-1), torch.cat(reg_parts, dim=-1)

"""Teacher pseudo-label merging, batched over images with static shapes.

Counterpart of nsgp_repre_tpu/engine/pseudo.py (reference
faster_rcnn_roi_replay.py:65-109): the previous task's teacher predicts
in canvas coordinates, and each of its detections is
- skipped when its largest IoU with a real gt box exceeds ``iou_skip``;
- appended to the RPN gt set when its score exceeds ``rpn_thresh``;
- appended to the RoI gt set when its score exceeds ``roi_thresh``.

The padded gt slots come first and the teacher's detections after them,
so both sets have capacity gt + dets; a detection that is not kept gets
box 0, label -1 and valid False.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..structures.boxes import bbox_overlaps
from ..structures.sample import InstanceArray


def merge_pseudo_labels(
    gt: InstanceArray,
    teacher_dets: InstanceArray,
    rpn_thresh: float = 0.5,
    roi_thresh: float = 0.7,
    iou_skip: float = 0.7,
) -> Tuple[InstanceArray, InstanceArray]:
    """(rpn_gt, roi_gt) of capacity ``gt.capacity + teacher_dets.capacity``,
    on the detections' device."""
    dev = teacher_dets.boxes.device
    gt = gt.to(dev)
    d_boxes = teacher_dets.boxes.float()
    iou = bbox_overlaps(d_boxes, gt.boxes.float())  # (B, D, G)
    iou = torch.where(gt.valid[:, None, :], iou, 0.0)
    base = teacher_dets.valid & (iou.max(dim=2).values <= iou_skip)
    scores = teacher_dets.scores
    d_labels = teacher_dets.labels.to(gt.labels.dtype)

    def cat(keep):
        return InstanceArray(
            boxes=torch.cat([gt.boxes, torch.where(keep[..., None], d_boxes, 0.0)], dim=1),
            labels=torch.cat([gt.labels, torch.where(keep, d_labels, -1)], dim=1),
            valid=torch.cat([gt.valid, keep], dim=1),
        )

    return cat(base & (scores > rpn_thresh)), cat(base & (scores > roi_thresh))

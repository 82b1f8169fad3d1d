"""Fixed-capacity detection samples as dataclasses of tensors.

Counterpart of nsgp_repre_tpu/structures/sample.py: per-image instance
sets keep a padded capacity plus a validity mask, so port and JAX
results compare array to array.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class InstanceArray:
    """boxes (..., K, 4); labels (..., K) int32 (-1 padded); valid (..., K)
    bool; scores (..., K) float (predictions only); masks, optional: for
    gts (..., K, S, S) box-normalized crops (each gt's mask resampled over
    its own box, structures/mask_paste.py::normalize_gt_masks), for
    predictions (..., K, 28, 28) mask-head probabilities."""

    boxes: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor
    scores: Optional[torch.Tensor] = None
    masks: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.boxes.shape[-2]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)

    def to(self, device) -> "InstanceArray":
        return InstanceArray(*(None if t is None else t.to(device)
                               for t in (self.boxes, self.labels, self.valid, self.scores,
                                         self.masks)))

    def replace(self, **kw) -> "InstanceArray":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class DetBatch:
    """images (B, H, W, 3) NHWC (uint8 or normalized float, padded to one
    canvas); img_shape (B, 2) int32 (h, w) of the resized content;
    ori_shape (B, 2) int32; scale_factor (B, 2) float (w_scale, h_scale);
    gt: padded ground truth."""

    images: torch.Tensor
    img_shape: torch.Tensor
    ori_shape: torch.Tensor
    scale_factor: torch.Tensor
    gt: InstanceArray

    @property
    def batch_size(self) -> int:
        return self.images.shape[0]

    def replace(self, **kw) -> "DetBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "DetBatch":
        return DetBatch(self.images.to(device), self.img_shape.to(device),
                        self.ori_shape.to(device), self.scale_factor.to(device),
                        self.gt.to(device))


def pad_instances(boxes: np.ndarray, labels: np.ndarray, capacity: int,
                  scores: Optional[np.ndarray] = None) -> InstanceArray:
    """Pad one image's numpy annotations to a fixed capacity."""
    n = min(len(boxes), capacity)
    out_boxes = np.zeros((capacity, 4), dtype=np.float32)
    out_labels = np.full((capacity,), -1, dtype=np.int32)
    out_valid = np.zeros((capacity,), dtype=bool)
    out_boxes[:n] = np.asarray(boxes, dtype=np.float32)[:n]
    out_labels[:n] = np.asarray(labels, dtype=np.int32)[:n]
    out_valid[:n] = True
    out_scores = None
    if scores is not None:
        out_scores = np.zeros((capacity,), dtype=np.float32)
        out_scores[:n] = np.asarray(scores, dtype=np.float32)[:n]
    return InstanceArray(
        boxes=torch.from_numpy(out_boxes),
        labels=torch.from_numpy(out_labels),
        valid=torch.from_numpy(out_valid),
        scores=None if out_scores is None else torch.from_numpy(out_scores),
    )

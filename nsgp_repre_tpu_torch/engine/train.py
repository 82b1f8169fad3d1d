"""Predict step and on-device image normalization.

Counterpart of nsgp_repre_tpu/engine/train.py: ``normalize_images`` and
``make_eval_step``. The training steps wait for slice (b) (ROADMAP.md,
queue 1).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.detector import FasterRCNN
from ..structures.sample import DetBatch, InstanceArray

# ImageNet mean/std, RGB (DetDataPreprocessor cfg in
# cl_faster_rcnn_cfgs/_base_/models/faster-rcnn_r50_fpn.py)
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (B,H,W,3) → normalized float32, on the images' device."""
    mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=images.device)
    return (images.to(torch.float32) - mean) / std


def make_eval_step(model: FasterRCNN) -> Callable[[DetBatch], InstanceArray]:
    """Predict step: a batch of uint8 images → padded detections."""

    def eval_fn(batch: DetBatch) -> InstanceArray:
        return model.predict(batch.replace(images=normalize_images(batch.images)))

    return eval_fn

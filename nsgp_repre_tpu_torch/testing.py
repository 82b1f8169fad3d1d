"""Synthetic-input factories for tests and the card check.

Counterpart of nsgp_repre_tpu/testing.py: :func:`demo_det_batch` (random
uint8 images and random padded ground truth from one numpy seed, so the
same seed gives the same numbers as the JAX factory) and
:func:`tiny_detector_config` (a shrunken detector for fast CPU runs).
:func:`split_loss_and_grads` runs the task-1 loss in the two parts
where two devices can part ways, so that a card run can be held against
a CPU run of the same weights.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .engine.train import normalize_images, total_loss
from .models.detector import DetectorConfig, FasterRCNN
from .structures.sample import DetBatch, InstanceArray


def demo_det_batch(
    batch_size: int = 1,
    height: int = 64,
    width: int = 64,
    num_instances: Sequence[int] = (2,),
    num_classes: int = 4,
    gt_capacity: int = 8,
    seed: int = 0,
    device: Union[str, torch.device] = "cpu",
) -> DetBatch:
    """Random padded detection batch on ``device`` (demo_mm_inputs analogue)."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (batch_size, height, width, 3), np.uint8)
    boxes = np.zeros((batch_size, gt_capacity, 4), np.float32)
    labels = np.full((batch_size, gt_capacity), -1, np.int32)
    valid = np.zeros((batch_size, gt_capacity), bool)
    for b in range(batch_size):
        n = num_instances[b % len(num_instances)]
        n = min(n, gt_capacity)
        cx = rng.uniform(0.2, 0.8, n) * width
        cy = rng.uniform(0.2, 0.8, n) * height
        bw = rng.uniform(0.2, 0.5, n) * width
        bh = rng.uniform(0.2, 0.5, n) * height
        boxes[b, :n, 0] = np.clip(cx - bw / 2, 0, width)
        boxes[b, :n, 1] = np.clip(cy - bh / 2, 0, height)
        boxes[b, :n, 2] = np.clip(cx + bw / 2, 0, width)
        boxes[b, :n, 3] = np.clip(cy + bh / 2, 0, height)
        labels[b, :n] = rng.randint(0, num_classes, n)
        valid[b, :n] = True
    shape = np.tile(np.array([[height, width]], np.int32), (batch_size, 1))
    t = lambda a: torch.from_numpy(a).to(device)
    return DetBatch(
        images=t(images),
        img_shape=t(shape),
        ori_shape=t(shape.copy()),
        scale_factor=t(np.ones((batch_size, 2), np.float32)),
        gt=InstanceArray(boxes=t(boxes), labels=t(labels), valid=t(valid)),
    )


def tiny_detector_config(**overrides) -> DetectorConfig:
    """A shrunken detector config for fast CPU tests (R50→1-block stages,
    small NMS/sampling budgets — the reference's config-shrinking idiom)."""
    base = dict(
        num_classes=4,
        task_split=(0, 2, 4),
        task_id=1,
        backbone_blocks=(1, 1, 1, 1),
        rpn_nms_pre=64,
        rpn_max_per_img=32,
        rpn_num=16,
        rcnn_num=16,
        max_per_img=8,
    )
    base.update(overrides)
    return DetectorConfig(**base)


def split_loss_and_grads(
    model: FasterRCNN,
    batch: DetBatch,
    priorities: Dict[str, torch.Tensor],
    proposals: Optional[InstanceArray] = None,
) -> Tuple[Dict[str, float], Dict[str, torch.Tensor], InstanceArray]:
    """``FasterRCNN.loss`` and its backward, cut between the RPN and the
    RoI head: the RPN losses and proposals, then the RoI losses on
    ``proposals`` when given (another device's), else on this run's own.
    Near-ties in the proposal top-k and NMS can swap a few proposals
    between devices; feeding one run's proposals to the other keeps the
    comparison to the arithmetic. Returns the loss terms, the gradient
    of every parameter that got one (on the CPU) and the proposals."""
    dev = next(model.parameters()).device
    model.zero_grad(set_to_none=True)
    b = batch.to(dev)
    b = b.replace(images=normalize_images(b.images))
    feats = model.extract_feat(b.images)
    rpn, props = model.rpn_loss_and_proposals(feats, b.gt, b.img_shape, with_loss=True,
                                              u=priorities["rpn"])
    if proposals is not None:
        props = proposals.to(dev)
    roi = model.roi_loss(feats, props, b.gt, u=priorities["roi"], u2=priorities["roi2"])
    losses = {**rpn, **roi}
    total_loss(losses).backward()
    grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v.detach()) for k, v in losses.items()}, grads, props

"""Train and predict steps, schedules, on-device image normalization.

Counterpart of nsgp_repre_tpu/engine/train.py: ``normalize_images``,
``make_lr_schedule``, ``trainable_mask``, ``total_loss``, ``TrainState``,
``make_train_step`` (the task-1 step: detector loss, backward, NSCL
update) and ``make_eval_step``. The task-2 terms of the step (teacher
pseudo-labels, RePRE replay, EWC) are slice (c) (ROADMAP.md, queue 1):
a state that carries them raises.

PyTorch runs eagerly: a step is the forward, ``backward()`` and the
optimizer's in-place update, with no compiled program around it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.detector import NOT_PORTED, DetectorConfig, FasterRCNN
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


def make_lr_schedule(
    base_lr: float,
    steps_per_epoch: int,
    max_epochs: int = 30,
    milestones=(8, 11),
    gamma: float = 0.1,
    warmup_iters: int = 500,
    warmup_start_factor: float = 0.001,
) -> Callable[[int], np.float32]:
    """LinearLR warm-up + MultiStepLR decay (schedule_1x_sgdnscl.py), a
    function of the number of updates taken, in float32 with the JAX
    schedule's operation order."""
    f32 = np.float32

    def schedule(step: int) -> np.float32:
        s = f32(step)
        ramp = min(s / f32(max(warmup_iters, 1)), f32(1.0))
        warm = f32(warmup_start_factor) + f32(1.0 - warmup_start_factor) * ramp
        epoch = s // f32(max(steps_per_epoch, 1))
        decay = f32(1.0)
        for m in milestones:
            decay = decay * (f32(gamma) if epoch >= m else f32(1.0))
        return f32(f32(base_lr) * warm) * decay

    return schedule


def trainable_mask(model: FasterRCNN, config: DetectorConfig) -> Dict[str, bool]:
    """Parameter name → trainable: the stem and the first
    ``frozen_stages`` stages are frozen (mmdet resnet.py: -1 = nothing,
    0 = stem only, k >= 1 = stem + layers 1..k), and so are the future
    tasks' cls/reg heads (convfc_bbox_head_task.py:129-144)."""
    fs = config.frozen_stages
    frozen = []
    if fs >= 0:
        frozen += ["backbone.conv1.", "backbone.bn1."]
    frozen += [f"backbone.layer{s}." for s in range(1, fs + 1)]
    for i in range(len(config.task_split) - 1):
        if i + 1 > config.task_id:
            frozen += [f"roi_head.bbox_head.fc_cls.{i}.", f"roi_head.bbox_head.fc_reg.{i}."]
    return {name: not any(name.startswith(f) for f in frozen)
            for name, _ in model.named_parameters()}


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """mmengine parse_losses: sum every entry whose key contains 'loss'."""
    return sum(v for k, v in losses.items() if "loss" in k)


@dataclasses.dataclass
class TrainState:
    """The optimizer (its parameters are the model's trainable ones), the
    step count and the task-2 constants of slice (c), which stay None."""

    optimizer: torch.optim.Optimizer
    step: int = 0
    teacher_params: Optional[Any] = None
    replay_feats: Optional[torch.Tensor] = None
    replay_labels: Optional[torch.Tensor] = None
    ewc_terms: Optional[Any] = None


def make_train_step(model: FasterRCNN, optimizer: torch.optim.Optimizer,
                    clip_grad_norm: Optional[float] = None):
    """Build the task-1 train step: ``step(state, batch, generator=None,
    priorities=None) → (state, metrics)``.

    ``batch.images`` are uint8 (normalized here). The sampling priorities
    come from ``generator`` or ``priorities`` (FasterRCNN.loss).
    ``clip_grad_norm`` mirrors mmengine OptimWrapper's ``clip_grad``
    (global-norm clipping before the update). The state is updated in
    place (the parameters and the optimizer's buffers) and returned;
    ``metrics`` holds the total loss and every loss term, detached.
    """
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(state: TrainState, batch: DetBatch, generator: Optional[torch.Generator] = None,
             priorities: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.optimizer is not optimizer:
            raise ValueError("the state holds another optimizer than this step's")
        for field in ("teacher_params", "replay_feats", "replay_labels", "ewc_terms"):
            if getattr(state, field) is not None:
                raise NotImplementedError(NOT_PORTED.format(
                    f"TrainState.{field} (teacher, replay, EWC)", "slice (c), task-2 terms"))
        batch = batch.replace(images=normalize_images(batch.images))
        optimizer.zero_grad(set_to_none=True)
        losses = model.loss(batch, generator=generator, priorities=priorities)
        loss = total_loss(losses)
        loss.backward()
        if clip_grad_norm is not None:
            grads = [p.grad for p in params if p.grad is not None]
            gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            scale = torch.clamp(clip_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            for g in grads:
                g.mul_(scale)
        optimizer.step()
        state.step += 1
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in losses.items()}}
        return state, metrics

    return step


def make_eval_step(model: FasterRCNN) -> Callable[[DetBatch], InstanceArray]:
    """Predict step: a batch of uint8 images → padded detections."""

    def eval_fn(batch: DetBatch) -> InstanceArray:
        return model.predict(batch.replace(images=normalize_images(batch.images)))

    return eval_fn

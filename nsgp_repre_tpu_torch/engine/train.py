"""Train, predict and task-end steps, schedules, on-device image normalization.

Counterpart of nsgp_repre_tpu/engine/train.py: ``normalize_images``,
``make_lr_schedule``, ``trainable_mask``, ``total_loss``, ``TrainState``,
``make_train_step`` (detector loss with the task-2 terms: teacher
pseudo-labels, RePRE replay, EWC; backward; NSCL update),
``make_teacher_step``, ``make_eval_step`` and the task-end passes
``make_cov_step`` (NSGP input covariances), ``make_roi_extract_step``
(the RePRE RoI store) and ``make_importance_step`` (EWC importance).

PyTorch runs eagerly: a step is the forward, ``backward()`` and the
optimizer's in-place update, with no compiled program around it. The
JAX steps' random keys become the draws they produce: ``priorities``
(the samplers' uniform draws, the raw replay's row choice, the RoI
store's ranking) are passed in or drawn from a ``torch.Generator``.
Under a running profiler the train step marks its layers with the
ranges of utils/spans.py: ``train_step`` around the whole step, and
``ewc``, ``backward`` and ``optimizer`` (the gradient all-reduce, the
clip and the update) inside it.

Under data parallel (parallel/mesh.py) each rank holds its rows of the
global batch, and the steps compute what JAX's compute on its mesh:
a per-batch loss term is a rank's sum over the GLOBAL normalizer
(models/detector.py), so a rank backpropagates W times its share of
the per-batch terms plus the batch-free ones (:data:`BATCH_FREE_TERMS`,
equal on every rank), and the ranks' gradients are averaged before the
clip and the update; the metrics are the global terms.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.detector import DetectorConfig, FasterRCNN
from ..models.layers import CovCollector
from ..parallel.mesh import (all_reduce_mean_, all_reduce_sum, check_same_rows, is_distributed,
                             world_size)
from ..structures.sample import DetBatch, InstanceArray
from ..utils.spans import span
from .ewc import ewc_loss
from .pseudo import merge_pseudo_labels

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
    tasks' cls/reg heads (convfc_bbox_head_task.py:129-144). A config
    without ``frozen_stages`` (SSD's VGG) freezes nothing, one without
    ``task_split`` (RetinaNet, SSD) has no task heads."""
    fs = getattr(config, "frozen_stages", -1)
    frozen = []
    if fs >= 0:
        frozen += ["backbone.conv1.", "backbone.bn1."]
    frozen += [f"backbone.layer{s}." for s in range(1, fs + 1)]
    for i in range(len(getattr(config, "task_split", (0,))) - 1):
        if i + 1 > config.task_id:
            frozen += [f"roi_head.bbox_head.fc_cls.{i}.", f"roi_head.bbox_head.fc_reg.{i}."]
    return {name: not any(name.startswith(f) for f in frozen)
            for name, _ in model.named_parameters()}


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """mmengine parse_losses: sum every entry whose key contains 'loss'."""
    return sum(v for k, v in losses.items() if "loss" in k)


# loss terms that do not read the batch: equal on every rank, counted once
BATCH_FREE_TERMS = ("replay_loss_cls", "ewc_loss")


def rank_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The loss a data-parallel rank backpropagates: W times its share of
    every per-batch term, plus the batch-free terms once. The mean of the
    ranks' gradients is then the gradient of the global loss. At one rank
    it is :func:`total_loss` itself."""
    W = world_size()
    if W == 1:
        return total_loss(losses)
    return sum(v if k in BATCH_FREE_TERMS else W * v for k, v in losses.items() if "loss" in k)


def global_terms(losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The global batch's terms, detached: every per-batch term summed over
    the ranks (one all-reduce), the batch-free ones as they are."""
    if not is_distributed():
        return {k: v.detach() for k, v in losses.items()}
    keys = [k for k in losses if k not in BATCH_FREE_TERMS]
    summed = all_reduce_sum(torch.stack([losses[k].detach() for k in keys]))
    out = {k: v.detach() for k, v in losses.items()}
    out.update({k: summed[i] for i, k in enumerate(keys)})
    return out


@dataclasses.dataclass
class TrainState:
    """The optimizer (its parameters are the model's trainable ones), the
    step count and the task's constants: ``teacher_params``, the frozen
    teacher's weights (``dict(teacher.named_parameters())`` of the model
    given to the step as ``teacher_model``; the teacher runs only when
    this is set, as in JAX), the RePRE prototypes (or, in raw mode, the
    whole stored feature buffer) with their labels, and the EWC terms
    (engine/ewc.py)."""

    optimizer: torch.optim.Optimizer
    step: int = 0
    teacher_params: Optional[Any] = None
    replay_feats: Optional[torch.Tensor] = None
    replay_labels: Optional[torch.Tensor] = None
    ewc_terms: Optional[Any] = None


RAW_REPLAY_ROWS = 64  # stored features distilled per step (standard_roi_replay_head.py:56-66)


def _raw_replay_inputs(teacher_model: FasterRCNN, state: TrainState,
                       sel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw-feature replay (StandardRoIReplayHead.loss): the stored RoI
    features of rows ``sel`` (at most ``RAW_REPLAY_ROWS``, distinct; JAX
    draws them with ``jax.random.choice``) and the frozen teacher's cls
    logits on them. Returns (feats, teacher_cls)."""
    feats = state.replay_feats[sel.to(state.replay_feats.device).long()]
    with torch.no_grad():
        t_cls, _ = teacher_model.bbox_forward(feats)
    return feats, t_cls


def task_losses(model: FasterRCNN, state: TrainState, batch: DetBatch,
                teacher_model: Optional[FasterRCNN] = None, generator=None,
                priorities: Optional[Dict[str, torch.Tensor]] = None,
                teacher_dets: Optional[InstanceArray] = None) -> Dict[str, torch.Tensor]:
    """The loss terms of one train step on a normalized batch
    (train.py:172-225 in JAX): the teacher's detections (``teacher_dets``,
    else a predict of ``teacher_model`` when ``state.teacher_params`` is
    set) merged into the RPN and RoI gt sets, the detector loss with
    prototype replay, or in raw mode the MSE against the teacher on
    ``priorities["replay_rows"]`` of the stored features, and ``ewc_loss``
    when ``state.ewc_terms`` is set. Draws missing from ``priorities``
    come from ``generator``: the replay rows first, as JAX splits its key
    for them before the loss."""
    p = priorities or {}
    rpn_gt = roi_gt = None
    if teacher_dets is not None or (teacher_model is not None and state.teacher_params is not None):
        if teacher_dets is None:
            teacher_dets = teacher_model.predict(batch, rescale=False)
        rpn_gt, roi_gt = merge_pseudo_labels(
            batch.gt, teacher_dets, rpn_thresh=model.config.rpn_thresh,
            roi_thresh=model.config.roi_thresh, iou_skip=model.config.pseudo_iou_skip)

    raw = (model.config.replay_mode == "raw" and state.replay_feats is not None
           and state.teacher_params is not None and teacher_model is not None)
    if raw:
        sel = p.get("replay_rows")
        if sel is None:
            if generator is None:
                raise ValueError("raw replay needs a torch.Generator or priorities['replay_rows']")
            n = state.replay_feats.shape[0]
            sel = torch.randperm(n, generator=generator, device=generator.device)[:RAW_REPLAY_ROWS]
        raw_feats, raw_teacher_cls = _raw_replay_inputs(teacher_model, state, sel)
    losses = model.loss(batch, generator=generator, priorities=p, rpn_gt=rpn_gt, roi_gt=roi_gt,
                        replay_feats=None if raw else state.replay_feats,
                        replay_labels=None if raw else state.replay_labels)
    if raw:
        losses["replay_loss_cls"] = model.raw_replay_loss(raw_feats, raw_teacher_cls)
    if state.ewc_terms:
        with span("ewc"):
            losses["ewc_loss"] = ewc_loss(dict(model.named_parameters()), state.ewc_terms)
    return losses


def make_teacher_step(teacher_model: FasterRCNN) -> Callable[[DetBatch], InstanceArray]:
    """The frozen teacher's predict: a batch of uint8 images → padded
    detections in CANVAS coordinates (``rescale=False``), the input the
    train step's ``teacher_dets`` takes. The teacher is deterministic per
    image, so a runner may compute these once and feed them back
    (train.py:132-150 in JAX)."""

    def fn(batch: DetBatch) -> InstanceArray:
        return teacher_model.predict(batch.replace(images=normalize_images(batch.images)),
                                     rescale=False)

    return fn


def make_train_step(model: FasterRCNN, optimizer: torch.optim.Optimizer,
                    teacher_model: Optional[FasterRCNN] = None,
                    clip_grad_norm: Optional[float] = None):
    """Build the train step: ``step(state, batch, generator=None,
    priorities=None, teacher_dets=None) → (state, metrics)``.

    ``batch.images`` are uint8 (normalized here). The loss is
    :func:`task_losses`: with ``teacher_dets`` (canvas-coordinate
    detections from :func:`make_teacher_step`) the teacher does not run
    in the step. ``clip_grad_norm`` mirrors mmengine OptimWrapper's
    ``clip_grad`` (global-norm clipping before the update). The state is
    updated in place (the parameters and the optimizer's buffers) and
    returned; ``metrics`` holds the total loss and every loss term,
    detached. The gradients are averaged over the data-parallel ranks after
    ``backward()`` (:func:`rank_loss`) and the metrics are the global
    batch's (:func:`global_terms`); with no process group both are the
    one-process step's.
    """
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(state: TrainState, batch: DetBatch, generator: Optional[torch.Generator] = None,
             priorities: Optional[Dict[str, torch.Tensor]] = None,
             teacher_dets: Optional[InstanceArray] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.optimizer is not optimizer:
            raise ValueError("the state holds another optimizer than this step's")
        with span("train_step"):
            batch = batch.replace(images=normalize_images(batch.images))
            optimizer.zero_grad(set_to_none=True)
            losses = task_losses(model, state, batch, teacher_model, generator, priorities,
                                 teacher_dets)
            with span("backward"):
                rank_loss(losses).backward()
            with span("optimizer"):
                all_reduce_mean_([p.grad for p in params if p.grad is not None])
                losses = global_terms(losses)
                loss = total_loss(losses)
                if clip_grad_norm is not None:
                    grads = [p.grad for p in params if p.grad is not None]
                    gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
                    scale = torch.clamp(clip_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
                    for g in grads:
                        g.mul_(scale)
                optimizer.step()
            state.step += 1
            metrics = {"loss": loss, **losses}
        return state, metrics

    return step


def make_eval_step(model: FasterRCNN) -> Callable[[DetBatch], InstanceArray]:
    """Predict step: a batch of uint8 images → padded detections."""

    def eval_fn(batch: DetBatch) -> InstanceArray:
        return model.predict(batch.replace(images=normalize_images(batch.images)))

    return eval_fn


def make_cov_step(model: FasterRCNN):
    """Covariance pass (cal_fea_in, nsrunner:704-763): ``cov_fn(batch,
    generator=None, priorities=None)`` runs the loss forward with no
    teacher and no backward, with every CovConv/CovDense tapped, and
    returns this batch's input covariances keyed by JAX parameter paths
    (``backbone/layer2_0/conv1/kernel``; engine/nsgp.py)."""

    @torch.no_grad()
    def cov_fn(batch: DetBatch, generator: Optional[torch.Generator] = None,
               priorities: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        check_same_rows(batch.images.shape[0], "covariance batch")
        batch = batch.replace(images=normalize_images(batch.images))
        with CovCollector(model) as cov:
            model.loss(batch, generator=generator, priorities=priorities)
        return cov.result()

    return cov_fn


def make_roi_extract_step(model: FasterRCNN, target_count: int = 5):
    """RePRE RoI-feature extraction (cal_rois, nsrunner:776-868):
    ``roi_fn(batch, generator=None, priorities=None)`` →
    FasterRCNN.get_bbox_stuff's outputs."""

    def roi_fn(batch: DetBatch, generator: Optional[torch.Generator] = None,
               priorities: Optional[Dict[str, torch.Tensor]] = None):
        return model.get_bbox_stuff(batch.replace(images=normalize_images(batch.images)),
                                    generator=generator, target_count=target_count,
                                    priorities=priorities)

    return roi_fn


def make_importance_step(model: FasterRCNN, teacher_model: Optional[FasterRCNN] = None):
    """EWC-importance step (calculate_save_importance, nsrunner:946-990):
    ``imp_fn(state, batch, generator=None, priorities=None)`` → the
    gradient of the full train-step loss (:func:`task_losses`, task-2
    terms included, as the reference runs it after training) with respect
    to EVERY parameter, frozen ones too, as JAX's ``jax.grad`` over all
    parameters gives them: a dict name → tensor, zeros where no term
    reaches a parameter, averaged over the ranks under data parallel (the
    global loss's, :func:`rank_loss`). ``requires_grad`` is switched on for
    the step and restored after it."""

    def imp_fn(state: TrainState, batch: DetBatch, generator: Optional[torch.Generator] = None,
               priorities: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        batch = batch.replace(images=normalize_images(batch.images))
        named = list(model.named_parameters())
        flags = [p.requires_grad for _, p in named]
        try:
            for _, p in named:
                p.requires_grad_(True)
            losses = task_losses(model, state, batch, teacher_model, generator, priorities)
            grads = torch.autograd.grad(rank_loss(losses), [p for _, p in named], allow_unused=True)
        finally:
            for (_, p), f in zip(named, flags):
                p.requires_grad_(f)
        out = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, grads)}
        all_reduce_mean_(list(out.values()))
        return out

    return imp_fn

"""Detection losses with mmdet weight/avg_factor semantics.

Counterpart of nsgp_repre_tpu/models/losses.py: ``weighted_sigmoid_bce``,
``weighted_softmax_ce``, ``weighted_l1``, ``weighted_sigmoid_focal``
(RetinaNet), ``weighted_smooth_l1`` and ``accuracy`` (mmdet
cross_entropy_loss.py:202, focal_loss.py, smooth_l1_loss.py:14,118):
elementwise loss times weight, summed and divided by ``avg_factor``.
"""
from __future__ import annotations

import torch

from ..parallel.mesh import all_reduce_sum


def _avg(avg_factor) -> torch.Tensor:
    return torch.clamp(torch.as_tensor(avg_factor, dtype=torch.float32), min=1.0)


def global_avg_factor(count: torch.Tensor) -> torch.Tensor:
    """A loss normalizer over the whole batch: ``count`` (this rank's
    samples, a 0-d tensor) summed over the data-parallel ranks
    (parallel/mesh.py), in f32, at least 1. Each rank's term is then its
    share of the global batch's loss, as JAX computes it on its mesh."""
    return torch.clamp(all_reduce_sum(count.float()), min=1.0)


def weighted_sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                         avg_factor) -> torch.Tensor:
    """Binary CE with logits (RPN objectness)."""
    t = targets.to(logits.dtype)
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    relu = torch.maximum(logits, torch.zeros_like(logits))
    loss = relu - logits * t + torch.log1p(torch.exp(-torch.abs(logits)))
    return (loss * weights).sum() / _avg(avg_factor)


def weighted_softmax_ce(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                        avg_factor) -> torch.Tensor:
    """Softmax CE over the last dim; labels are int indices."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    return (-ll * weights).sum() / _avg(avg_factor)


def weighted_l1(pred: torch.Tensor, target: torch.Tensor, weights: torch.Tensor,
                avg_factor) -> torch.Tensor:
    loss = torch.abs(pred - target)
    return (loss * weights).sum() / _avg(avg_factor)


def weighted_sigmoid_focal(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                           avg_factor, num_classes: int, gamma: float = 2.0,
                           alpha: float = 0.25) -> torch.Tensor:
    """Sigmoid focal loss (mmdet FocalLoss, use_sigmoid=True; losses.py:49
    in JAX): one-vs-all sigmoids over ``num_classes`` columns of logits
    (..., num_classes); ``labels == num_classes`` is background (an
    all-zero target row); ``weights`` (...) weigh the rows."""
    classes = torch.arange(num_classes, device=labels.device)
    t = (labels[..., None] == classes).to(logits.dtype)
    p = torch.sigmoid(logits)
    relu = torch.maximum(logits, torch.zeros_like(logits))
    bce = relu - logits * t + torch.log1p(torch.exp(-torch.abs(logits)))
    pt = (1.0 - p) * t + p * (1.0 - t)
    alpha_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    loss = alpha_t * torch.pow(pt, gamma) * bce
    return (loss * weights[..., None]).sum() / _avg(avg_factor)


def weighted_smooth_l1(pred: torch.Tensor, target: torch.Tensor, weights: torch.Tensor,
                       avg_factor, beta: float = 1.0) -> torch.Tensor:
    """Smooth L1 (mmdet SmoothL1Loss; the cascade's RoI regression)."""
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return (loss * weights).sum() / _avg(avg_factor)


def accuracy(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
             avg_factor=None) -> torch.Tensor:
    """Weighted top-1 accuracy (mmdet logs ``acc`` for the RoI head), over
    ``avg_factor`` when given (a data-parallel rank's share of the global
    batch's), else over the weights' sum."""
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels).float() * weights
    return correct.sum() / _avg(weights.sum() if avg_factor is None else avg_factor)

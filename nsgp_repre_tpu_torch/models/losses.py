"""Detection losses with mmdet weight/avg_factor semantics.

Counterpart of nsgp_repre_tpu/models/losses.py: ``weighted_sigmoid_bce``,
``weighted_softmax_ce``, ``weighted_l1`` and ``accuracy`` (mmdet
cross_entropy_loss.py:202, smooth_l1_loss.py:118 L1Loss): elementwise
loss times weight, summed and divided by ``avg_factor``. The focal and
smooth-L1 losses serve the model zoo and are not ported yet.
"""
from __future__ import annotations

import torch


def _avg(avg_factor) -> torch.Tensor:
    return torch.clamp(torch.as_tensor(avg_factor, dtype=torch.float32), min=1.0)


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


def accuracy(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted top-1 accuracy (mmdet logs ``acc`` for the RoI head)."""
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels).float() * weights
    return correct.sum() / torch.clamp(weights.sum(), min=1.0)

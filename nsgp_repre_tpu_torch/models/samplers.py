"""Random pos/neg sampling with static shapes.

Counterpart of nsgp_repre_tpu/models/samplers.py (mmdet
random_sampler.py:14): sample ``num`` priors, at most ``num *
pos_fraction`` positives, fill the rest with negatives, take all
candidates when a pool is short. A prior is sampled iff its priority
clears the k-th largest priority of its pool, where k adapts to the
actual positive count.

The priorities are inputs: ``u`` (the masks) and ``u2`` (the gather
order), iid uniform on [0, 1) and drawn by the caller (the detector draws
them from its ``torch.Generator``; a parity test passes JAX's draws). The
functions are batched over a leading image dimension: one call stands
for JAX's ``vmap`` over images.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.topk import top_k
from .assigners import NEG

BIG = 1.0e6


def _kth_largest_threshold(priority: torch.Tensor, mask: torch.Tensor, k_max: int):
    """Per-row value of the k-th largest masked priority, k = min(k_dyn,
    k_max): the static top-``k_max``, then indexed with the dynamic k
    (clipped to at least 1; masked-out entries are -inf)."""
    masked = torch.where(mask, priority, torch.full_like(priority, float("-inf")))
    k_max = min(k_max, masked.shape[-1])  # tiny single-level test maps
    top = top_k(masked, k_max)[0]  # (B, k_max) descending

    def thresh(k_dyn: torch.Tensor) -> torch.Tensor:
        """k_dyn (B, 1) → the (B, 1) thresholds."""
        k = torch.clamp(k_dyn, 1, k_max).long()
        return torch.gather(top, -1, k - 1)

    return thresh


def random_sample_masks(
    assigned: torch.Tensor,
    num: int,
    pos_fraction: float,
    u: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select pos/neg masks (no gather).

    Args:
        assigned: (B, N) int32 from ``max_iou_assign``.
        u: (B, N) f32 priorities.

    Returns:
        pos_mask, neg_mask: (B, N) bool, with ``sum(pos) <= num*pos_fraction``
        and ``sum(pos) + sum(neg) <= num`` per row.
    """
    is_pos = assigned >= 0
    is_neg = assigned == NEG

    max_pos = int(num * pos_fraction)
    pos_thresh = _kth_largest_threshold(u, is_pos, max_pos)
    n_pos_avail = is_pos.sum(dim=-1, keepdim=True)
    pos_mask = is_pos & (u >= pos_thresh(torch.clamp(n_pos_avail, max=max_pos)))
    # if fewer than max_pos positives exist, the threshold is -inf → all selected
    pos_mask = pos_mask & (n_pos_avail != 0)

    n_pos_sel = pos_mask.sum(dim=-1, keepdim=True)
    neg_needed = torch.clamp(num - n_pos_sel, min=0)
    neg_thresh = _kth_largest_threshold(u, is_neg, num)
    n_neg_avail = is_neg.sum(dim=-1, keepdim=True)
    k_neg = torch.minimum(neg_needed, n_neg_avail)
    neg_mask = is_neg & (u >= neg_thresh(k_neg))
    neg_mask = neg_mask & (k_neg != 0)
    return pos_mask, neg_mask


def random_sample_gather(
    assigned: torch.Tensor,
    num: int,
    pos_fraction: float,
    u: torch.Tensor,
    u2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like :func:`random_sample_masks` but also gathers ``num`` indices
    per row, ordered by ``u2`` (positives first, then negatives).

    Returns:
        idx: (B, num) int64 indices of sampled priors (unused slots 0).
        idx_valid: (B, num) bool slot validity.
        idx_pos: (B, num) bool — slot is a positive sample.
    """
    pos_mask, neg_mask = random_sample_masks(assigned, num, pos_fraction, u)
    B, n = assigned.shape
    # f32 keys as in JAX: 2e6 + u2 rounds u2 to 1/8 steps, so equal keys
    # are common and the exact top-k's tie order (lowest index) matters
    key = torch.where(pos_mask, 2.0 * BIG + u2, torch.where(neg_mask, BIG + u2, u2 - BIG))
    k = min(num, n)
    topv, topi = top_k(key, k)
    if k < num:  # fewer priors than slots (tiny single-level maps)
        topv = torch.cat([topv, torch.full((B, num - k), -BIG, dtype=topv.dtype,
                                           device=topv.device)], dim=1)
        topi = torch.cat([topi, torch.zeros((B, num - k), dtype=topi.dtype,
                                            device=topi.device)], dim=1)
    idx_valid = topv > 0.0
    idx_pos = topv > 2.0 * BIG - 1.0
    idx = torch.where(idx_valid, topi, torch.zeros_like(topi))
    return idx, idx_valid, idx_pos

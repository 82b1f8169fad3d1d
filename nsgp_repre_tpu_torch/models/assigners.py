"""MaxIoU assignment as a static-shape function.

Counterpart of nsgp_repre_tpu/models/assigners.py (mmdet
max_iou_assigner.py:85 ``assign_wrt_overlaps``):
  1. every prior starts unassigned (IGNORE);
  2. priors with max-IoU < neg_thr → negative (NEG);
  3. priors with max-IoU >= pos_thr → that gt (the FIRST gt among ties);
  4. match_low_quality: each gt claims ALL priors tying its best IoU if
     that IoU >= min_pos_iou; later gts override earlier ones.

Padded (invalid) gts are excluded by forcing their overlaps to -1.
Leading batch dimensions are allowed: priors (..., N, 4) or (N, 4) shared
by the batch, gts (..., G, 4); one call stands for JAX's ``vmap``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..structures.boxes import bbox_overlaps

NEG = -1  # negative (background) prior
IGNORE = -2  # unassigned / ignored prior


def max_iou_assign(
    priors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    pos_iou_thr: float,
    neg_iou_thr: float,
    min_pos_iou: float,
    match_low_quality: bool,
    prior_valid: Optional[torch.Tensor] = None,
    gt_max_assign_all: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign each prior a gt index, NEG or IGNORE.

    Args:
        priors: (..., N, 4); gt_boxes: (..., G, 4); gt_valid: (..., G) bool.
        prior_valid: optional (..., N) bool — invalid priors end up IGNORE.

    Returns:
        assigned: (..., N) int32 — gt index in [0, G), NEG, or IGNORE.
        max_overlaps: (..., N) f32 — max IoU with any valid gt.
    """
    overlaps = bbox_overlaps(gt_boxes, priors)  # (..., G, N)
    overlaps = torch.where(gt_valid[..., :, None], overlaps, torch.full_like(overlaps, -1.0))

    # torch.max returns the first index among equal maxima, as jnp.argmax
    max_overlaps, argmax_gt = overlaps.max(dim=-2)
    argmax_gt = argmax_gt.to(torch.int32)

    assigned = torch.full_like(argmax_gt, IGNORE)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           torch.full_like(assigned, NEG), assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_gt, assigned)

    if match_low_quality:
        gt_max = overlaps.max(dim=-1, keepdim=True).values  # (..., G, 1)
        claim = (overlaps == gt_max) & (gt_max >= min_pos_iou) & gt_valid[..., :, None]
        if not gt_max_assign_all:
            # SSD (gt_max_assign_all=False): each gt claims only its single
            # argmax prior, not every tying prior
            first = overlaps.argmax(dim=-1, keepdim=True)  # (..., G, 1)
            only = torch.zeros_like(claim).scatter_(-1, first, True)
            claim = claim & only
        # later gts override earlier ones → the largest claiming gt index
        G = gt_boxes.shape[-2]
        gt_ids = torch.arange(G, dtype=torch.int32, device=overlaps.device)[:, None]
        claimed_by = torch.where(claim, gt_ids, torch.full_like(gt_ids, -1)).max(dim=-2).values
        assigned = torch.where(claimed_by >= 0, claimed_by, assigned)

    if prior_valid is not None:
        assigned = torch.where(prior_valid, assigned, torch.full_like(assigned, IGNORE))
    return assigned, max_overlaps

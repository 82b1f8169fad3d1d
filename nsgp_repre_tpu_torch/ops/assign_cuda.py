"""Fused RPN anchor assignment + regression targets (kernel in csrc/assign.cu).

Counterpart of nsgp_repre_tpu/ops/assign_pallas.py
(``rpn_assign_targets_pallas``). The plain version below is what the JAX
detector computes off the TPU (detector.py:338-358): ``max_iou_assign``
with low-quality matching, the matched gt of every anchor, and
``bbox2delta``; the JAX one-hot matmul selects the matched gt exactly,
as the gather here does. On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models.assigners import max_iou_assign
from ..structures.boxes import bbox2delta
from . import _ext

THREADS = 256  # anchors per block (csrc/assign.cu kThreads)
MAX_G = 512  # gt slots the kernel keeps in shared memory (kMaxG)


def rpn_assign_targets_plain(anchors, gt_boxes, gt_valid, prior_valid, pos_iou_thr: float,
                             neg_iou_thr: float, min_pos_iou: float):
    """Plain PyTorch version of the assign kernel (same contract)."""
    assigned, max_overlaps = max_iou_assign(
        anchors, gt_boxes, gt_valid, pos_iou_thr, neg_iou_thr, min_pos_iou,
        match_low_quality=True, prior_valid=prior_valid,
    )
    B, N = assigned.shape
    g = assigned.clamp(min=0).long()
    matched = torch.gather(gt_boxes.float(), 1, g[..., None].expand(B, N, 4))
    return assigned, max_overlaps, bbox2delta(anchors.float(), matched)


def rpn_assign_targets(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    prior_valid: torch.Tensor,
    pos_iou_thr: float,
    neg_iou_thr: float,
    min_pos_iou: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched anchor assignment + regression targets.

    Args:
        anchors: (N, 4) f32, shared across the batch.
        gt_boxes: (B, G, 4) f32; gt_valid: (B, G) bool.
        prior_valid: (B, N) bool.

    Returns:
        assigned (B, N) int32 (gt index, -1 negative, -2 ignore),
        max_overlaps (B, N) f32, tgt (B, N, 4) f32.
    """
    if not anchors.is_cuda:
        return rpn_assign_targets_plain(anchors, gt_boxes, gt_valid, prior_valid,
                                        pos_iou_thr, neg_iou_thr, min_pos_iou)
    B, G = gt_valid.shape
    N = anchors.shape[0]
    if tuple(anchors.shape) != (N, 4) or tuple(gt_boxes.shape) != (B, G, 4) \
            or tuple(prior_valid.shape) != (B, N):
        raise ValueError(f"anchors (N,4), gt_boxes (B,G,4), gt_valid (B,G), prior_valid (B,N): got "
                         f"{tuple(anchors.shape)}, {tuple(gt_boxes.shape)}, {tuple(gt_valid.shape)}, "
                         f"{tuple(prior_valid.shape)}")
    if not 1 <= G <= MAX_G:
        raise ValueError(f"assign kernel keeps 1..{MAX_G} gt slots per image, got {G}")
    dev = anchors.device
    anchors = anchors.float().contiguous()
    gt_boxes = gt_boxes.to(device=dev, dtype=torch.float32).contiguous()
    gt_valid = gt_valid.to(device=dev, dtype=torch.bool).contiguous()
    prior_valid = prior_valid.to(device=dev, dtype=torch.bool).contiguous()
    for t, name in ((anchors, "anchors"), (gt_boxes, "gt_boxes"), (gt_valid, "gt_valid"),
                    (prior_valid, "prior_valid")):
        _ext.require_cuda(t, name, (t.dtype,))
    nblk = -(-N // THREADS)
    partial = torch.empty((B, nblk, G), dtype=torch.float32, device=dev)
    gmax = torch.empty((B, G), dtype=torch.float32, device=dev)
    assigned = torch.empty((B, N), dtype=torch.int32, device=dev)
    max_overlaps = torch.empty((B, N), dtype=torch.float32, device=dev)
    tgt = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
    if B and N:
        rc = _ext.lib().nsgp_assign(
            anchors.data_ptr(), gt_boxes.data_ptr(), gt_valid.data_ptr(), prior_valid.data_ptr(),
            partial.data_ptr(), gmax.data_ptr(), assigned.data_ptr(), max_overlaps.data_ptr(),
            tgt.data_ptr(), B, N, G, float(pos_iou_thr), float(neg_iou_thr), float(min_pos_iou),
            _ext.stream_ptr(anchors),
        )
        _ext.check(rc, "assign")
        _ext.LAUNCHES["assign"] += 1
    return assigned, max_overlaps, tgt

"""Greedy NMS with fixed-size outputs, plain PyTorch.

Counterpart of nsgp_repre_tpu/ops/nms.py (``nms``, ``batched_nms``),
batched over a leading image dim instead of vmapped. This is the plain
version of the CUDA kernel in ops/nms_cuda.py and what that wrapper runs
for CPU tensors.

Semantics: repeatedly pick the live box with the highest score (ties →
lowest index), keep it, and suppress every box whose IoU with it is
> ``iou_threshold``. Output is ``max_out`` indices in pick order, 0 in
unused slots, plus a validity mask.
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e10


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """IoU of ``a`` (..., 4) against ``b`` (..., N, 4) → (..., N), in the
    operation order of structures/boxes.py::bbox_overlaps (a = boxes1)."""
    a = a.unsqueeze(-2)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = iw * ih
    union = torch.clamp(area_a + area_b - inter, min=eps)
    return inter / union


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float, max_out: int):
    """Greedy NMS per image.

    Args:
        boxes (B, N, 4), scores (B, N), valid (B, N) bool.

    Returns:
        keep_idx (B, max_out) int32, keep_valid (B, max_out) bool.
    """
    B, N = scores.shape
    dev = scores.device
    live = torch.where(valid, scores.float(), torch.full_like(scores, NEG_INF, dtype=torch.float32))
    boxes = boxes.float()
    rows = torch.arange(B, device=dev)
    keep_idx = torch.zeros((B, max_out), dtype=torch.int32, device=dev)
    keep_valid = torch.zeros((B, max_out), dtype=torch.bool, device=dev)
    for i in range(max_out):
        j = torch.argmax(live, dim=1)
        ok = live[rows, j] > NEG_INF / 2
        if not bool(ok.any()):
            break
        keep_idx[:, i] = torch.where(ok, j, torch.zeros_like(j)).to(torch.int32)
        keep_valid[:, i] = ok
        suppress = pairwise_iou(boxes[rows, j], boxes) > iou_threshold
        suppress[rows, j] = True
        live = torch.where(ok[:, None] & suppress, torch.full_like(live, NEG_INF), live)
    return keep_idx, keep_valid


def offset_boxes(boxes: torch.Tensor, idxs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Shift each group (class or level) of every image to its own region
    of the plane, so groups never suppress each other. The shift is
    ``idx * (max coordinate of the image's valid boxes + 1)``, per image
    as the JAX package computes it on the CPU (ops/nms.py:190 under vmap)."""
    boxes = boxes.float()
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    max_coord = torch.where(valid[..., None], boxes, zero).amax(dim=(1, 2)) + 1.0
    offsets = idxs.to(boxes.dtype) * max_coord[:, None]
    return boxes + offsets[..., None]


def batched_nms(boxes, scores, idxs, valid, iou_threshold: float, max_out: int):
    """Class/level-aware greedy NMS (mmcv ``batched_nms`` semantics)."""
    return nms(offset_boxes(boxes, idxs, valid), scores, valid, iou_threshold, max_out)

"""Batched greedy NMS on the card (kernels in csrc/nms.cu).

Counterpart of nsgp_repre_tpu/ops/nms_pallas.py (``batched_nms_pallas``).
The wrapper applies the per-image group offset, ranks each image's
masked scores with a stable descending sort (as the JAX wrapper ranks
outside its kernel, nms_pallas.py:178-179), and hands the sorted boxes
to the kernels: one builds the pairwise suppression bitmask, one sweeps
it greedily. For CPU tensors it runs the plain version, ops/nms.py.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _ext
from .nms import NEG_INF, offset_boxes
from .nms import nms as nms_plain

BLOCK = 64  # boxes per bitmask word (csrc/nms.cu kBlock)
MAX_WORDS = 6000  # the sweep keeps one "removed" word per 64 boxes, under 48 KB of shared memory


def sort_candidates(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's inputs: boxes in greedy pick order (score descending,
    equal scores lowest index first, valid boxes first) as (B, N, 4) f32,
    the original index of each sorted box (B, N) int32, and the number of
    valid boxes per image (B,) int32."""
    B, N = scores.shape
    neg = torch.full_like(scores, NEG_INF, dtype=torch.float32)
    masked = torch.where(valid, scores.float(), neg)
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices
    sorted_boxes = torch.gather(boxes.float(), 1, order[..., None].expand(B, N, 4))
    n_valid = valid.sum(dim=1, dtype=torch.int32)
    return sorted_boxes.contiguous(), order.to(torch.int32).contiguous(), n_valid.contiguous()


def nms_kernel(boxes, scores, valid, iou_threshold: float, max_out: int):
    """Greedy NMS of (B, N, 4) CUDA boxes; same contract as
    ops/nms.py::nms (keep_idx (B, max_out) int32, keep_valid)."""
    B, N = scores.shape
    if tuple(boxes.shape) != (B, N, 4) or tuple(valid.shape) != (B, N):
        raise ValueError(f"boxes (B,N,4), scores and valid (B,N): got {tuple(boxes.shape)}, "
                         f"{tuple(scores.shape)}, {tuple(valid.shape)}")
    dev = scores.device
    sorted_boxes, order, n_valid = sort_candidates(boxes, scores, valid)
    for t, name in ((sorted_boxes, "boxes"), (order, "order"), (n_valid, "n_valid")):
        _ext.require_cuda(t, name, (t.dtype,))
    nblk = (N + BLOCK - 1) // BLOCK
    if nblk > MAX_WORDS:
        raise ValueError(f"nms kernel keeps {MAX_WORDS * BLOCK} candidates at most, got {N}")
    mask = torch.empty((B, N, max(nblk, 1)), dtype=torch.int64, device=dev)
    keep_idx = torch.zeros((B, max_out), dtype=torch.int32, device=dev)
    count = torch.zeros((B,), dtype=torch.int32, device=dev)
    if B and N and max_out:
        rc = _ext.lib().nsgp_nms(
            sorted_boxes.data_ptr(), order.data_ptr(), n_valid.data_ptr(), mask.data_ptr(),
            keep_idx.data_ptr(), count.data_ptr(), B, N, float(iou_threshold), max_out,
            _ext.stream_ptr(scores),
        )
        _ext.check(rc, "nms")
        _ext.LAUNCHES["nms"] += 1
    keep_valid = torch.arange(max_out, device=dev)[None, :] < count[:, None]
    return keep_idx, keep_valid


def batched_nms(boxes, scores, idxs, valid, iou_threshold: float, max_out: int):
    """Class/level-aware greedy NMS over a batch: (B, N, 4) boxes, (B, N)
    scores, group ids and validity → keep_idx (B, max_out) int32 in pick
    order (0 in unused slots) and keep_valid (B, max_out) bool."""
    shifted = offset_boxes(boxes, idxs, valid)
    if not boxes.is_cuda:
        return nms_plain(shifted, scores, valid, iou_threshold, max_out)
    return nms_kernel(shifted, scores, valid, iou_threshold, max_out)

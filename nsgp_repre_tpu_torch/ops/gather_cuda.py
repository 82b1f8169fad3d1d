"""Row gather (kernel in csrc/gather.cu).

Counterpart of nsgp_repre_tpu/ops/gather_pallas.py (``gather_rows``):
``table[clip(idx, 0, N-1)]``, the rows of an (N, C) table picked by an
(M,) index vector, out-of-range indices clamped. The TPU kernel's
``C % 1024 == 0`` rule is a tiling limit of its memory layout, not part
of the function: the CUDA kernel takes any row that is a whole number of
16-byte vectors. On a CPU tensor the wrapper runs the plain version
below; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _ext


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows = table[clip(idx, 0, N-1)]: (N, C) table, (M,) int32 idx → (M, C)."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table must be (N, C) and idx (M,), got {tuple(table.shape)}, "
                         f"{tuple(idx.shape)}")
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    N, C = table.shape
    _ext.require_cuda(table, "table")
    row_bytes = C * table.element_size()
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"gather kernel copies 16-byte vectors: a row of {C} x {table.dtype} "
                         "must be a multiple of 16 bytes and the table 16-byte aligned")
    if N == 0 or N >= 2 ** 31:
        raise ValueError(f"gather kernel needs 0 < N < 2**31 rows, got {N}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    idx = idx.to(table.device).contiguous()
    out = torch.empty((idx.shape[0], C), device=table.device, dtype=table.dtype)
    if out.numel():
        rc = _ext.lib().nsgp_gather(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                    idx.shape[0], N, row_bytes, _ext.stream_ptr(table))
        _ext.check(rc, "gather")
        _ext.LAUNCHES["gather"] += 1
    return out

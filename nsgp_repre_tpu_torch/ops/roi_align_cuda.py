"""FPN multilevel RoIAlign on the card (kernel in csrc/roi_align.cu).

Counterpart of nsgp_repre_tpu/ops/roi_align_pallas.py
(``multilevel_roi_align_pallas`` / ``multilevel_roi_align_window``) with
the standard mmdet level routing: the TPU kernel's window-fit level bump
does not exist here, so both ``roi_align_mode`` values of DetectorConfig
run this kernel. For CPU tensors the wrapper runs the plain version,
ops/roi_align.py. Output is in the feature dtype, accumulated in f32.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _ext
from .roi_align import multilevel_roi_align as roi_align_plain


def multilevel_roi_align(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    batch_idx: torch.Tensor,
    strides: Sequence[int] = (4, 8, 16, 32),
    output_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
    aligned: bool = True,
) -> torch.Tensor:
    """features: L NHWC maps (B, H_l, W_l, C) of one dtype; rois (R, 4)
    image coordinates; batch_idx (R,). Returns (R, out, out, C) in the
    feature dtype."""
    dt = features[0].dtype
    if not rois.is_cuda:
        out = roi_align_plain(
            features, rois, batch_idx, strides=strides, output_size=output_size,
            sampling_ratio=sampling_ratio, finest_scale=finest_scale, aligned=aligned,
        )
        return out.to(dt)
    L = len(features)
    B, _, _, C = features[0].shape
    if not 1 <= L <= 5 or len(strides) < L:
        raise ValueError(f"1..5 levels with a stride each, got {L} levels, {len(strides)} strides")
    if C > 1024 or C % 32:
        raise ValueError(f"roi_align kernel runs one thread per channel: C % 32 == 0, C <= 1024; got {C}")
    for i, f in enumerate(features):
        _ext.require_cuda(f, f"features[{i}]")
        if f.dtype != dt or f.shape[0] != B or f.shape[3] != C:
            raise ValueError(f"features[{i}] {tuple(f.shape)} {f.dtype} does not match level 0")
    rois = rois.float().contiguous()
    batch_idx = batch_idx.to(device=rois.device, dtype=torch.int32).contiguous()
    if rois.ndim != 2 or rois.shape[1] != 4 or batch_idx.shape != (rois.shape[0],):
        raise ValueError(f"rois (R,4) and batch_idx (R,), got {tuple(rois.shape)}, {tuple(batch_idx.shape)}")
    R = rois.shape[0]
    out = torch.empty((R, output_size, output_size, C), dtype=dt, device=rois.device)
    if R:
        ptrs = (ctypes.c_void_p * L)(*[f.data_ptr() for f in features])
        hs = (ctypes.c_int * L)(*[f.shape[1] for f in features])
        ws = (ctypes.c_int * L)(*[f.shape[2] for f in features])
        scales = (ctypes.c_float * L)(*[1.0 / s for s in strides[:L]])
        rc = _ext.lib().nsgp_roi_align(
            ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(hs, ctypes.c_void_p),
            ctypes.cast(ws, ctypes.c_void_p), ctypes.cast(scales, ctypes.c_void_p), L,
            rois.data_ptr(), batch_idx.data_ptr(), out.data_ptr(), R, C, output_size,
            sampling_ratio, float(finest_scale), int(aligned), _ext.DTYPE_CODE[dt],
            _ext.stream_ptr(rois),
        )
        _ext.check(rc, "roi_align")
        _ext.LAUNCHES["roi_align"] += 1
    return out

"""FPN multilevel RoIAlign on the card, forward and backward (kernels in
csrc/roi_align.cu).

Counterpart of nsgp_repre_tpu/ops/roi_align_pallas.py
(``multilevel_roi_align_pallas`` / ``multilevel_roi_align_window`` and
its backward ``multilevel_roi_align_bwd_pallas``) with the standard
mmdet level routing: the TPU kernel's window-fit level bump does not
exist here, so both ``roi_align_mode`` values of DetectorConfig run these
kernels. For CPU tensors the wrappers run the plain versions,
ops/roi_align.py. The forward output is in the feature dtype, accumulated
in f32; the level gradients are accumulated in f32 and cast once to the
feature dtype. :func:`multilevel_roi_align` is differentiable w.r.t. the
features through :class:`RoIAlignFunction`; RoIs and batch indices get no
gradient (proposals are data, detector.py:482-486 in JAX).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _ext
from .roi_align import multilevel_roi_align as roi_align_plain
from .roi_align import multilevel_roi_align_backward as roi_align_backward_plain


def _check_rois(rois: torch.Tensor, batch_idx: torch.Tensor):
    rois = rois.float().contiguous()
    batch_idx = batch_idx.to(device=rois.device, dtype=torch.int32).contiguous()
    if rois.ndim != 2 or rois.shape[1] != 4 or batch_idx.shape != (rois.shape[0],):
        raise ValueError(f"rois (R,4) and batch_idx (R,), got {tuple(rois.shape)}, {tuple(batch_idx.shape)}")
    return rois, batch_idx


def _check_levels(L: int, C: int, strides: Sequence[int]) -> None:
    if not 1 <= L <= 5 or len(strides) < L:
        raise ValueError(f"1..5 levels with a stride each, got {L} levels, {len(strides)} strides")
    if C > 1024 or C % 32:
        raise ValueError(f"roi_align kernels run one thread per channel: C % 32 == 0, C <= 1024; got {C}")


def roi_align_forward(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    batch_idx: torch.Tensor,
    strides: Sequence[int] = (4, 8, 16, 32),
    output_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
    aligned: bool = True,
) -> torch.Tensor:
    """The forward alone (no autograd): features L NHWC maps (B, H_l, W_l,
    C) of one dtype; rois (R, 4) image coordinates; batch_idx (R,).
    Returns (R, out, out, C) in the feature dtype."""
    dt = features[0].dtype
    if not rois.is_cuda:
        out = roi_align_plain(
            features, rois, batch_idx, strides=strides, output_size=output_size,
            sampling_ratio=sampling_ratio, finest_scale=finest_scale, aligned=aligned,
        )
        return out.to(dt)
    L = len(features)
    B, _, _, C = features[0].shape
    _check_levels(L, C, strides)
    for i, f in enumerate(features):
        _ext.require_cuda(f, f"features[{i}]")
        if f.dtype != dt or f.shape[0] != B or f.shape[3] != C:
            raise ValueError(f"features[{i}] {tuple(f.shape)} {f.dtype} does not match level 0")
    rois, batch_idx = _check_rois(rois, batch_idx)
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


def multilevel_roi_align_backward(
    g: torch.Tensor,
    rois: torch.Tensor,
    batch_idx: torch.Tensor,
    level_hw: Sequence[Tuple[int, int]],
    batch_size: int,
    dtype: torch.dtype = torch.float32,
    strides: Sequence[int] = (4, 8, 16, 32),
    output_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
    aligned: bool = True,
) -> List[torch.Tensor]:
    """Gradient w.r.t. the level maps: g (R, out, out, C) → one
    (B, H_l, W_l, C) tensor of ``dtype`` per level (f32 accumulation)."""
    if not g.is_cuda:
        return roi_align_backward_plain(
            g, rois, batch_idx, level_hw, batch_size, dtype, strides=strides,
            output_size=output_size, sampling_ratio=sampling_ratio,
            finest_scale=finest_scale, aligned=aligned,
        )
    L = len(level_hw)
    C = g.shape[-1]
    _check_levels(L, C, strides)
    if dtype not in _ext.DTYPE_CODE:
        raise ValueError(f"level gradients in f32 or bf16, got {dtype}")
    g = g.contiguous()
    _ext.require_cuda(g, "g")
    rois, batch_idx = _check_rois(rois, batch_idx)
    R = rois.shape[0]
    if tuple(g.shape) != (R, output_size, output_size, C):
        raise ValueError(f"g must be ({R},{output_size},{output_size},{C}), got {tuple(g.shape)}")
    sizes = [batch_size * h * w for h, w in level_hw]
    offs = [sum(sizes[:i]) for i in range(L)]
    rows = sum(sizes)
    acc = torch.empty((rows, C), dtype=torch.float32, device=g.device)
    hs = (ctypes.c_int * L)(*[h for h, _ in level_hw])
    ws = (ctypes.c_int * L)(*[w for _, w in level_hw])
    scales = (ctypes.c_float * L)(*[1.0 / s for s in strides[:L]])
    offs_c = (ctypes.c_longlong * L)(*offs)
    rc = _ext.lib().nsgp_roi_align_bwd(
        ctypes.cast(hs, ctypes.c_void_p), ctypes.cast(ws, ctypes.c_void_p),
        ctypes.cast(scales, ctypes.c_void_p), ctypes.cast(offs_c, ctypes.c_void_p), L,
        rois.data_ptr(), batch_idx.data_ptr(), g.data_ptr(), _ext.DTYPE_CODE[g.dtype],
        acc.data_ptr(), rows, R, C, output_size,
        sampling_ratio, float(finest_scale), int(aligned), _ext.stream_ptr(g),
    )
    _ext.check(rc, "roi_align_bwd")
    _ext.LAUNCHES["roi_align_bwd"] += 1
    out = acc.to(dtype)
    return [out[o:o + n].view(batch_size, h, w, C)
            for o, n, (h, w) in zip(offs, sizes, level_hw)]


class RoIAlignFunction(torch.autograd.Function):
    """RoIAlign forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, rois, batch_idx, opts, *features):
        ctx.save_for_backward(rois, batch_idx)
        ctx.opts = opts
        ctx.level_hw = [(f.shape[1], f.shape[2]) for f in features]
        ctx.batch_size = features[0].shape[0]
        ctx.dtype = features[0].dtype
        return roi_align_forward(features, rois, batch_idx, **opts)

    @staticmethod
    def backward(ctx, g):
        rois, batch_idx = ctx.saved_tensors
        grads = multilevel_roi_align_backward(
            g, rois, batch_idx, ctx.level_hw, ctx.batch_size, ctx.dtype, **ctx.opts)
        return (None, None, None, *grads)


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
    feature dtype, differentiable w.r.t. the features."""
    opts = dict(strides=tuple(strides), output_size=output_size, sampling_ratio=sampling_ratio,
                finest_scale=finest_scale, aligned=aligned)
    return RoIAlignFunction.apply(rois.detach(), batch_idx.detach(), opts, *features)

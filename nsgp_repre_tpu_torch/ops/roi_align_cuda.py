"""FPN multilevel RoIAlign on the card, forward and backward (kernels in
csrc/roi_align.cu).

Counterpart of nsgp_repre_tpu/ops/roi_align_pallas.py
(``multilevel_roi_align_pallas`` / ``multilevel_roi_align_window`` and
its backward ``multilevel_roi_align_bwd_pallas``) with the standard
mmdet level routing: the TPU kernel's window-fit level bump does not
exist here, so both ``roi_align_mode`` values of DetectorConfig run these
kernels. For CPU tensors the wrappers run the plain versions,
ops/roi_align.py. The forward output is in the feature dtype, accumulated
in f32. The backward bins the RoIs onto 8x8 tiles of the level maps
(:func:`roi_footprints` is its rule) and sums each tile's RoIs in index
order in f32, writing every level gradient once in the requested dtype:
no atomics on data, so two calls give the same bits.
:func:`multilevel_roi_align` is differentiable w.r.t. the features
through :class:`RoIAlignFunction`; RoIs and batch indices get no
gradient (proposals are data, detector.py:482-486 in JAX).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _ext
from .roi_align import multilevel_roi_align as roi_align_plain
from .roi_align import multilevel_roi_align_backward as roi_align_backward_plain
from .roi_align import roi_footprints as roi_footprints_plain

BWD_TILE = 8  # map pixels per backward tile side (kTile in csrc/roi_align.cu)
BWD_CHUNK = 32  # channels per backward block (kChunk)
BWD_MAX_OUT = 32  # output_size of the backward (kMaxOut)
BWD_MAX_SIDE = 32768  # map rows and columns of the backward (kMaxSide)
MAX_SAMPLES = 64  # output_size * sampling_ratio per axis (kMaxSamples)


def _check_rois(rois: torch.Tensor, batch_idx: torch.Tensor):
    rois = rois.float().contiguous()
    batch_idx = batch_idx.to(device=rois.device, dtype=torch.int32).contiguous()
    if rois.ndim != 2 or rois.shape[1] != 4 or batch_idx.shape != (rois.shape[0],):
        raise ValueError(f"rois (R,4) and batch_idx (R,), got {tuple(rois.shape)}, {tuple(batch_idx.shape)}")
    return rois, batch_idx


def _check_levels(L: int, strides: Sequence[int], output_size: int, sampling_ratio: int) -> None:
    if not 1 <= L <= 5 or len(strides) < L:
        raise ValueError(f"1..5 levels with a stride each, got {L} levels, {len(strides)} strides")
    if sampling_ratio < 1 or output_size < 1 or output_size * sampling_ratio > MAX_SAMPLES:
        raise ValueError(f"output_size * sampling_ratio in 1..{MAX_SAMPLES}, got "
                         f"{output_size} * {sampling_ratio}")


def _carray(ctype, vals) -> ctypes.c_void_p:
    """The address of a new ctypes array of ``vals`` (the pointer object
    keeps the array alive)."""
    return ctypes.cast((ctype * len(vals))(*vals), ctypes.c_void_p)


def _level_arrays(level_hw: Sequence[Tuple[int, int]], strides: Sequence[int]):
    L = len(level_hw)
    return (_carray(ctypes.c_int, [h for h, _ in level_hw]),
            _carray(ctypes.c_int, [w for _, w in level_hw]),
            _carray(ctypes.c_float, [1.0 / s for s in strides[:L]]))


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
    Returns (R, out, out, C) in the feature dtype. On the card C must be a
    multiple of the 16-byte vector (8 bf16, 4 f32 channels)."""
    dt = features[0].dtype
    if not rois.is_cuda:
        out = roi_align_plain(
            features, rois, batch_idx, strides=strides, output_size=output_size,
            sampling_ratio=sampling_ratio, finest_scale=finest_scale, aligned=aligned,
        )
        return out.to(dt)
    L = len(features)
    B, _, _, C = features[0].shape
    _check_levels(L, strides, output_size, sampling_ratio)
    for i, f in enumerate(features):
        _ext.require_cuda(f, f"features[{i}]")
        if f.dtype != dt or f.shape[0] != B or f.shape[3] != C:
            raise ValueError(f"features[{i}] {tuple(f.shape)} {f.dtype} does not match level 0")
        if f.data_ptr() % 16:
            raise ValueError(f"features[{i}] must be 16-byte aligned (the kernel's vector loads)")
    vec = 16 // features[0].element_size()
    if C % vec:
        raise ValueError(f"roi_align loads 16-byte vectors: C % {vec} == 0 in {dt}, got {C}")
    rois, batch_idx = _check_rois(rois, batch_idx)
    R = rois.shape[0]
    out = torch.empty((R, output_size, output_size, C), dtype=dt, device=rois.device)
    if R:
        hs, ws, scales = _level_arrays([(f.shape[1], f.shape[2]) for f in features], strides)
        ptrs = _carray(ctypes.c_void_p, [f.data_ptr() for f in features])
        rc = _ext.lib().nsgp_roi_align(
            ptrs, hs, ws, scales, L, rois.data_ptr(), batch_idx.data_ptr(), out.data_ptr(), R, C,
            output_size, sampling_ratio, float(finest_scale), int(aligned),
            _ext.DTYPE_CODE[dt], _ext.stream_ptr(rois),
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
    (B, H_l, W_l, C) tensor of ``dtype`` per level (f32 sums, rounded once
    to ``dtype``). On the card C must be a multiple of 32 and output_size
    at most 32, and two calls give the same bits."""
    if not g.is_cuda:
        return roi_align_backward_plain(
            g, rois, batch_idx, level_hw, batch_size, dtype, strides=strides,
            output_size=output_size, sampling_ratio=sampling_ratio,
            finest_scale=finest_scale, aligned=aligned,
        )
    L = len(level_hw)
    C = g.shape[-1]
    _check_levels(L, strides, output_size, sampling_ratio)
    if max(max(hw) for hw in level_hw) >= BWD_MAX_SIDE:
        raise ValueError(f"roi_align_bwd packs map indices in 16 bits: sides < {BWD_MAX_SIDE}, "
                         f"got {level_hw}")
    if C % BWD_CHUNK or output_size > BWD_MAX_OUT:
        raise ValueError(f"roi_align_bwd takes {BWD_CHUNK}-channel chunks and output_size <= "
                         f"{BWD_MAX_OUT}: C % {BWD_CHUNK} == 0, got C = {C}, "
                         f"output_size = {output_size}")
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
    out = torch.empty((sum(sizes), C), dtype=dtype, device=g.device)
    tiles = sum(batch_size * -(-h // BWD_TILE) * -(-w // BWD_TILE) for h, w in level_hw)
    # per tile: its RoIs' bits, then its RoI count and its place in the launch order
    masks = torch.empty((tiles * (-(-R // 32) + 2),), dtype=torch.int32, device=g.device)
    tabs = torch.empty((R, 2 * output_size * sampling_ratio, 4), dtype=torch.int32, device=g.device)
    hs, ws, scales = _level_arrays(level_hw, strides)
    rc = _ext.lib().nsgp_roi_align_bwd(
        hs, ws, scales, _carray(ctypes.c_longlong, offs), L, batch_size, rois.data_ptr(),
        batch_idx.data_ptr(), g.data_ptr(), _ext.DTYPE_CODE[g.dtype], out.data_ptr(),
        _ext.DTYPE_CODE[dtype], masks.data_ptr(), tabs.data_ptr(), R, C, output_size,
        sampling_ratio, float(finest_scale), int(aligned), _ext.stream_ptr(g),
    )
    _ext.check(rc, "roi_align_bwd")
    _ext.LAUNCHES["roi_align_bwd"] += 1
    return [out[o:o + n].view(batch_size, h, w, C)
            for o, n, (h, w) in zip(offs, sizes, level_hw)]


def roi_footprints(
    level_hw: Sequence[Tuple[int, int]],
    rois: torch.Tensor,
    strides: Sequence[int] = (4, 8, 16, 32),
    output_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
    aligned: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each RoI's level (R,) and the rows and columns its taps can reach,
    (R, 4) ``[y_lo, y_hi, x_lo, x_hi]`` (int64), as the backward's binning
    pass computes them: on the card by that pass's device code (a check of
    the kernel, not a launch of the main path, so it is not counted), on
    the CPU by the plain rule ``ops/roi_align.py::roi_footprints``."""
    if not rois.is_cuda:
        return roi_footprints_plain(level_hw, rois, strides, output_size, sampling_ratio,
                                    finest_scale, aligned)
    L = len(level_hw)
    _check_levels(L, strides, output_size, sampling_ratio)
    rois = rois.float().contiguous()
    R = rois.shape[0]
    out = torch.empty((R, 5), dtype=torch.int32, device=rois.device)
    hs, ws, scales = _level_arrays(level_hw, strides)
    rc = _ext.lib().nsgp_roi_footprints(
        hs, ws, scales, L, rois.data_ptr(), out.data_ptr(), R, output_size, sampling_ratio,
        float(finest_scale), int(aligned), _ext.stream_ptr(rois))
    _ext.check(rc, "roi_footprints")
    return out[:, 0].long(), out[:, 1:].long()


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

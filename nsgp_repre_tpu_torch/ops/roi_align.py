"""FPN multilevel RoIAlign, plain PyTorch.

Counterpart of nsgp_repre_tpu/ops/roi_align.py::multilevel_roi_align
(mmdet level routing, 7x7 bins, a fixed ss x ss sample grid per bin,
mmcv bilinear semantics with samples more than one pixel outside the map
zeroed, f32 accumulation), and its gradient w.r.t. the level maps. These
are the plain versions of the forward and backward CUDA kernels in
ops/roi_align_cuda.py and what that wrapper runs for CPU tensors.
Feature maps are NHWC, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

ROI_CHUNK = 256  # rois gathered at once (bounds the (R, P, 4, C) temporary)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once. On CUDA, PyTorch divides by a Python scalar
    as a multiply by its rounded reciprocal; a tensor divisor keeps the
    true quotient, as the kernel and the JAX package compute it (sample
    coordinates a few hundred pixels out move the bilinear weights by
    ~1e-5 per ulp)."""
    return x / torch.full_like(x, d)


def map_roi_levels(rois: torch.Tensor, num_levels: int, finest_scale: float = 56.0) -> torch.Tensor:
    """mmdet routing: clamp(floor(log2(sqrt(area)/finest_scale + 1e-6)), 0, L-1)."""
    area = (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1])
    scale = torch.sqrt(torch.clamp(area, min=0.0))
    lvl = torch.floor(torch.log2(_div(scale, finest_scale) + 1e-6))
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int64)


def _bilinear_weights_indices(y, x, height, width):
    """Corner indices (y0,y0,y1,y1), (x0,x1,x0,x1) and weights, mmcv
    semantics (ops/roi_align.py::_bilinear_weights_indices)."""
    outside = (y < -1.0) | (y > height) | (x < -1.0) | (x > width)
    y = torch.minimum(torch.clamp(y, min=0.0), height - 1.0)
    x = torch.minimum(torch.clamp(x, min=0.0), width - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = torch.minimum(y0 + 1.0, height - 1.0)
    x1 = torch.minimum(x0 + 1.0, width - 1.0)
    ly = y - y0
    lx = x - x0
    hy = 1.0 - ly
    hx = 1.0 - lx
    w = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx], dim=-1)
    w = torch.where(outside[..., None], torch.zeros_like(w), w)
    iy = torch.stack([y0, y0, y1, y1], dim=-1).to(torch.int64)
    ix = torch.stack([x0, x1, x0, x1], dim=-1).to(torch.int64)
    return iy, ix, w


def sample_taps(
    level_hw: Sequence[Tuple[int, int]],
    batch_size: int,
    rois: torch.Tensor,
    batch_idx: torch.Tensor,
    strides: Sequence[int] = (4, 8, 16, 32),
    output_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
    aligned: bool = True,
    lvl_override: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear taps of every sample: row indices into the pyramid
    flattened level by level, image by image ((R, P, 4) int64, P =
    (output_size * sampling_ratio)**2, corner order y0x0, y1x0, y0x1,
    y1x1) and their f32 weights (R, P, 4)."""
    L = len(level_hw)
    B = batch_size
    dev = rois.device
    R = rois.shape[0]
    ss = sampling_ratio
    rois = rois.float()
    if lvl_override is not None:
        lvl = lvl_override.to(device=dev, dtype=torch.int64)
    else:
        lvl = map_roi_levels(rois, L, finest_scale)

    sizes = [h * w for h, w in level_hw]
    offsets = [0]
    for s in sizes[:-1]:
        offsets.append(offsets[-1] + B * s)

    def tab(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=dev)[lvl]

    roi_scale = tab([1.0 / s for s in strides[:L]], torch.float32)
    roi_h = tab([float(h) for h, _ in level_hw], torch.float32)
    roi_w = tab([float(w) for _, w in level_hw], torch.float32)
    roi_off = tab(offsets, torch.int64)
    roi_sz = tab(sizes, torch.int64)

    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * roi_scale - offset
    y1 = rois[:, 1] * roi_scale - offset
    bw = _div((rois[:, 2] - rois[:, 0]) * roi_scale, output_size)
    bh = _div((rois[:, 3] - rois[:, 1]) * roi_scale, output_size)

    n = output_size * ss
    k = torch.arange(n, device=dev)
    gpos = (k // ss).float() + _div((k % ss).float() + 0.5, ss)
    ys = y1[:, None] + gpos[None, :] * bh[:, None]  # (R, n)
    xs = x1[:, None] + gpos[None, :] * bw[:, None]
    yy = ys[:, :, None].expand(R, n, n).reshape(R, -1)
    xx = xs[:, None, :].expand(R, n, n).reshape(R, -1)
    iy, ix, w = _bilinear_weights_indices(yy, xx, roi_h[:, None], roi_w[:, None])
    base = roi_off + batch_idx.to(device=dev, dtype=torch.int64) * roi_sz
    lin = base[:, None, None] + iy * roi_w.to(torch.int64)[:, None, None] + ix  # (R, P, 4)
    # corner order y0x0, y1x0, y0x1, y1x1 (the JAX package's packed order)
    perm = torch.tensor([0, 2, 1, 3], device=dev)
    return lin[..., perm], w[..., perm]


def multilevel_roi_align(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    batch_idx: torch.Tensor,
    strides: Sequence[int] = (4, 8, 16, 32),
    output_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
    aligned: bool = True,
    lvl_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """features: L NHWC maps (B, H_l, W_l, C); rois (R, 4); batch_idx (R,).

    Returns (R, output_size, output_size, C) f32 (callers cast).
    ``lvl_override`` replaces the routing with a given per-RoI level.
    """
    B, _, _, C = features[0].shape
    R = rois.shape[0]
    ss = sampling_ratio
    lin, w = sample_taps(
        [(f.shape[1], f.shape[2]) for f in features], B, rois, batch_idx, strides,
        output_size, ss, finest_scale, aligned, lvl_override,
    )
    flat = torch.cat([f.reshape(-1, C) for f in features], dim=0)
    out = torch.empty((R, output_size, output_size, C), dtype=torch.float32, device=rois.device)
    for r0 in range(0, R, ROI_CHUNK):
        r1 = min(r0 + ROI_CHUNK, R)
        rows = flat[lin[r0:r1].reshape(-1)].reshape(r1 - r0, -1, 4, C)
        sampled = (rows.float() * w[r0:r1, :, :, None]).sum(dim=2)  # (r, P, C)
        sampled = sampled.reshape(r1 - r0, output_size, ss, output_size, ss, C)
        out[r0:r1] = sampled.mean(dim=(2, 4))
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
    """Gradient of :func:`multilevel_roi_align` w.r.t. the level maps.

    g (R, output_size, output_size, C) → one (B, H_l, W_l, C) gradient
    per level of ``level_hw``, accumulated in f32 (``index_add_`` of every
    tap's share) and cast once to ``dtype``, as the JAX package's window
    backward does (roi_align_pallas.py:564,586). The op is linear in the
    features, so the gradient does not depend on them.
    """
    C = g.shape[-1]
    R = rois.shape[0]
    ss = sampling_ratio
    P = (output_size * ss) ** 2
    lin, w = sample_taps(level_hw, batch_size, rois, batch_idx, strides, output_size, ss,
                         finest_scale, aligned)
    sizes = [batch_size * h * wd for h, wd in level_hw]
    acc = torch.zeros((sum(sizes), C), dtype=torch.float32, device=g.device)
    # the mean over each bin's ss x ss samples: every sample gets g / (ss * ss)
    gs = g.float() / float(ss * ss)
    for r0 in range(0, R, ROI_CHUNK):
        r1 = min(r0 + ROI_CHUNK, R)
        gp = gs[r0:r1, :, None, :, None, :].expand(r1 - r0, output_size, ss, output_size, ss, C)
        contrib = gp.reshape(r1 - r0, P, 1, C) * w[r0:r1, :, :, None]  # (r, P, 4, C)
        acc.index_add_(0, lin[r0:r1].reshape(-1), contrib.reshape(-1, C))
    out, off = [], 0
    for (h, wd), n in zip(level_hw, sizes):
        out.append(acc[off:off + n].reshape(batch_size, h, wd, C).to(dtype))
        off += n
    return out


def roi_footprints(
    level_hw: Sequence[Tuple[int, int]],
    rois: torch.Tensor,
    strides: Sequence[int] = (4, 8, 16, 32),
    output_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
    aligned: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The binning rule of the backward kernel: each RoI's level (R,) and
    the rows and columns of that level its taps can reach, (R, 4) int64
    ``[y_lo, y_hi, x_lo, x_hi]`` inclusive: from the smallest to the
    largest corner index of its samples inside the map (zero-weight
    corners included, so every nonzero tap of :func:`sample_taps` lies
    inside), or ``[0, -1, 0, -1]`` when every sample of an axis lies
    outside. Sample coordinates as in :func:`sample_taps`."""
    L = len(level_hw)
    dev = rois.device
    rois = rois.float()
    ss = sampling_ratio
    lvl = map_roi_levels(rois, L, finest_scale)

    def tab(vals):
        return torch.tensor(vals, dtype=torch.float32, device=dev)[lvl]

    scale = tab([1.0 / s for s in strides[:L]])
    offset = 0.5 if aligned else 0.0
    n = output_size * ss
    k = torch.arange(n, device=dev)
    gpos = (k // ss).float() + _div((k % ss).float() + 0.5, ss)

    def axis(lo_edge, hi_edge, extent):
        size = extent[:, None]
        v = (lo_edge * scale - offset)[:, None] + gpos[None, :] * _div((hi_edge - lo_edge) * scale,
                                                                       output_size)[:, None]
        outside = (v < -1.0) | (v > size)
        v = torch.minimum(torch.clamp(v, min=0.0), size - 1.0)
        v0 = torch.floor(v)
        v1 = torch.minimum(v0 + 1.0, size - 1.0)
        lo = torch.where(outside, torch.iinfo(torch.int64).max, v0.long()).amin(1)
        hi = torch.where(outside, -1, v1.long()).amax(1)
        return lo, hi

    y_lo, y_hi = axis(rois[:, 1], rois[:, 3], tab([float(h) for h, _ in level_hw]))
    x_lo, x_hi = axis(rois[:, 0], rois[:, 2], tab([float(w) for _, w in level_hw]))
    box = torch.stack([y_lo, y_hi, x_lo, x_hi], 1)
    empty = (y_lo > y_hi) | (x_lo > x_hi)
    box[empty] = torch.tensor([0, -1, 0, -1], dtype=box.dtype, device=dev)
    return lvl, box

"""RoIPool (max pooling), the legacy C4 op.

Counterpart of nsgp_repre_tpu/ops/roi_pool.py (mmcv RoIPool; neither
package's main path calls it, it is kept for the inventory). Plain
PyTorch: no kernel in JAX either. Each output bin max-pools a fixed
``samples_per_bin`` x ``samples_per_bin`` grid of nearest-pixel taps,
which equals exact RoIPool where a bin spans at most that many pixels.
"""
from __future__ import annotations

import torch


def roi_pool(features: torch.Tensor, rois: torch.Tensor, batch_idx: torch.Tensor,
             output_size: int = 7, spatial_scale: float = 1.0,
             samples_per_bin: int = 4) -> torch.Tensor:
    """Max-pool RoI bins from an NHWC map.

    features (B, H, W, C); rois (R, 4) image coordinates; batch_idx (R,).
    Returns (R, output_size, output_size, C).
    """
    B, H, W, C = features.shape
    R = rois.shape[0]
    o, s = output_size, samples_per_bin
    x1 = torch.floor(rois[:, 0] * spatial_scale)
    y1 = torch.floor(rois[:, 1] * spatial_scale)
    x2 = torch.ceil(rois[:, 2] * spatial_scale)
    y2 = torch.ceil(rois[:, 3] * spatial_scale)
    bw = torch.clamp(x2 - x1, min=1.0) / o
    bh = torch.clamp(y2 - y1, min=1.0) / o
    # s taps per bin along each axis, at the centres of s equal parts
    k = torch.arange(o * s, dtype=torch.float32, device=rois.device)
    pos = torch.div(k, s, rounding_mode="floor") + (k % s + 0.5) / s
    ys = y1[:, None] + pos[None, :] * bh[:, None]
    xs = x1[:, None] + pos[None, :] * bw[:, None]
    iy = torch.clamp(torch.floor(ys), 0, H - 1).long()
    ix = torch.clamp(torch.floor(xs), 0, W - 1).long()
    flat = features.reshape(B * H * W, C)
    base = batch_idx.long()[:, None, None] * (H * W)
    lin = base + iy[:, :, None] * W + ix[:, None, :]  # (R, o*s, o*s)
    vals = flat[lin.reshape(-1)].reshape(R, o, s, o, s, C)
    return vals.amax(dim=(2, 4))

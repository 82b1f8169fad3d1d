"""NSGP: null-space projections from the old tasks' input covariances.

Counterpart of nsgp_repre_tpu/engine/nsgp.py (reference SGD_NSCL.py),
the port's own copy:
- the adaptive elbow threshold (SGD_NSCL.py:98-177: Gaussian smoothing
  σ=10 for dims >= 128, second differences, 3% boundary drop, argmax
  curvature, offset shift) and the fixed-threshold ablation
  (SGD_NSCL_NoAdaptive.py:157), in numpy;
- :func:`build_transforms`: each covariance decomposed on the host in
  float64 numpy (``np.linalg.eigh``, |eigenvalues| re-sorted descending
  as ``torch.svd`` orders them), the eigenvectors below the elbow kept,
  P = V_keep @ V_keepᵀ in float32, backbone projections divided by their
  Frobenius norm (SGD_NSCL.py:283);
- :func:`accumulate_cov`, the running sum over batches (cal_fea_in).

Covariances and projections are keyed by the JAX package's parameter
paths (``backbone/layer2_0/conv1/kernel``), the keys of its
``covariance.npz``; engine/optim.py::set_transforms takes them as they
are. models/layers.py::CovCollector gives the covariances under those
keys.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d


def adaptive_threshold_index(svals: np.ndarray, offset: float = 0.0) -> int:
    """Elbow index in a descending singular-value spectrum: indices >=
    the result are the null space (kept for the projection)."""
    points = np.asarray(svals, dtype=np.float64)
    if points.ndim != 1:
        raise ValueError(f"a 1-D spectrum expected, got shape {points.shape}")
    n = len(points)
    if n >= 128:
        fil = gaussian_filter1d(points, sigma=10)
        diff_o1 = fil[:-1] - fil[1:]
        diff_o2 = diff_o1[:-1] - diff_o1[1:]
        drop_num = int(n * 0.03 / 2)
        valid_o2 = diff_o2[drop_num:-drop_num]
        thres_val = points[int(np.argmax(valid_o2)) + int((n - len(valid_o2)) / 2)]
    else:
        diff_o1 = points[:-1] - points[1:]
        diff_o2 = diff_o1[:-1] - diff_o1[1:]
        thres_val = points[int(np.argmax(diff_o2)) + int((n - len(diff_o2)) / 2)]

    i_thres = int(np.arange(n)[points >= thres_val].max())
    if -1 <= offset <= 1:
        i_thres = min(i_thres + int(offset * i_thres), n - 1)
        i_thres = max(0, i_thres)
    else:
        i_thres = max(min(i_thres + int(offset), n - 1), 0)
    return i_thres


def null_space_mask(svals: np.ndarray, offset: float = 0.0) -> np.ndarray:
    """True for the kept (null-space) tail of the spectrum."""
    mask = np.zeros(len(svals), dtype=bool)
    mask[adaptive_threshold_index(svals, offset):] = True
    return mask


def fixed_threshold_mask(svals: np.ndarray, thres: float = 1.001) -> np.ndarray:
    """SGDNSCLNA ablation: ``eigen_value <= eigen_value[-1] * thres`` on the
    descending spectrum (its last entry is the smallest)."""
    svals = np.asarray(svals)
    return svals <= svals[-1] * thres


def build_transforms(
    cov_dict: Dict[str, object],
    offset: float = 0.0,
    ignore_patterns: Sequence[str] = (),
    adaptive: bool = True,
    fixed_thres: float = 1.001,
    logger=None,
) -> Dict[str, torch.Tensor]:
    """Covariance name → P = V_null @ V_nullᵀ, (C, C) float32 on the CPU.

    Names matching any of ``ignore_patterns`` (``re.match``, the
    reference's update_optim_transforms, nsrunner:634-662) are skipped;
    ``offset`` shifts the elbow; ``adaptive=False`` takes the fixed
    threshold. Covariances may be numpy arrays or tensors on any device.
    """
    out: Dict[str, torch.Tensor] = {}
    for name, cov in cov_dict.items():
        if any(re.match(p, name) for p in ignore_patterns):
            continue
        if isinstance(cov, torch.Tensor):
            cov = cov.detach().cpu().numpy()
        evals_h, evecs_h = np.linalg.eigh(np.asarray(cov, np.float64))
        # torch.svd of a symmetric matrix gives |eigenvalues| descending
        evals_abs = np.abs(evals_h)
        order = np.argsort(-evals_abs, kind="stable")
        evals_np = evals_abs[order]
        mask = null_space_mask(evals_np, offset) if adaptive else fixed_threshold_mask(evals_np,
                                                                                        fixed_thres)
        if logger is not None:
            kept = int(mask.sum())
            denom = evals_np[mask][0] if kept and evals_np[mask][0] > 0 else 1.0
            logger.info(
                f"{name}: reserving basis {kept}/{len(evals_np)}; "
                f"cond: {evals_np[0] / denom:.3e}, "
                f"energy ratio: {evals_np[mask].sum() / max(evals_np.sum(), 1e-30):.4f}"
            )
        basis = torch.from_numpy(np.ascontiguousarray(evecs_h[:, order[mask]], dtype=np.float32))
        transform = basis @ basis.T
        if "backbone" in name:
            # the norm accumulated in float64: torch's float32 norm of a
            # 1152² projection on the CPU is ~1e-4 off (JAX's is not)
            transform = transform / torch.linalg.norm(transform, dtype=torch.float64).float()
        out[name] = transform
    return out


def accumulate_cov(total: Optional[Dict[str, torch.Tensor]],
                   new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Running sum of covariance dicts (cal_fea_in accumulation)."""
    if total is None:
        return dict(new)
    return {k: total[k] + v for k, v in new.items()}

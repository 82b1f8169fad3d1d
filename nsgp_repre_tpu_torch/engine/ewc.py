"""EWC regularization on the BatchNorm affine parameters.

Counterpart of nsgp_repre_tpu/engine/ewc.py (reference
nsrunner_roi_replay.py: ``register_params`` :1006-1031,
``calculate_save_importance`` :946-990, ``EWCHook`` :1038-1073). Parameters
are dicts keyed by the port's parameter names (``dict(model.named_parameters())``
or a dict of their gradients).

The regularized set is the JAX package's: there a parameter is
regularized when its path holds "bn" (``is_ewc_param``), which names every
FrozenBatchNorm, the stem's, the bottlenecks' and the four
``layerK_0/downsample_bn``. The port's names for the last four are
``layerK.0.downsample.1`` (mmdet's), which hold no "bn", so
:func:`is_ewc_param` matches the port's names of that same set: 53 BN
modules, 106 tensors at R-50 depth, the frozen stem and layer1 included.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import torch

EWC_WEIGHT = 1000.0

_EWC_NAME = re.compile(r"backbone\.(bn1|layer\d+\.\d+\.(bn\d|downsample\.1))\.(weight|bias)")

Terms = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def is_ewc_param(name: str) -> bool:
    """Whether the port's parameter ``name`` is a FrozenBatchNorm scale or
    bias (the JAX package's "bn" in the path)."""
    return _EWC_NAME.fullmatch(name) is not None


def select_ewc_params(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in params.items() if is_ewc_param(k)}


def init_importance(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(v) for k, v in select_ewc_params(params).items()}


@torch.no_grad()
def accumulate_importance(importance: Dict[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                          batch_size: int, num_batches: int) -> Dict[str, torch.Tensor]:
    """importance += grad² * batch_size / num_batches (nsrunner:978-981)."""
    g = select_ewc_params(grads)
    scale = batch_size / num_batches
    return {k: importance[k] + g[k] ** 2 * scale for k in importance}


@torch.no_grad()
def append_task_terms(ewc_terms: Terms, importance: Dict[str, torch.Tensor],
                      params: Mapping[str, torch.Tensor]) -> Terms:
    """Stack this task's (importance, θ) onto the per-task axis."""
    cur = select_ewc_params(params)
    out = {}
    for k, imp in importance.items():
        new_imp, new_par = imp[None], cur[k].detach()[None].clone()
        if k in ewc_terms:
            old_imp, old_par = ewc_terms[k]
            new_imp = torch.cat([old_imp, new_imp])
            new_par = torch.cat([old_par, new_par])
        out[k] = (new_imp, new_par)
    return out


def ewc_loss(params: Mapping[str, torch.Tensor], ewc_terms: Terms) -> torch.Tensor:
    """1000 * Σ importance·(θ − θ_old)² over all tasks and BN parameters,
    differentiable in ``params``."""
    if not ewc_terms:
        return torch.zeros(())
    cur = select_ewc_params(params)
    total = None
    for k, (imp, old) in ewc_terms.items():
        term = (imp * (cur[k][None] - old) ** 2).sum()
        total = term if total is None else total + term
    return EWC_WEIGHT * total

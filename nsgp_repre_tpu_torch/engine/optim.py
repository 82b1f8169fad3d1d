"""Null-space-projected optimizers.

Counterpart of nsgp_repre_tpu/engine/optim.py (reference
mmdet/engine/optimizers/SGD_NSCL.py:59-96, Adam_NSCL.py:15,
AdamW_NSCL.py:15): SGD with momentum and weight decay, or Adam(W), whose
final update is right-multiplied by a per-parameter projection matrix P
(the null space of the old tasks' input covariance).

- On torch's (O, I, kh, kw) conv layout and (out, in) linear layout the
  projection is ``update.reshape(O, -1) @ P``, the reference's own form
  (SGD_NSCL.py:82-91); it equals JAX's ``P @ g`` on its transposed
  layout for a symmetric P.
- The step order and the float32 rounding points are those of
  ``sgd_nscl`` (optim.py:112-124) and ``adam_nscl`` (:168-178): L2 decay
  folded into the gradient (AdamW: decoupled decay on the update), a
  torch-style momentum buffer (first step: buf = grad), ``-lr * lr_mult``
  times the direction, then the projection. The learning rate is a
  schedule of the number of updates taken so far.
- JAX's ``masked`` (frozen leaves never change) becomes: frozen
  parameters get ``requires_grad_(False)`` and no optimizer entry
  (engine/runner.py::build_train_optimizer), as the reference freezes
  them (nsrunner:480-484). A trainable parameter without a gradient is
  stepped with a zero gradient, as JAX's dense gradient tree would be.
- Transforms are keyed by port parameter names; :func:`set_transforms`
  takes them keyed by JAX parameter paths (the NSGP artifacts' keys) and
  maps them with utils/convert.py::port_name_from_jax.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from ..models.layers import FrozenBatchNorm
from ..utils.convert import port_name_from_jax

Schedule = Union[float, Callable[[int], float]]
Mults = Dict[str, Tuple[float, float]]


def project_update(update: torch.Tensor, transform: Optional[torch.Tensor]) -> torch.Tensor:
    """Right-multiply a (reshaped-2D) update by its projection matrix."""
    if transform is None or update.dim() not in (2, 4):
        return update
    return (update.reshape(update.shape[0], -1) @ transform).reshape(update.shape)


def paramwise_mults(model: torch.nn.Module, paramwise_cfg: dict) -> Mults:
    """Per-parameter (lr_mult, decay_mult) from an mmengine
    ``paramwise_cfg`` (DefaultOptimWrapperConstructor semantics, the JAX
    ``paramwise_mults``): ``custom_keys`` match parameter names by
    substring, longest key first; ``norm_decay_mult`` sets the decay of
    the norm layers' parameters."""
    norm_wd = paramwise_cfg.get("norm_decay_mult")
    custom = paramwise_cfg.get("custom_keys", {}) or {}
    norm = {f"{mn}.{pn}" for mn, m in model.named_modules() if isinstance(m, FrozenBatchNorm)
            for pn, _ in m.named_parameters(recurse=False)}
    out: Mults = {}
    for name, _ in model.named_parameters():
        lr_m, wd_m = 1.0, 1.0
        for k in sorted(custom, key=len, reverse=True):
            if k in name:
                lr_m = float(custom[k].get("lr_mult", 1.0))
                wd_m = float(custom[k].get("decay_mult", 1.0))
                break
        if norm_wd is not None and name in norm:
            wd_m = float(norm_wd)
        out[name] = (lr_m, wd_m)
    return out


class _NSCL(torch.optim.Optimizer):
    """Named parameters, an lr schedule, per-parameter multipliers and
    projection transforms; subclasses define the direction."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 learning_rate: Schedule, mults: Optional[Mults], defaults: dict):
        named = list(named_params)
        super().__init__([p for _, p in named], defaults)
        self.names = {id(p): n for n, p in named}
        self.learning_rate = learning_rate
        self.mults = mults or {}
        self.transforms: Dict[str, torch.Tensor] = {}
        self.count = 0  # updates taken (JAX's state.count)

    def lr(self) -> np.float32:
        lr = self.learning_rate(self.count) if callable(self.learning_rate) else self.learning_rate
        return np.float32(lr)

    def _params(self, group):
        """(name, param, grad or zeros, lr_mult, decay_mult) of a group's entries."""
        for p in group["params"]:
            name = self.names[id(p)]
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            lm, wm = self.mults.get(name, (1.0, 1.0))
            yield name, p, g, lm, wm

    def _apply(self, name: str, p: torch.Tensor, update: torch.Tensor) -> None:
        p.add_(project_update(update, self.transforms.get(name)))


class SGDNSCL(_NSCL):
    """SGD+momentum with null-space projection of the final update
    (SGD_NSCL.get_update, :387-415)."""

    def __init__(self, named_params, learning_rate: Schedule, momentum: float = 0.9,
                 weight_decay: float = 1e-4, dampening: float = 0.0, nesterov: bool = False,
                 mults: Optional[Mults] = None):
        super().__init__(named_params, learning_rate, mults,
                         dict(momentum=momentum, weight_decay=weight_decay,
                              dampening=dampening, nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("closures are not supported")
        neg_lr = -self.lr()
        for group in self.param_groups:
            mom, wd = group["momentum"], group["weight_decay"]
            damp, nesterov = group["dampening"], group["nesterov"]
            for name, p, g, lm, wm in self._params(group):
                g = g + (wd * wm) * p
                state = self.state[p]
                if self.count == 0:
                    buf = g.clone()
                else:
                    buf = mom * state["momentum"] + (1.0 - damp) * g
                state["momentum"] = buf
                d = g + mom * buf if nesterov else buf
                self._apply(name, p, d * float(neg_lr * np.float32(lm)))
        self.count += 1


class AdamNSCL(_NSCL):
    """Adam (L2 decay folded into the gradient), or AdamW with
    ``decoupled_wd`` (AdamW_NSCL.py:87), with null-space projection."""

    def __init__(self, named_params, learning_rate: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 decoupled_wd: bool = False, mults: Optional[Mults] = None):
        super().__init__(named_params, learning_rate, mults,
                         dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                              decoupled_wd=decoupled_wd))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("closures are not supported")
        lr = self.lr()
        t = np.float32(self.count + 1)
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            wd, decoupled = group["weight_decay"], group["decoupled_wd"]
            bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
            bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
            for name, p, g, lm, wm in self._params(group):
                if wd and not decoupled:
                    g = g + (wd * wm) * p
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                mu = b1 * state["mu"] + (1 - b1) * g
                nu = b2 * state["nu"] + (1 - b2) * g * g
                state["mu"], state["nu"] = mu, nu
                lr_m = np.float32(lr * np.float32(lm))
                upd = float(-lr_m) * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                if wd and decoupled:
                    upd = upd - float(np.float32(np.float32(lr_m * np.float32(wd)) * np.float32(wm))) * p
                self._apply(name, p, upd)
        self.count += 1


def sgd_nscl(named_params, learning_rate: Schedule, momentum: float = 0.9,
             weight_decay: float = 1e-4, dampening: float = 0.0, nesterov: bool = False,
             mults: Optional[Mults] = None) -> SGDNSCL:
    """SGDNSCL over ``named_params`` ((name, parameter) pairs)."""
    return SGDNSCL(named_params, learning_rate, momentum, weight_decay, dampening, nesterov, mults)


def adam_nscl(named_params, learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 0.0, decoupled_wd: bool = False,
              mults: Optional[Mults] = None) -> AdamNSCL:
    """AdamNSCL (or AdamWNSCL with ``decoupled_wd``) over ``named_params``."""
    return AdamNSCL(named_params, learning_rate, b1, b2, eps, weight_decay, decoupled_wd, mults)


def set_transforms(optimizer: _NSCL, transforms: Dict[str, object], n_tasks: int) -> None:
    """Install projection matrices keyed by JAX parameter paths
    (``backbone/layer2_0/conv1/kernel``, as engine/nsgp.py builds them)
    for the optimizer's parameters; ``n_tasks`` places the background
    classifier (utils/convert.py). A path that names no parameter raises;
    one that names a frozen parameter (the stem and layer1 have
    covariances too) is dropped: it has no optimizer entry, as JAX masks
    its update to zero."""
    own = {n: p for group in optimizer.param_groups for p in group["params"]
           for n in [optimizer.names[id(p)]]}
    out = {}
    for key, P in transforms.items():
        name = port_name_from_jax(key, n_tasks)
        if name in own:
            out[name] = torch.as_tensor(np.asarray(P), dtype=torch.float32, device=own[name].device)
    optimizer.transforms = out

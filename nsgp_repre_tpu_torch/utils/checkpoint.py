"""Checkpoint and cross-task artifact I/O, in the JAX package's formats.

Counterpart of nsgp_repre_tpu/utils/checkpoint.py and
utils/torch_convert.py. The files are those of the JAX package, so a
work dir written by one package is a ``previous_dir`` or ``load_from``
for the other:
- model checkpoints (``epoch_N.npz``, ``best_mAP_epoch_N.npz``) and
  ``resume_state.npz``: one ``.npz`` keyed by '/'-joined JAX pytree paths
  (``params/backbone/conv1/kernel``, ``batch_stats/backbone/bn1/mean``),
  the arrays in JAX layouts (utils/convert.py);
- ``covariance.npz``: JAX parameter path → (C, C) input covariance;
- ``rois_etc.npz``: the six arrays of the RePRE RoI store (:data:`ROIS_KEYS`);
- ``ewc_reg_terms_ewc.npz``: ``imp::<path>`` and ``par::<path>`` per
  regularized parameter, keyed by JAX paths; the port's EWC terms are
  keyed by its own names, mapped on write and read;
- ``mask.pkl``: a pickle of per-class lists of numpy bool cluster masks.

Loading keeps JAX's ``restore_into`` semantics: entries of the file that
name nothing in the model are ignored, a model entry missing from the
file is allowed unless ``strict``, and a shape mismatch raises. A
``.pth``/``.pt`` file is a reference mmdet detector (loaded by name:
the port keeps mmdet's names) or a torchvision ResNet-50
(:func:`load_torch_backbone`).
"""
from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .convert import jax_flat_from_state_dict, jax_path_from_port, port_name_from_jax, \
    state_dict_from_jax


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# pytree checkpoints (model params / train state)
# ---------------------------------------------------------------------------

def save_flat(path: str, flat: Mapping[str, Any]) -> None:
    """Write a flat {path: array} dict as one .npz, in the order JAX's
    ``save_pytree`` writes a tree (sorted path by path)."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    np.savez(path, **{k: _np(flat[k]) for k in sorted(flat, key=lambda k: k.split("/"))})


def load_pytree_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def model_flat(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A model's state dict as a JAX checkpoint's entries:
    ``params/<path>`` and ``batch_stats/<path>/{mean,var}``."""
    params, stats = jax_flat_from_state_dict(dict(state))
    return {**{f"params/{k}": v for k, v in params.items()},
            **{f"batch_stats/{k}": v for k, v in stats.items()}}


def restore_state(model: torch.nn.Module, state: Mapping[str, torch.Tensor],
                  strict: bool = False) -> List[str]:
    """Load the entries of ``state`` that name this model's parameters and
    buffers; a shape mismatch raises, and so does a missing entry when
    ``strict``. Returns the model's entries that ``state`` lacks."""
    own = model.state_dict()
    keep = {}
    for k, v in state.items():
        if k not in own:
            continue
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} != model {tuple(own[k].shape)}")
        keep[k] = v
    if not keep:
        raise KeyError("the checkpoint holds no entry of this model")
    missing = [k for k in own if k not in keep]
    if strict and missing:
        raise KeyError(f"missing checkpoint entries: {missing[:10]} (+{max(len(missing) - 10, 0)})")
    model.load_state_dict(keep, strict=False)
    return missing


def _torch_state(path: str) -> Dict[str, torch.Tensor]:
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_checkpoint(model: torch.nn.Module, path: str, strict: bool = False) -> List[str]:
    """Restore a model from a JAX ``.npz`` checkpoint (``params/`` and
    ``batch_stats/`` entries in JAX layouts) or a reference mmdet
    ``.pth``/``.pt`` detector (by name). Returns the entries it lacked."""
    if path.endswith((".pth", ".pt")):
        return restore_state(model, _torch_state(path), strict)
    flat = load_pytree_flat(path)
    params = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    stats = {k[len("batch_stats/"):]: v for k, v in flat.items() if k.startswith("batch_stats/")}
    return restore_state(model, state_dict_from_jax(params, stats), strict)


def load_torch_backbone(model: torch.nn.Module, path: str) -> List[str]:
    """A torchvision-layout ResNet-50 state dict (``conv1.weight``,
    ``layer1.0.downsample.0.weight``, BN running statistics) into
    ``model.backbone``: the port's backbone names are mmdet's, which are
    torchvision's under ``backbone.``; the classifier (``fc.*``) is
    dropped. Returns the model's entries it lacked."""
    state = {f"backbone.{k}": v for k, v in _torch_state(path).items()
             if not k.startswith("fc.")}
    return restore_state(model, state)


def find_checkpoint(directory: str, keyword: str) -> Optional[str]:
    """First file in ``directory`` whose name contains ``keyword``
    (nsrunner:295-299 auto-scan semantics)."""
    if not osp.isdir(directory):
        return None
    for name in sorted(os.listdir(directory)):
        if keyword in name:
            return osp.join(directory, name)
    return None


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def save_covariance(work_dir: str, cov: Mapping[str, Any]) -> str:
    path = osp.join(work_dir, "covariance.npz")
    np.savez(path, **{k: _np(v) for k, v in cov.items()})
    return path


def load_covariance(work_dir: str) -> Dict[str, np.ndarray]:
    with np.load(osp.join(work_dir, "covariance.npz")) as z:
        return {k: z[k] for k in z.files}


ROIS_KEYS = ("bbox_feats", "cls_targets", "cls_weights", "bbox_targets", "bbox_weights", "rois")


def save_rois_etc(work_dir: str, arrays: Sequence[Any]) -> str:
    path = osp.join(work_dir, "rois_etc.npz")
    np.savez(path, **dict(zip(ROIS_KEYS, [_np(a) for a in arrays])))
    return path


def load_rois_etc(work_dir: str) -> Tuple[np.ndarray, ...]:
    with np.load(osp.join(work_dir, "rois_etc.npz")) as z:
        return tuple(z[k] for k in ROIS_KEYS)


def save_ewc_terms(work_dir: str, terms: Mapping[str, Tuple[Any, Any]], n_tasks: int) -> str:
    """Port-named EWC terms (engine/ewc.py) → the file's JAX-path keys;
    ``n_tasks``, the model's number of task heads, places ``fc_cls_bg``."""
    path = osp.join(work_dir, "ewc_reg_terms_ewc.npz")
    flat = {}
    for name in sorted(terms, key=lambda n: jax_path_from_port(n, n_tasks)):
        imp, par = terms[name]
        key = jax_path_from_port(name, n_tasks)
        flat[f"imp::{key}"] = _np(imp)
        flat[f"par::{key}"] = _np(par)
    np.savez(path, **flat)
    return path


def load_ewc_terms(work_dir: str, n_tasks: int) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The file's terms keyed by the port's parameter names."""
    with np.load(osp.join(work_dir, "ewc_reg_terms_ewc.npz")) as z:
        return {port_name_from_jax(k[5:], n_tasks): (z[k], z[f"par::{k[5:]}"])
                for k in z.files if k.startswith("imp::")}


def save_masks(work_dir: str, masks) -> str:
    path = osp.join(work_dir, "mask.pkl")
    with open(path, "wb") as f:
        pickle.dump([[np.asarray(m) for m in cls] for cls in masks], f)
    return path


def load_masks(work_dir: str):
    path = osp.join(work_dir, "mask.pkl")
    if not osp.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)

"""The weight bridge from the JAX package's checkpoints to the port.

The port's module names follow mmdet's state-dict names, so a reference
``.pth`` loads with ``load_state_dict``. A JAX checkpoint is a pair of
flat numpy dicts keyed like nsgp_repre_tpu/utils/checkpoint.py::
_flatten_tree (``backbone/layer1_0/conv1/kernel``, HWIO kernels, (in,
out) dense kernels). ``state_dict_from_jax`` maps those onto the port's
state dict; it is the exact inverse of
nsgp_repre_tpu/utils/torch_convert.py::convert_detector_state_dict. A
JAX gradient tree has the parameters' paths, so the same call maps
gradients name by name. :func:`port_name_from_jax` maps one parameter
path (the key of the NSGP transforms and covariances) to a port name, and
:func:`jax_path_from_port` maps a port name back.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

_BBOX = "roi_head.bbox_head"

# (JAX module path pattern, port module name template); first match wins
_MODULES: List[Tuple[str, Callable[[re.Match, int], str]]] = [
    (r"backbone/layer(\d+)_(\d+)/downsample_conv",
     lambda m, _: f"backbone.layer{m[1]}.{m[2]}.downsample.0"),
    (r"backbone/layer(\d+)_(\d+)/downsample_bn",
     lambda m, _: f"backbone.layer{m[1]}.{m[2]}.downsample.1"),
    (r"backbone/layer(\d+)_(\d+)/(conv\d|bn\d)",
     lambda m, _: f"backbone.layer{m[1]}.{m[2]}.{m[3]}"),
    (r"backbone/(conv1|bn1)", lambda m, _: f"backbone.{m[1]}"),
    (r"neck/lateral_conv(\d+)", lambda m, _: f"neck.lateral_convs.{m[1]}.conv"),
    (r"neck/fpn_conv(\d+)", lambda m, _: f"neck.fpn_convs.{m[1]}.conv"),
    (r"rpn_head/(rpn_conv|rpn_cls|rpn_reg)", lambda m, _: f"rpn_head.{m[1]}"),
    (r"bbox_head/shared_fc(\d+)", lambda m, _: f"{_BBOX}.shared_fcs.{int(m[1]) - 1}"),
    (r"bbox_head/fc_cls(\d+)", lambda m, _: f"{_BBOX}.fc_cls.{m[1]}"),
    # the reference appends the background classifier after the T
    # per-task heads (convfc_bbox_head_task.py:94-107)
    (r"bbox_head/fc_cls_bg", lambda m, n_tasks: f"{_BBOX}.fc_cls.{n_tasks}"),
    (r"bbox_head/fc_reg(\d+)", lambda m, _: f"{_BBOX}.fc_reg.{m[1]}"),
]

# the inverse of _MODULES: (port module name pattern, JAX module path template)
_JAX_MODULES: List[Tuple[str, Callable[[re.Match, int], str]]] = [
    (r"backbone\.layer(\d+)\.(\d+)\.downsample\.0",
     lambda m, _: f"backbone/layer{m[1]}_{m[2]}/downsample_conv"),
    (r"backbone\.layer(\d+)\.(\d+)\.downsample\.1",
     lambda m, _: f"backbone/layer{m[1]}_{m[2]}/downsample_bn"),
    (r"backbone\.layer(\d+)\.(\d+)\.(conv\d|bn\d)", lambda m, _: f"backbone/layer{m[1]}_{m[2]}/{m[3]}"),
    (r"backbone\.(conv1|bn1)", lambda m, _: f"backbone/{m[1]}"),
    (r"neck\.lateral_convs\.(\d+)\.conv", lambda m, _: f"neck/lateral_conv{m[1]}"),
    (r"neck\.fpn_convs\.(\d+)\.conv", lambda m, _: f"neck/fpn_conv{m[1]}"),
    (r"rpn_head\.(rpn_conv|rpn_cls|rpn_reg)", lambda m, _: f"rpn_head/{m[1]}"),
    (rf"{_BBOX}\.shared_fcs\.(\d+)", lambda m, _: f"bbox_head/shared_fc{int(m[1]) + 1}"),
    (rf"{_BBOX}\.fc_cls\.(\d+)",
     lambda m, n_tasks: "bbox_head/fc_cls_bg" if int(m[1]) == n_tasks else f"bbox_head/fc_cls{m[1]}"),
    (rf"{_BBOX}\.fc_reg\.(\d+)", lambda m, _: f"bbox_head/fc_reg{m[1]}"),
]

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _module_name(path: str, n_tasks: int) -> str:
    for pattern, name in _MODULES:
        m = re.fullmatch(pattern, path)
        if m:
            return name(m, n_tasks)
    raise KeyError(f"no port module for JAX path {path!r}")


def _to_torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return arr
    if arr.ndim == 4:  # (H, W, I, O) → (O, I, H, W)
        return np.transpose(arr, (3, 2, 0, 1))
    return np.transpose(arr, (1, 0))  # (in, out) → (out, in)


def port_name_from_jax(path: str, n_tasks: int) -> str:
    """JAX parameter path (``backbone/layer2_0/conv1/kernel``) → port
    parameter name (``backbone.layer2.0.conv1.weight``). ``n_tasks``, the
    number of task heads, places the background classifier."""
    module, leaf = path.rsplit("/", 1)
    if leaf not in _PARAM_LEAVES:
        raise KeyError(f"{path!r} is not a parameter path (leaf {leaf!r})")
    return f"{_module_name(module, n_tasks)}.{_PARAM_LEAVES[leaf]}"


def jax_path_from_port(name: str, n_tasks: int) -> str:
    """Port parameter name (``backbone.layer2.0.conv1.weight``) → JAX
    parameter path (``backbone/layer2_0/conv1/kernel``): the inverse of
    :func:`port_name_from_jax`. A norm's weight is JAX's ``scale``."""
    module, leaf = name.rsplit(".", 1)
    for pattern, path in _JAX_MODULES:
        m = re.fullmatch(pattern, module)
        if m:
            jax_module = path(m, n_tasks)
            break
    else:
        raise KeyError(f"no JAX module for port name {name!r}")
    if leaf == "bias":
        return f"{jax_module}/bias"
    if leaf != "weight":
        raise KeyError(f"{name!r} is not a parameter name (leaf {leaf!r})")
    norm = re.search(r"bn\d?$", jax_module) is not None
    return f"{jax_module}/{'scale' if norm else 'kernel'}"


def state_dict_from_jax(
    params_flat: Dict[str, np.ndarray], stats_flat: Dict[str, np.ndarray]
) -> Dict[str, torch.Tensor]:
    """Flat JAX params and batch stats → the port's (mmdet-named) state dict."""
    n_tasks = sum(bool(re.fullmatch(r"bbox_head/fc_cls\d+/kernel", k)) for k in params_flat)
    out: Dict[str, torch.Tensor] = {}
    for flat, leaves in ((params_flat, _PARAM_LEAVES), (stats_flat, _STAT_LEAVES)):
        for key, arr in flat.items():
            path, leaf = key.rsplit("/", 1)
            if leaf not in leaves:
                raise KeyError(f"unknown leaf {leaf!r} in {key!r}")
            name = f"{_module_name(path, n_tasks)}.{leaves[leaf]}"
            arr = _to_torch_layout(leaf, np.asarray(arr, dtype=np.float32))
            out[name] = torch.tensor(arr).contiguous()
    return out

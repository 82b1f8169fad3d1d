"""The weight bridge from the JAX package's checkpoints to the port.

The port's module names follow mmdet's state-dict names, so a reference
``.pth`` loads with ``load_state_dict``. A JAX checkpoint is a pair of
flat numpy dicts keyed like nsgp_repre_tpu/utils/checkpoint.py::
_flatten_tree (``backbone/layer1_0/conv1/kernel``, HWIO kernels, (in,
out) dense kernels). ``state_dict_from_jax`` maps those onto the port's
state dict; it is the exact inverse of
nsgp_repre_tpu/utils/torch_convert.py::convert_detector_state_dict. A
JAX gradient tree has the parameters' paths, so the same call maps
gradients name by name. :func:`jax_flat_from_state_dict` is its exact
inverse, the form the port writes its checkpoints in. The model zoo's
heads map too: a cascade's ``cascade_head{i}/*`` onto mmdet's
``roi_head.bbox_head.{i}.*`` and the mask head's ``mask_head/mask_conv{i}``,
``upsample`` and ``conv_logits`` onto ``roi_head.mask_head.convs.{i}.conv``,
``.upsample`` and ``.conv_logits``. Flax's ConvTranspose kernel (kh, kw,
in, out) is torch's ConvTranspose2d weight (in, out, kh, kw) with both
spatial axes flipped (flax convolves the dilated input with the kernel as
stored; torch scatters with it, which is the convolution with the
flipped kernel).
The rest of the zoo maps onto mmdet's names too: RetinaNet's towers
``bbox_head/{cls,reg}_conv{i}`` onto ``bbox_head.{cls,reg}_convs.{i}.conv``
and ``retina_{cls,reg}`` by name; the C4 head's res5
``bbox_head/shared_head/layer4_{b}/*`` onto
``roi_head.shared_head.layer4.{b}.*`` and its plain ``bbox_head/fc_cls``
and ``fc_reg`` (no task digit) onto ``roi_head.bbox_head.fc_cls`` and
``fc_reg``. SSD reuses two JAX names of other families with other
modules (``backbone/conv1`` is VGG's second conv, ``bbox_head/cls_conv0``
a level's classifier), so its paths map by a table of their own, chosen
when the parameters hold SSD's bare ``neck/l2_norm``
(``neck.l2_norm.weight``): the VGG convs ``backbone/conv{i}``, ``fc6``,
``fc7`` onto mmdet's ``backbone.features.{idx}``, the extra levels
``neck/extra{i}_{1,2}`` onto ``neck.extra_layers.{i}.{0,1}.conv``, the
head's ``bbox_head/{cls,reg}_conv{i}`` onto ``bbox_head.{cls,reg}_convs.{i}.0``.
:func:`port_name_from_jax` maps one parameter path (the key of the NSGP
transforms and covariances) to a port name, and
:func:`jax_path_from_port` maps a port name back.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

_BBOX = "roi_head.bbox_head"
_MASK = "roi_head.mask_head"
_SHARED = "roi_head.shared_head"
_UPSAMPLE = "mask_head/upsample"  # the one transposed conv
L2_NORM = ("neck/l2_norm", "neck.l2_norm.weight")  # SSD's bare parameter, both names

# SSD's VGG: mmdet's ``features`` index of JAX's conv{i} (13 convs, ReLUs and
# ceil-mode pools between them), fc6 and fc7 (ssd_vgg.py)
VGG_FEATURES = {**{f"conv{i}": idx for i, idx in enumerate(
    (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28))}, "fc6": 31, "fc7": 33}
_VGG_NAMES = {idx: name for name, idx in VGG_FEATURES.items()}

_SSD_MODULES: List[Tuple[str, Callable[[re.Match, int], str]]] = [
    (r"backbone/(conv\d+|fc6|fc7)", lambda m, _: f"backbone.features.{VGG_FEATURES[m[1]]}"),
    (r"neck/extra(\d+)_([12])", lambda m, _: f"neck.extra_layers.{m[1]}.{int(m[2]) - 1}.conv"),
    (r"bbox_head/(cls|reg)_conv(\d+)", lambda m, _: f"bbox_head.{m[1]}_convs.{m[2]}.0"),
]

# (JAX module path pattern, port module name template); first match wins
_MODULES: List[Tuple[str, Callable[[re.Match, int], str]]] = [
    (r"backbone/layer(\d+)_(\d+)/downsample_conv",
     lambda m, _: f"backbone.layer{m[1]}.{m[2]}.downsample.0"),
    (r"backbone/layer(\d+)_(\d+)/downsample_bn",
     lambda m, _: f"backbone.layer{m[1]}.{m[2]}.downsample.1"),
    (r"backbone/layer(\d+)_(\d+)/(conv\d|bn\d)",
     lambda m, _: f"backbone.layer{m[1]}.{m[2]}.{m[3]}"),
    (r"backbone/(conv1|bn1)", lambda m, _: f"backbone.{m[1]}"),
    (r"bbox_head/shared_head/layer(\d+)_(\d+)/downsample_conv",
     lambda m, _: f"{_SHARED}.layer{m[1]}.{m[2]}.downsample.0"),
    (r"bbox_head/shared_head/layer(\d+)_(\d+)/downsample_bn",
     lambda m, _: f"{_SHARED}.layer{m[1]}.{m[2]}.downsample.1"),
    (r"bbox_head/shared_head/layer(\d+)_(\d+)/(conv\d|bn\d)",
     lambda m, _: f"{_SHARED}.layer{m[1]}.{m[2]}.{m[3]}"),
    (r"bbox_head/(fc_cls|fc_reg)", lambda m, _: f"{_BBOX}.{m[1]}"),
    (r"bbox_head/(cls|reg)_conv(\d+)", lambda m, _: f"bbox_head.{m[1]}_convs.{m[2]}.conv"),
    (r"bbox_head/(retina_cls|retina_reg)", lambda m, _: f"bbox_head.{m[1]}"),
    (r"neck/lateral_conv(\d+)", lambda m, _: f"neck.lateral_convs.{m[1]}.conv"),
    (r"neck/fpn_conv(\d+)", lambda m, _: f"neck.fpn_convs.{m[1]}.conv"),
    (r"rpn_head/(rpn_conv|rpn_cls|rpn_reg)", lambda m, _: f"rpn_head.{m[1]}"),
    (r"bbox_head/shared_fc(\d+)", lambda m, _: f"{_BBOX}.shared_fcs.{int(m[1]) - 1}"),
    (r"bbox_head/fc_cls(\d+)", lambda m, _: f"{_BBOX}.fc_cls.{m[1]}"),
    # the reference appends the background classifier after the T
    # per-task heads (convfc_bbox_head_task.py:94-107)
    (r"bbox_head/fc_cls_bg", lambda m, n_tasks: f"{_BBOX}.fc_cls.{n_tasks}"),
    (r"bbox_head/fc_reg(\d+)", lambda m, _: f"{_BBOX}.fc_reg.{m[1]}"),
    (r"cascade_head(\d+)/shared_fc(\d+)",
     lambda m, _: f"{_BBOX}.{m[1]}.shared_fcs.{int(m[2]) - 1}"),
    (r"cascade_head(\d+)/fc_cls(\d+)", lambda m, _: f"{_BBOX}.{m[1]}.fc_cls.{m[2]}"),
    (r"cascade_head(\d+)/fc_cls_bg", lambda m, n_tasks: f"{_BBOX}.{m[1]}.fc_cls.{n_tasks}"),
    (r"cascade_head(\d+)/fc_reg(\d+)", lambda m, _: f"{_BBOX}.{m[1]}.fc_reg.{m[2]}"),
    (r"mask_head/mask_conv(\d+)", lambda m, _: f"{_MASK}.convs.{m[1]}.conv"),
    (r"mask_head/(upsample|conv_logits)", lambda m, _: f"{_MASK}.{m[1]}"),
]

# the inverse of _MODULES: (port module name pattern, JAX module path template)
_JAX_MODULES: List[Tuple[str, Callable[[re.Match, int], str]]] = [
    (r"backbone\.layer(\d+)\.(\d+)\.downsample\.0",
     lambda m, _: f"backbone/layer{m[1]}_{m[2]}/downsample_conv"),
    (r"backbone\.layer(\d+)\.(\d+)\.downsample\.1",
     lambda m, _: f"backbone/layer{m[1]}_{m[2]}/downsample_bn"),
    (r"backbone\.layer(\d+)\.(\d+)\.(conv\d|bn\d)", lambda m, _: f"backbone/layer{m[1]}_{m[2]}/{m[3]}"),
    (r"backbone\.(conv1|bn1)", lambda m, _: f"backbone/{m[1]}"),
    (r"backbone\.features\.(\d+)", lambda m, _: f"backbone/{_VGG_NAMES[int(m[1])]}"),
    (rf"{_SHARED}\.layer(\d+)\.(\d+)\.downsample\.0",
     lambda m, _: f"bbox_head/shared_head/layer{m[1]}_{m[2]}/downsample_conv"),
    (rf"{_SHARED}\.layer(\d+)\.(\d+)\.downsample\.1",
     lambda m, _: f"bbox_head/shared_head/layer{m[1]}_{m[2]}/downsample_bn"),
    (rf"{_SHARED}\.layer(\d+)\.(\d+)\.(conv\d|bn\d)",
     lambda m, _: f"bbox_head/shared_head/layer{m[1]}_{m[2]}/{m[3]}"),
    (rf"{_BBOX}\.(fc_cls|fc_reg)", lambda m, _: f"bbox_head/{m[1]}"),
    (r"bbox_head\.(cls|reg)_convs\.(\d+)\.(?:conv|0)", lambda m, _: f"bbox_head/{m[1]}_conv{m[2]}"),
    (r"bbox_head\.(retina_cls|retina_reg)", lambda m, _: f"bbox_head/{m[1]}"),
    (r"neck\.extra_layers\.(\d+)\.([01])\.conv", lambda m, _: f"neck/extra{m[1]}_{int(m[2]) + 1}"),
    (r"neck\.lateral_convs\.(\d+)\.conv", lambda m, _: f"neck/lateral_conv{m[1]}"),
    (r"neck\.fpn_convs\.(\d+)\.conv", lambda m, _: f"neck/fpn_conv{m[1]}"),
    (r"rpn_head\.(rpn_conv|rpn_cls|rpn_reg)", lambda m, _: f"rpn_head/{m[1]}"),
    (rf"{_BBOX}\.shared_fcs\.(\d+)", lambda m, _: f"bbox_head/shared_fc{int(m[1]) + 1}"),
    (rf"{_BBOX}\.fc_cls\.(\d+)",
     lambda m, n_tasks: "bbox_head/fc_cls_bg" if int(m[1]) == n_tasks else f"bbox_head/fc_cls{m[1]}"),
    (rf"{_BBOX}\.fc_reg\.(\d+)", lambda m, _: f"bbox_head/fc_reg{m[1]}"),
    (rf"{_BBOX}\.(\d+)\.shared_fcs\.(\d+)",
     lambda m, _: f"cascade_head{m[1]}/shared_fc{int(m[2]) + 1}"),
    (rf"{_BBOX}\.(\d+)\.fc_cls\.(\d+)",
     lambda m, n_tasks: f"cascade_head{m[1]}/fc_cls_bg" if int(m[2]) == n_tasks
     else f"cascade_head{m[1]}/fc_cls{m[2]}"),
    (rf"{_BBOX}\.(\d+)\.fc_reg\.(\d+)", lambda m, _: f"cascade_head{m[1]}/fc_reg{m[2]}"),
    (rf"{_MASK}\.convs\.(\d+)\.conv", lambda m, _: f"mask_head/mask_conv{m[1]}"),
    (rf"{_MASK}\.(upsample|conv_logits)", lambda m, _: f"mask_head/{m[1]}"),
]

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _module_name(path: str, n_tasks: int, ssd: bool = False) -> str:
    for pattern, name in (_SSD_MODULES if ssd else []) + _MODULES:
        m = re.fullmatch(pattern, path)
        if m:
            return name(m, n_tasks)
    raise KeyError(f"no port module for JAX path {path!r}")


def _to_torch_layout(path: str, leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return arr
    if path == _UPSAMPLE:  # (H, W, I, O) → (I, O, H, W), flipped in H and W
        return np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    if arr.ndim == 4:  # (H, W, I, O) → (O, I, H, W)
        return np.transpose(arr, (3, 2, 0, 1))
    return np.transpose(arr, (1, 0))  # (in, out) → (out, in)


def _to_jax_layout(path: str, arr: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_to_torch_layout` for a ``kernel`` leaf."""
    if path == f"{_UPSAMPLE}/kernel":
        return np.ascontiguousarray(np.transpose(arr[:, :, ::-1, ::-1], (2, 3, 0, 1)))
    return np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)) if arr.ndim == 4 else arr.T)


def port_name_from_jax(path: str, n_tasks: int) -> str:
    """JAX parameter path (``backbone/layer2_0/conv1/kernel``) → port
    parameter name (``backbone.layer2.0.conv1.weight``). ``n_tasks``, the
    number of task heads, places the background classifier."""
    module, leaf = path.rsplit("/", 1)
    if leaf not in _PARAM_LEAVES:
        raise KeyError(f"{path!r} is not a parameter path (leaf {leaf!r})")
    return f"{_module_name(module, n_tasks)}.{_PARAM_LEAVES[leaf]}"


def _jax_module(module: str, n_tasks: int) -> str:
    for pattern, path in _JAX_MODULES:
        m = re.fullmatch(pattern, module)
        if m:
            return path(m, n_tasks)
    raise KeyError(f"no JAX module for port module {module!r}")


def jax_path_from_port(name: str, n_tasks: int) -> str:
    """Port parameter name (``backbone.layer2.0.conv1.weight``) → JAX
    parameter path (``backbone/layer2_0/conv1/kernel``): the inverse of
    :func:`port_name_from_jax`. A norm's weight is JAX's ``scale``."""
    if name == L2_NORM[1]:
        return L2_NORM[0]
    module, leaf = name.rsplit(".", 1)
    jax_module = _jax_module(module, n_tasks)
    if leaf == "bias":
        return f"{jax_module}/bias"
    if leaf != "weight":
        raise KeyError(f"{name!r} is not a parameter name (leaf {leaf!r})")
    norm = re.search(r"bn\d?$", jax_module) is not None
    return f"{jax_module}/{'scale' if norm else 'kernel'}"


def n_tasks_of(state: Dict[str, object]) -> int:
    """The number of task heads of a port state dict: one ``fc_reg`` each,
    or, for a cascade (class-agnostic regression), the first stage's
    ``fc_cls`` less the background one."""
    cascade = {k for k in state if re.fullmatch(rf"{_BBOX}\.0\.fc_cls\.\d+\.weight", k)}
    if cascade:
        return len(cascade) - 1
    return sum(bool(re.fullmatch(rf"{_BBOX}\.fc_reg\.\d+\.weight", k)) for k in state)


def jax_flat_from_state_dict(
    state: Dict[str, torch.Tensor]
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The port's state dict (or a dict of tensors keyed by its parameter
    names, such as optimizer slots) → flat JAX params and batch stats as
    numpy arrays in JAX layouts (HWIO conv kernels, (in, out) dense
    kernels, BN ``scale``): the exact inverse of :func:`state_dict_from_jax`."""
    n_tasks = n_tasks_of(state)
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    for name, t in state.items():
        arr = t.detach().cpu().numpy()
        module, leaf = name.rsplit(".", 1)
        if leaf in ("running_mean", "running_var"):
            stats[f"{_jax_module(module, n_tasks)}/{leaf[len('running_'):]}"] = arr
            continue
        path = jax_path_from_port(name, n_tasks)
        if path.endswith("/kernel"):
            arr = _to_jax_layout(path, arr)
        params[path] = arr
    return params, stats


def state_dict_from_jax(
    params_flat: Dict[str, np.ndarray], stats_flat: Dict[str, np.ndarray]
) -> Dict[str, torch.Tensor]:
    """Flat JAX params and batch stats → the port's (mmdet-named) state dict."""
    n_tasks = sum(bool(re.fullmatch(r"(bbox_head|cascade_head0)/fc_cls\d+/kernel", k))
                  for k in params_flat)
    ssd = L2_NORM[0] in params_flat
    out: Dict[str, torch.Tensor] = {}
    for flat, leaves in ((params_flat, _PARAM_LEAVES), (stats_flat, _STAT_LEAVES)):
        for key, arr in flat.items():
            if key == L2_NORM[0] and flat is params_flat:
                out[L2_NORM[1]] = torch.tensor(np.asarray(arr, dtype=np.float32))
                continue
            path, leaf = key.rsplit("/", 1)
            if leaf not in leaves:
                raise KeyError(f"unknown leaf {leaf!r} in {key!r}")
            name = f"{_module_name(path, n_tasks, ssd)}.{leaves[leaf]}"
            arr = _to_torch_layout(path, leaf, np.asarray(arr, dtype=np.float32))
            out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out

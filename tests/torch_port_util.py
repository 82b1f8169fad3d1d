"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Builds a small JAX detector, perturbs its weights so scores separate
(random BN statistics and affine terms, classifier weights scaled up, as
tests/test_full_parity.py does), and loads the same weights into the
PyTorch port through the weight bridge. Inputs are numpy arrays made
from seeds; both sides see the same numbers.
"""
from __future__ import annotations

import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nsgp_repre_tpu.models.detector import DetectorConfig, FasterRCNN
from nsgp_repre_tpu.structures.sample import DetBatch, InstanceArray
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree, restore_into

from nsgp_repre_tpu_torch.models import detector as tdet
from nsgp_repre_tpu_torch.structures import sample as tsample
from nsgp_repre_tpu_torch.utils.convert import state_dict_from_jax

# a small detector: R-18-depth trunk (one bottleneck per stage), short
# proposal and detection lists, exact top-k and reference RoI routing
SMALL = dict(
    num_classes=6,
    task_split=(0, 4, 6),
    task_id=1,
    backbone_blocks=(1, 1, 1, 1),
    rpn_nms_pre=256,
    rpn_max_per_img=96,
    max_per_img=24,
    use_approx_topk=False,
    roi_align_mode="gather",
)


def perturb(params_flat, stats_flat, seed=0, cls_scale=5.0):
    """Random BN statistics/affine terms and scaled classifier weights."""
    rng = np.random.RandomState(seed)
    params = dict(params_flat)
    stats = dict(stats_flat)
    for k, v in params.items():
        if "/bn" in k or "downsample_bn" in k:
            if k.endswith("/scale"):
                params[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k.endswith("/bias"):
                params[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        elif "/fc_cls" in k and k.endswith("/kernel"):
            params[k] = (v * cls_scale).astype(np.float32)
        elif k == "bbox_head/retina_cls/bias":
            # RetinaNet's prior bias puts every score near 0.01, under the
            # 0.05 score threshold: spread the classes' biases around it
            params[k] = rng.uniform(-3.0, 0.0, v.shape).astype(np.float32)
    for k, v in stats.items():
        if k.endswith("/mean"):
            stats[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        else:
            stats[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return params, stats


def jax_and_port(image_hw=(64, 96), seed=0, jit_init=False, **overrides):
    """(JAX model, JAX variables, port model) with the same weights.
    ``jit_init`` runs the JAX init compiled (~6 s against ~23 s eager; the
    initial weights differ from the eager ones in their last bits)."""
    kw = dict(SMALL, **overrides)
    model = FasterRCNN(config=DetectorConfig(**kw))
    init = jax.jit(model.init) if jit_init else model.init
    variables = init(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + tuple(image_hw) + (3,), jnp.float32)
    )
    params_flat, stats_flat = perturb(
        _flatten_tree(variables["params"]), _flatten_tree(variables["batch_stats"]), seed
    )
    variables = {
        "params": restore_into(variables["params"], params_flat),
        "batch_stats": restore_into(variables["batch_stats"], stats_flat),
    }
    port = tdet.FasterRCNN(tdet.DetectorConfig(**kw))
    port.load_state_dict(state_dict_from_jax(params_flat, stats_flat), strict=True)
    return model, variables, port.eval()


def images(shape, seed=0):
    """Seeded uint8 RGB images (B, H, W, 3), smooth enough to give the
    detector structure to respond to."""
    rng = np.random.RandomState(seed)
    B, H, W = shape
    coarse = rng.randint(0, 255, (B, H // 8 + 1, W // 8 + 1, 3)).astype(np.float32)
    img = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)[:, :H, :W]
    img += rng.randn(B, H, W, 3).astype(np.float32) * 20.0
    return np.clip(img, 0, 255).astype(np.uint8)


def batches(imgs, img_shape=None, scale_factor=None):
    """The same batch for JAX (DetBatch of jnp arrays) and the port."""
    B, H, W = imgs.shape[:3]
    shp = np.tile(np.array([[H, W]], np.int32), (B, 1)) if img_shape is None else img_shape
    sf = np.ones((B, 2), np.float32) if scale_factor is None else scale_factor
    cap = 1
    jb = DetBatch(
        images=jnp.asarray(imgs),
        img_shape=jnp.asarray(shp),
        ori_shape=jnp.asarray(shp),
        scale_factor=jnp.asarray(sf),
        gt=InstanceArray(
            boxes=jnp.zeros((B, cap, 4), jnp.float32),
            labels=jnp.full((B, cap), -1, jnp.int32),
            valid=jnp.zeros((B, cap), bool),
        ),
    )
    tb = tsample.DetBatch(
        images=torch.from_numpy(imgs),
        img_shape=torch.from_numpy(shp),
        ori_shape=torch.from_numpy(shp),
        scale_factor=torch.from_numpy(sf),
        gt=tsample.InstanceArray(
            boxes=torch.zeros((B, cap, 4)),
            labels=torch.full((B, cap), -1, dtype=torch.int32),
            valid=torch.zeros((B, cap), dtype=torch.bool),
        ),
    )
    return jb, tb


def f32_matmuls():
    """Full-f32 products on every device (guide §6): TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def loss_priorities(rng, cfg, batch_size, hw, gt_slots):
    """JAX's sampling draws in FasterRCNN.loss, as the port takes them:
    split(rng) → k1 (RPN: one key per image, uniform over the anchors) and
    k2 (RoI head: one key per image, u over the gt slots + proposals, u2
    from fold_in(key, 1)). ``gt_slots`` is the RoI gt set's capacity (the
    teacher's detections included on task 2)."""
    A = cfg.num_base_priors
    N = sum(-(-hw[0] // s) * -(-hw[1] // s) * A for s in cfg.anchor_strides)
    n = gt_slots + cfg.rpn_max_per_img
    k1, k2 = jax.random.split(rng)
    rpn = [jax.random.uniform(k, (N,)) for k in jax.random.split(k1, batch_size)]
    roi_keys = jax.random.split(k2, batch_size)
    roi = [jax.random.uniform(k, (n,)) for k in roi_keys]
    roi2 = [jax.random.uniform(jax.random.fold_in(k, 1), (n,)) for k in roi_keys]
    return {name: torch.from_numpy(np.stack([np.asarray(x) for x in v]))
            for name, v in (("rpn", rpn), ("roi", roi), ("roi2", roi2))}


def port_instances(inst):
    """A JAX InstanceArray as the port's (numpy copies on the CPU)."""
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))  # noqa: E731
    return tsample.InstanceArray(boxes=t(inst.boxes), labels=t(inst.labels), valid=t(inst.valid),
                                 scores=t(inst.scores))


# the ReLUs on the gradient path whose inputs both sides can record: the
# bottlenecks of layer2 on (the stem and layer1 are frozen and cut from the
# gradient) and of the C4 head's res5, the bbox head's two shared FCs, the
# mask head's convs, RetinaNet's towers, and SSD's VGG convs and extra
# levels. The sparse RPN head's hidden ReLU is computed inside a method on
# the JAX side and is not recorded here.
_BN_NAMES = ("bn1", "bn2", "bn3", "downsample_bn")
_FC_NAMES = ("shared_fc1", "shared_fc2")
_VGG_NAMES = tuple(f"conv{i}" for i in range(13)) + ("fc6", "fc7")


def capture_relu_inputs(module, method_name):
    """capture_intermediates filter for :func:`jax_relu_inputs`."""
    name = module.name or ""
    return (name in _BN_NAMES or name in _FC_NAMES or name in _VGG_NAMES
            or name.startswith(("layer", "mask_conv", "cls_conv", "reg_conv", "extra"))
            or name == "upsample")


def _block_relus(out, tree, prefix, skip):
    """The bottleneck ReLUs of the ``layer{s}_{b}`` blocks in ``tree``:
    bn1 and bn2 outputs, bn3 output plus the identity (downsample_bn
    output, else the previous block's output); blocks whose name starts
    with ``skip`` are left out."""
    blocks = sorted((k for k in tree if k.startswith("layer")),
                    key=lambda k: tuple(int(x) for x in k[5:].split("_")))
    prev = None
    for blk in blocks:
        d = tree[blk]
        if not (skip and blk.startswith(skip)):
            ident = d["downsample_bn"]["__call__"][0] if "downsample_bn" in d else prev
            for i, pre in ((1, d["bn1"]["__call__"][0]), (2, d["bn2"]["__call__"][0]),
                           (3, d["bn3"]["__call__"][0] + ident)):
                out.setdefault(f"{prefix}{blk}/relu{i}", []).append(np.asarray(pre))
        prev = d["__call__"][0]


def _calls(out, key, d):
    out.setdefault(key, []).extend(np.asarray(x) for x in d["__call__"])


def jax_relu_inputs(intermediates):
    """{ReLU: [its input at each call, NHWC or (rows, units)]} from the
    intermediates that capture_relu_inputs captured (a list of applies'
    captures): the bottlenecks' (backbone from layer2, the C4 head's
    res5), the shared FCs' outputs, the mask head's, RetinaNet's tower
    convs' (each level a call), SSD's VGG convs' and extra levels'."""
    out = {}
    for inter in intermediates:
        bb = inter.get("backbone", {})
        _block_relus(out, bb, "", "layer1_")
        if "fc6" in bb:  # SSD's VGG (a ResNet's stem is a conv1 too, with no ReLU recorded)
            for name in _VGG_NAMES:
                _calls(out, f"backbone/{name}", bb[name])
        for name, d in sorted(inter.get("neck", {}).items()):
            if name.startswith("extra"):
                _calls(out, f"neck/{name}", d)
        if "mask_head" in inter:
            for name, d in inter["mask_head"].items():
                _calls(out, f"mask_head/{name}", d)
        for head in sorted(k for k in inter if k == "bbox_head" or k.startswith("cascade_head")):
            h = inter[head]
            for n in _FC_NAMES:
                if n in h:
                    _calls(out, f"{head}/{n}", h[n])
            if "shared_head" in h:
                _block_relus(out, h["shared_head"], "shared_head/", None)
            if "fc6" not in bb:  # RetinaNet's towers; SSD's cls/reg convs have no ReLU
                for name, d in sorted(h.items()):
                    if name.startswith(("cls_conv", "reg_conv")):
                        _calls(out, f"bbox_head/{name}", d)
    return out


def _port_heads(port):
    """(JAX head name, port bbox head) of every bbox head of ``port``: the
    task head, or a cascade's stages."""
    heads = port._bbox_heads()
    if len(heads) == 1 and port.roi_head.bbox_head is heads[0]:
        return [("bbox_head", heads[0])]
    return [(f"cascade_head{i}", h) for i, h in enumerate(heads)]


class PortReluInputs:
    """Records, while entered, the port's inputs of the ReLUs that
    :func:`jax_relu_inputs` reads, keyed and laid out as it keys them."""

    def __init__(self, port):
        self.port = port
        self.out = {}

    def _add(self, key, t):
        if t.dim() == 4:
            t = t.permute(0, 2, 3, 1)
        self.out.setdefault(key, []).append(t.detach().float().numpy().copy())

    def _block_hooks(self, owner, stages, prefix):
        hooks = []
        for stage in stages:
            for i, blk in enumerate(getattr(owner, stage)):
                key = f"{prefix}{stage}_{i}"
                seen = {}
                hooks += [
                    blk.bn1.register_forward_hook(
                        lambda m, a, y, k=key: self._add(f"{k}/relu1", y)),
                    blk.bn2.register_forward_hook(
                        lambda m, a, y, k=key: self._add(f"{k}/relu2", y)),
                    blk.bn3.register_forward_hook(lambda m, a, y, s=seen: s.update(y3=y)),
                    blk.register_forward_pre_hook(lambda m, a, s=seen: s.update(x=a[0])),
                ]
                if blk.downsample is not None:
                    hooks.append(blk.downsample.register_forward_hook(
                        lambda m, a, y, s=seen: s.update(ident=y)))
                hooks.append(blk.register_forward_hook(
                    lambda m, a, y, k=key, s=seen, ds=blk.downsample is not None: self._add(
                        f"{k}/relu3", s["y3"] + (s["ident"] if ds else s["x"]))))
        return hooks

    def _output_hook(self, module, key):
        return module.register_forward_hook(lambda m, a, y, k=key: self._add(k, y))

    def __enter__(self):
        from nsgp_repre_tpu_torch.utils.convert import VGG_FEATURES

        port, bb = self.port, self.port.backbone
        hooks = self._block_hooks(bb, getattr(bb, "stage_names", [])[1:], "")
        if hasattr(bb, "features"):  # SSD's VGG and extra levels
            hooks += [self._output_hook(bb.features[idx], f"backbone/{name}")
                      for name, idx in VGG_FEATURES.items()]
            hooks += [self._output_hook(conv.conv, f"neck/extra{i}_{j + 1}")
                      for i, layer in enumerate(port.neck.extra_layers)
                      for j, conv in enumerate(layer)]
        head = getattr(port, "bbox_head", None)
        if hasattr(head, "retina_cls"):
            hooks += [self._output_hook(m.conv, f"bbox_head/{kind}_conv{i}")
                      for kind in ("cls", "reg")
                      for i, m in enumerate(getattr(head, f"{kind}_convs"))]
        roi_head = getattr(port, "roi_head", None)
        if hasattr(roi_head, "shared_head"):
            hooks += self._block_hooks(roi_head.shared_head, ["layer4"], "shared_head/")
        if hasattr(roi_head, "mask_head"):
            mh = self.port.roi_head.mask_head
            for name, m in [(f"mask_conv{i}", c.conv) for i, c in enumerate(mh.convs)] + [
                    ("upsample", mh.upsample)]:
                hooks.append(m.register_forward_hook(
                    lambda m, a, y, k=f"mask_head/{name}": self._add(k, y)))
        for head, bbox_head in (_port_heads(port) if roi_head is not None else []):
            for n, fc in zip(_FC_NAMES, bbox_head.shared_fcs):
                hooks.append(fc.register_forward_hook(
                    lambda m, a, y, k=f"{head}/{n}": self._add(k, y)))
        self.hooks = hooks
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def relu_flips(jax_in, port_in):
    """{ReLU: (flips, positions)} over the inputs both sides recorded, call
    by call, element by element: a flip is an input the two sides put on
    opposite sides of zero (a near-tie that two f32 summation orders
    decide differently, ROADMAP.md queue 3); positions are the rows the
    ReLU sees per channel (all calls)."""
    assert set(jax_in) == set(port_in), (sorted(jax_in), sorted(port_in))
    out = {}
    for key in jax_in:
        assert len(jax_in[key]) == len(port_in[key]), key
        flips = positions = 0
        for a, b in zip(jax_in[key], port_in[key]):
            assert a.shape == b.shape, (key, a.shape, b.shape)
            flips += int(((a > 0) != (b > 0)).sum())
            positions += int(np.prod(a.shape[:-1]))
        out[key] = (flips, positions)
    return out


def n_flips(flips):
    return sum(n for n, _ in flips.values())


def _block_of(name):
    """(stage, block) of a port backbone parameter; the stem is (0, 0)."""
    parts = name.split(".")
    if parts[1].startswith("layer"):
        return int(parts[1][5:]), int(parts[2])
    return 0, 0


def flip_slack(flips, name):
    """The relative gradient allowance of port parameter ``name`` for the
    ReLU flips upstream of it: 2 / sqrt(positions) per flip, one
    position's term against a sum over the ReLU's positions (sums that
    partly cancel, so the share is taken as 1 / sqrt, not 1 / positions).
    A flip moves only the gradients of the parameters before its ReLU."""
    slack = 0.0
    for key, (n, positions) in flips.items():
        if not n:
            continue
        if key.startswith("shared_head/"):  # the C4 head's res5 blocks
            blk = int(key.split("/")[1].split("_")[1])
            upstream = name.startswith("backbone.") or (
                name.startswith("roi_head.shared_head.layer4.")
                and int(name.split(".")[3]) <= blk)
        elif key.startswith(("bbox_head/cls_conv", "bbox_head/reg_conv")):  # RetinaNet's towers
            kind, i = key[10:13], int(key.split("conv")[-1])
            upstream = name.startswith(("backbone.", "neck.")) or (
                name.startswith(f"bbox_head.{kind}_convs.") and int(name.split(".")[2]) <= i)
        elif key.startswith("backbone/") and key[9:] in _VGG_NAMES:  # SSD's VGG
            from nsgp_repre_tpu_torch.utils.convert import VGG_FEATURES

            upstream = name.startswith("backbone.features.") and \
                int(name.split(".")[2]) <= VGG_FEATURES[key[9:]]
        elif key.startswith("neck/extra"):  # SSD's extra levels
            i, j = (int(x) for x in key[10:].split("_"))
            upstream = name.startswith("backbone.") or (
                name.startswith("neck.extra_layers.")
                and tuple(int(x) for x in name.split(".")[2:4]) <= (i, j - 1))
        elif key.startswith("mask_head/"):
            # the convs up to this ReLU's (the upsample's: all of them)
            last = int(key[19:]) if key.startswith("mask_head/mask_conv") else 99
            mine = (name.startswith("roi_head.mask_head.upsample.") and last == 99) or (
                name.startswith("roi_head.mask_head.convs.") and int(name.split(".")[3]) <= last)
            upstream = name.startswith(("backbone.", "neck.")) or mine
        elif "_head" in key.split("/")[0]:
            head = key.split("/")[0]
            pre = "roi_head.bbox_head." + ("" if head == "bbox_head" else f"{head[12:]}.")
            fcs = (f"{pre}shared_fcs.0.",) + (
                (f"{pre}shared_fcs.1.",) if key.endswith("fc2") else ())
            upstream = name.startswith(("backbone.", "neck.") + fcs)
        else:
            blk = key.split("/")[0][5:].split("_")
            upstream = name.startswith("backbone.") and \
                _block_of(name) <= (int(blk[0]), int(blk[1]))
        if upstream:
            slack += 2.0 * n / np.sqrt(positions)
    return slack


# the model zoo's configs (tests/test_torch_zoo.py, test_torch_mask.py)
MODELS = "cl_faster_rcnn_cfgs/_base_/models"
ZOO_SMALL = dict(
    backbone_blocks=(1, 1, 1, 1),
    rpn_nms_pre=64,
    rpn_max_per_img=32,
    rcnn_num=16,
    max_per_img=8,
    use_approx_topk=False,
    roi_align_mode="gather",
)


def zoo_jax_and_port(config_file, num_classes=4, image_hw=(64, 64), seed=0, **overrides):
    """(JAX model, JAX variables, port model, port config) of one
    ``_base_/models`` config built by both packages' model zoos at the
    ZOO_SMALL size, with the same perturbed weights through the bridge
    (the JAX init compiled, as ``jax_and_port(jit_init=True)``)."""
    from nsgp_repre_tpu.models.zoo import build_detector as jax_build_detector
    from nsgp_repre_tpu.utils.config import load_config as jax_load_config
    from nsgp_repre_tpu_torch.models.zoo import build_config

    model_cfg = jax_load_config(f"{MODELS}/{config_file}")["model"]
    kw = dict(ZOO_SMALL, **overrides)
    model, _ = jax_build_detector(model_cfg, num_classes=num_classes, **kw)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + tuple(image_hw) + (3,), jnp.float32))
    stats = variables.get("batch_stats", {})  # SSD's VGG has no BN
    params_flat, stats_flat = perturb(
        _flatten_tree(variables["params"]), _flatten_tree(stats), seed)
    variables = {
        "params": restore_into(variables["params"], params_flat),
        "batch_stats": restore_into(stats, stats_flat) if stats_flat else {},
    }
    cls, cfg = build_config(model_cfg, num_classes, **kw)
    port = cls(cfg)
    port.load_state_dict(state_dict_from_jax(params_flat, stats_flat), strict=True)
    return model, variables, port.eval(), cfg


def _uniform_per_image(key, batch_size, n):
    """A sampler's draws from one key: split per image, u from each key
    and u2 from fold_in(key, 1) (samplers.py:97-100 in JAX)."""
    keys = jax.random.split(key, batch_size)
    u = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    u2 = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (n,))) for k in keys])
    return torch.from_numpy(u), torch.from_numpy(u2)


def zoo_priorities(kind, rng, cfg, batch_size, hw, gt_slots, n_proposals=None):
    """The port's sampling priorities for one JAX loss key of a model-zoo
    family (``kind``: the port class name), in the order the JAX family
    splits its key: RetinaNet and SSD draw nothing; RPN (and RPNC4) hands
    it to the RPN whole; Fast R-CNN to the RoI sampler whole
    (``n_proposals`` external proposals); Faster and Mask R-CNN and the C4
    and DC5 families split it in two (RPN, RoI head); the cascade splits it into
    num_stages + 1 (RPN, then each stage), and the cascade with a mask
    head first splits it in two (the cascade's, the mask sample's)."""
    if kind in ("RetinaNet", "SSD"):
        return {}
    A = cfg.num_base_priors
    N = sum(-(-hw[0] // s) * -(-hw[1] // s) * A for s in cfg.anchor_strides)
    rpn = lambda k: _uniform_per_image(k, batch_size, N)[0]  # noqa: E731
    if kind in ("RPN", "RPNC4"):
        return {"rpn": rpn(rng)}
    if kind == "FastRCNN":
        u, u2 = _uniform_per_image(rng, batch_size, gt_slots + n_proposals)
        return {"roi": u, "roi2": u2}
    if kind in ("FasterRCNN", "MaskRCNN", "FasterRCNNC4", "FasterRCNNDC5", "MaskRCNNC4"):
        k1, k2 = jax.random.split(rng)
        u, u2 = _uniform_per_image(k2, batch_size, gt_slots + cfg.rpn_max_per_img)
        return {"rpn": rpn(k1), "roi": u, "roi2": u2}
    out = {}
    if kind == "CascadeMaskRCNN":
        rng, k_mask = jax.random.split(rng)
        out["mask"], out["mask_2"] = _uniform_per_image(
            k_mask, batch_size, gt_slots + cfg.rpn_max_per_img)
    keys = jax.random.split(rng, cfg.num_stages + 1)
    out["rpn"] = rpn(keys[0])
    for i in range(cfg.num_stages):
        n = gt_slots + (cfg.rpn_max_per_img if i == 0 else cfg.rcnn_num)
        out[f"s{i}"], out[f"s{i}_2"] = _uniform_per_image(keys[i + 1], batch_size, n)
    return out


def family_loss_runs(model, variables, port, jb, tb, rng, priorities, jax_args=(), port_kw=None):
    """One family's loss terms and every gradient on both sides, with the
    ReLU inputs both record: the JAX loss compiled once
    (value_and_grad), the port's loss and backward. JAX calls the trunk
    more than once where it recomputes features (the cascade with a mask
    head does, cascade.py:364): its calls beyond the port's must repeat
    the port's and are dropped. Returns a dict of jax_losses, losses,
    jax_grads (port names), grads and flips."""
    from nsgp_repre_tpu.engine.train import total_loss as jax_total_loss

    def loss_fn(p):
        losses, st = model.apply({"params": p, "batch_stats": variables["batch_stats"]}, jb, rng,
                                 *jax_args, method=model.loss,
                                 capture_intermediates=capture_relu_inputs,
                                 mutable=["intermediates"])
        return jax_total_loss(losses), (losses, st["intermediates"])

    shapes = {k: tuple(v.shape) for k, v in priorities.items()}
    if not port_kw:  # given proposals set their own draw size
        # JAX's key splits give the draws the port family reports it reads
        assert shapes == port.priority_shapes(*tb.gt.boxes.shape[:2],
                                              shapes.get("rpn", (0, 0))[1]), shapes
    (_, (jl, inter)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    port.zero_grad(set_to_none=True)
    with PortReluInputs(port) as rec:
        tl = port.loss(tb, priorities=priorities, **(port_kw or {}))
    sum(v for k, v in tl.items() if "loss" in k).backward()
    jin = jax_relu_inputs([inter])
    for k, calls in jin.items():
        n = len(rec.out.get(k, []))
        if len(calls) > n:
            assert len(calls) % n == 0, k
            for extra in range(n, len(calls)):
                np.testing.assert_array_equal(calls[extra], calls[extra % n], err_msg=k)
            jin[k] = calls[:n]
    ref = {k: v.numpy() for k, v in
           state_dict_from_jax(_flatten_tree(jax.device_get(jg)), {}).items()}
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for n, p in port.named_parameters()}
    return dict(jax_losses={k: float(v) for k, v in jl.items()},
                losses={k: float(v.detach()) for k, v in tl.items()},
                jax_grads=ref, grads=grads, flips=relu_flips(jin, rec.out))


# the data-parallel tests' ranks (tests/test_torch_parallel*.py): processes
# of tests/torch_parallel_worker.py, whose collectives time out after 120 s
WORKER = osp.join(osp.dirname(osp.abspath(__file__)), "torch_parallel_worker.py")
WAIT_S = 240


def spawn_worker(args, tmp_path, name):
    """A worker process; its output goes to a file (no pipe to fill)."""
    log = open(tmp_path / f"{name}.log", "w")
    env = dict(os.environ, OMP_NUM_THREADS="2", GLOO_SOCKET_IFNAME="lo")  # loopback only
    return subprocess.Popen([sys.executable, WORKER, *map(str, args)], stdout=log,
                            stderr=subprocess.STDOUT, env=env,
                            cwd=osp.dirname(WORKER)), log


def wait_workers(procs, tmp_path):
    """Wait for every worker; fail with the log's tail of one that failed,
    and kill the rest."""
    try:
        for name, (p, log) in procs.items():
            p.wait(timeout=WAIT_S)
            log.close()
            assert p.returncode == 0, (name, (tmp_path / f"{name}.log").read_text()[-4000:])
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()

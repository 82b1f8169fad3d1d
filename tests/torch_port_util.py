"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Builds a small JAX detector, perturbs its weights so scores separate
(random BN statistics and affine terms, classifier weights scaled up, as
tests/test_full_parity.py does), and loads the same weights into the
PyTorch port through the weight bridge. Inputs are numpy arrays made
from seeds; both sides see the same numbers.
"""
from __future__ import annotations

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
# gradient) and the bbox head's two shared FCs. The sparse RPN head's
# hidden ReLU is computed inside a method on the JAX side and is not
# recorded here.
_BN_NAMES = ("bn1", "bn2", "bn3", "downsample_bn")
_FC_NAMES = ("shared_fc1", "shared_fc2")


def capture_relu_inputs(module, method_name):
    """capture_intermediates filter for :func:`jax_relu_inputs`."""
    name = module.name or ""
    return name in _BN_NAMES or name in _FC_NAMES or name.startswith("layer")


def jax_relu_inputs(intermediates):
    """{ReLU: [its input at each call, NHWC or (rows, units)]} from the
    intermediates that capture_relu_inputs captured (a list of applies'
    captures): bn1 and bn2 outputs, bn3 output plus the identity
    (downsample_bn output, else the previous block's output), the shared
    FCs' outputs."""
    out = {}
    for inter in intermediates:
        bb = inter.get("backbone", {})
        blocks = sorted((k for k in bb if k.startswith("layer")),
                        key=lambda k: tuple(int(x) for x in k[5:].split("_")))
        prev = None
        for blk in blocks:
            d = bb[blk]
            if not blk.startswith("layer1_"):
                ident = d["downsample_bn"]["__call__"][0] if "downsample_bn" in d else prev
                for i, pre in ((1, d["bn1"]["__call__"][0]), (2, d["bn2"]["__call__"][0]),
                               (3, d["bn3"]["__call__"][0] + ident)):
                    out.setdefault(f"{blk}/relu{i}", []).append(np.asarray(pre))
            prev = d["__call__"][0]
        for n in _FC_NAMES:
            if "bbox_head" in inter:
                out.setdefault(f"bbox_head/{n}", []).extend(
                    np.asarray(x) for x in inter["bbox_head"][n]["__call__"])
    return out


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

    def __enter__(self):
        hooks, bb = [], self.port.backbone
        for stage in bb.stage_names[1:]:
            for i, blk in enumerate(getattr(bb, stage)):
                key = f"{stage}_{i}"
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
        for n, fc in zip(_FC_NAMES, self.port.bbox_head.shared_fcs):
            hooks.append(fc.register_forward_hook(
                lambda m, a, y, n=n: self._add(f"bbox_head/{n}", y)))
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
        if key.startswith("bbox_head/"):
            fcs = ("roi_head.bbox_head.shared_fcs.0.",) + (
                ("roi_head.bbox_head.shared_fcs.1.",) if key.endswith("fc2") else ())
            upstream = name.startswith(("backbone.", "neck.") + fcs)
        else:
            blk = key.split("/")[0][5:].split("_")
            upstream = name.startswith("backbone.") and \
                _block_of(name) <= (int(blk[0]), int(blk[1]))
        if upstream:
            slack += 2.0 * n / np.sqrt(positions)
    return slack

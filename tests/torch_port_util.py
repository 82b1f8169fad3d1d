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


def jax_and_port(image_hw=(64, 96), seed=0, **overrides):
    """(JAX model, JAX variables, port model) with the same weights."""
    kw = dict(SMALL, **overrides)
    model = FasterRCNN(config=DetectorConfig(**kw))
    variables = model.init(
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

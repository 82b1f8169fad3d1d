"""The port's caffe C4/DC5 families against the JAX package: Faster R-CNN
C4 and DC5, Mask R-CNN C4 and RPN-C4 (loss terms, every gradient,
predict, the bridge round trip), the caffe and dilated ResNet trunks,
the C4 head's res5 (``ResLayer``) and ``roi_pool``.

The families run as in tests/test_torch_zoo.py: both packages' model zoos
build each ``_base_/models`` config at ZOO_SMALL (one bottleneck per
stage, 4 classes, 64x64 images, 32 proposals, rcnn_num 16), the same
perturbed weights cross the bridge, the same seeded images and gt boxes
(smooth gt crops for the mask branch, as tests/test_torch_mask.py
explains) go in, in f32 on the CPU. JAX runs its XLA paths (the C4
RoIAlign is its gather path on every backend), compiled once per family;
its sampling draws are re-derived from the key splits of each family's
loss. Each family is built once for the file.

Tolerances: loss terms to 1e-5 relative; every parameter gradient to
2e-4 of its largest magnitude, plus the slack of the ReLU flips counted
at the trainable bottlenecks (backbone and res5), the DC5 bbox head's
FCs and the mask head (tests/torch_port_util.py::flip_slack);
predictions with the same valid slots and labels, boxes to 1e-3 px,
scores to 1e-5, MaskRCNNC4's 14x14 probabilities to 1e-4; the trunks
and res5 to 1e-5 of their largest output; ``roi_pool`` exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.engine.train import normalize_images as jax_normalize
from nsgp_repre_tpu.models.resnet import ResLayer as JaxResLayer
from nsgp_repre_tpu.models.resnet import ResNet50 as JaxResNet50
from nsgp_repre_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from nsgp_repre_tpu.testing import demo_det_batch as jax_demo_batch
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree

from nsgp_repre_tpu_torch import testing as ttesting
from nsgp_repre_tpu_torch.engine.train import normalize_images
from nsgp_repre_tpu_torch.models.resnet import ResLayer, ResNet50
from nsgp_repre_tpu_torch.ops.roi_pool import roi_pool
from nsgp_repre_tpu_torch.utils.convert import jax_flat_from_state_dict, state_dict_from_jax
from torch_port_util import (family_loss_runs, f32_matmuls, flip_slack, images, n_flips, perturb,
                             zoo_jax_and_port, zoo_priorities)

HW = (64, 64)
B = 2
G = 4
S = 56  # gt crop side
LOSS_RTOL = 1e-5
GRAD_REL = 2e-4

FAMILIES = [
    ("faster-rcnn_r50-caffe-c4.py", "FasterRCNNC4"),
    ("faster-rcnn_r50-caffe-dc5.py", "FasterRCNNDC5"),
    ("mask-rcnn_r50-caffe-c4.py", "MaskRCNNC4"),
    ("rpn_r50-caffe-c4.py", "RPNC4"),
]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    f32_matmuls()
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _family(config_file):
    return zoo_jax_and_port(config_file, image_hw=HW)


# ---------------------------------------------------------------------------
# the trunks, res5 and roi_pool
# ---------------------------------------------------------------------------

def _port_weights(variables, jax_prefix, port_prefix):
    """A standalone JAX module's variables, perturbed (random BN statistics
    and affine terms), as the port module's state dict (its names inside
    a detector less ``port_prefix``) and as JAX variables."""
    params, stats = perturb(
        {f"{jax_prefix}/{k}": v for k, v in _flatten_tree(variables["params"]).items()},
        {f"{jax_prefix}/{k}": v for k, v in _flatten_tree(variables["batch_stats"]).items()},
        seed=3)
    sd = state_dict_from_jax(params, stats)
    assert all(k.startswith(port_prefix) for k in sd)
    cut = len(jax_prefix) + 1
    return ({k[len(port_prefix):]: v for k, v in sd.items()},
            {"params": _unflat({k[cut:]: v for k, v in params.items()}),
             "batch_stats": _unflat({k[cut:]: v for k, v in stats.items()})})


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *path, leaf = k.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("kw", [
    dict(style="caffe", strides=(1, 2, 2), out_indices=(2,), stage_blocks=(2, 1, 2)),
    dict(style="caffe", strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2), out_indices=(3,),
         stage_blocks=(1, 1, 1, 2)),
    dict(style="pytorch", out_indices=(1, 3), stage_blocks=(1, 1, 1, 1)),
], ids=["c4", "dc5", "pytorch"])
def test_resnet_trunks_match_jax(kw):
    """The caffe trunk (stride in the first 1x1) through stage 3, the
    dilated stage 5 of DC5 (output stride 16) and the pytorch trunk with
    chosen outputs, on the same perturbed weights."""
    x = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    jm = JaxResNet50(**kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    sd, v = _port_weights(v, "backbone", "backbone.")
    ref = jm.apply(v, jnp.asarray(x))
    port = ResNet50(**kw)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == len(kw["out_indices"])
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.permute(0, 2, 3, 1).shape) == r.shape
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r,
                                   atol=1e-5 * np.abs(r).max(), rtol=0)
    if kw.get("dilations"):
        assert ref[0].shape[1:3] == (4, 6)  # stride 16, not 32


def test_res_layer_matches_jax():
    """The C4 head's res5: (R, 14, 14, 1024) → (R, 7, 7, 2048), caffe style;
    its names are mmdet's shared head's (``layer4.{b}``)."""
    x = np.random.RandomState(1).randn(3, 14, 14, 1024).astype(np.float32)
    jm = JaxResLayer(stage=3, num_blocks=2, stride=2, style="caffe")
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    sd, v = _port_weights(v, "bbox_head/shared_head", "roi_head.shared_head.")
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    port = ResLayer(stage=3, num_blocks=2, stride=2, style="caffe")
    assert {k.split(".")[0] for k in port.state_dict()} == {"layer4"}
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (3, 7, 7, 2048)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("overrides", [{}, {"num_classes": 20, "rpn_nms_pre": 2000}])
def test_c4_config_matches_jax(overrides):
    """The C4/DC5 preset (c4.py:37-51): one stride-16 level, scales 2-32,
    6,000 / 1,000 proposals, 512 sampled RoIs; overrides win."""
    import dataclasses

    from nsgp_repre_tpu.models.c4 import c4_config as jax_c4_config
    from nsgp_repre_tpu_torch.models.c4 import c4_config

    assert dataclasses.asdict(c4_config(**overrides)) == dataclasses.asdict(
        jax_c4_config(**overrides))


@pytest.mark.parametrize("scale,out", [(1.0, 7), (0.0625, 14)])
def test_roi_pool_matches_jax(scale, out):
    rng = np.random.RandomState(2)
    feats = rng.randn(2, 20, 24, 8).astype(np.float32)
    xy = rng.uniform(-8, 300, (30, 2)).astype(np.float32)
    wh = rng.uniform(1, 200, (30, 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + wh], 1) * (1.0 if scale == 0.0625 else 0.08)
    bidx = rng.randint(0, 2, 30).astype(np.int32)
    ref = jax_roi_pool(jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(bidx), out, scale)
    got = roi_pool(_t(feats), _t(rois), _t(bidx), out, scale)
    assert tuple(got.shape) == (30, out, out, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _constant_map():
    return np.full((1, 16, 16, 4), 2.0, np.float32), [[0.0, 0, 8, 8]]


def _one_peak_map():
    f = np.zeros((1, 8, 8, 1), np.float32)
    f[0, 1, 1, 0] = 5.0
    return f, [[0.0, 0, 4, 4]]


@pytest.mark.parametrize("case", [_constant_map, _one_peak_map])
def test_roi_pool_matches_jax_on_the_ops_cases(case):
    """tests/test_ops.py::TestRoIPool's cases (a constant map; one peak),
    output_size 2: the port's values are JAX's, bit for bit."""
    feats, rois = case()
    rois = np.asarray(rois, np.float32)
    bidx = np.zeros(1, np.int32)
    ref = np.asarray(jax_roi_pool(jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(bidx),
                                  output_size=2))
    got = roi_pool(_t(feats), _t(rois), _t(bidx), output_size=2).numpy()
    assert got.shape == ref.shape == (1, 2, 2, feats.shape[-1])
    np.testing.assert_array_equal(got, ref)
    assert got.max() == feats.max()


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------

def _soft_masks(seed=6):
    """Smooth random crops in [0, 1] (bilinear upsampling of 8x8 noise)."""
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy(rng.rand(B * G, 1, 8, 8).astype(np.float32))
    up = torch.nn.functional.interpolate(coarse, size=(S, S), mode="bilinear",
                                         align_corners=False)
    return up.reshape(B, G, S, S).numpy()


def _batches(masks: bool, seed=0):
    jb = jax_demo_batch(B, *HW, num_instances=(2, 3), num_classes=4, gt_capacity=G, seed=seed)
    tb = ttesting.demo_det_batch(B, *HW, num_instances=(2, 3), num_classes=4, gt_capacity=G,
                                 seed=seed)
    imgs = images((B,) + HW, seed=seed)
    jb = jb.replace(images=jax_normalize(jnp.asarray(imgs)))
    tb = tb.replace(images=normalize_images(torch.from_numpy(imgs)))
    if masks:
        m = _soft_masks()
        jb = jb.replace(gt=jb.gt.replace(masks=jnp.asarray(m)))
        tb = tb.replace(gt=tb.gt.replace(masks=torch.from_numpy(m)))
    return jb, tb


@pytest.mark.parametrize("config_file,kind", FAMILIES)
def test_c4_family_matches_jax(config_file, kind):
    model, variables, port, cfg = _family(config_file)
    assert type(port).__name__ == kind
    masks = kind == "MaskRCNNC4"
    jb, tb = _batches(masks)
    rng = jax.random.PRNGKey(7)
    run = family_loss_runs(model, variables, port, jb, tb, rng,
                           zoo_priorities(kind, rng, cfg, B, HW, G))
    got, ref = run["losses"], run["jax_losses"]
    want = {"loss_rpn_cls", "loss_rpn_bbox"} | (
        set() if kind == "RPNC4" else {"loss_cls", "loss_bbox", "acc"}) | (
        {"loss_mask"} if masks else set())
    assert set(got) == set(ref) == want
    for k in ref:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)

    flips = run["flips"]
    assert n_flips(flips) <= 16, flips
    if kind in ("FasterRCNNC4", "MaskRCNNC4"):
        assert any(k.startswith("shared_head/layer4_") for k in flips)
    frozen = ("backbone.conv1", "backbone.bn1", "backbone.layer1.")
    assert any(np.abs(g).max() > 0 for g in run["grads"].values())
    for k, r in run["jax_grads"].items():
        scale = np.abs(r).max()
        g = run["grads"][k]
        assert (np.abs(g).max() > 0) == (scale > 0) and not (k.startswith(frozen) and scale > 0), k
        err = np.abs(g - r).max()
        assert err <= (GRAD_REL + flip_slack(flips, k)) * max(scale, 1e-6), (k, err, scale, flips)
    if kind != "RPNC4":
        head = "roi_head.shared_head." if kind != "FasterRCNNDC5" else "roi_head.bbox_head."
        assert any(np.abs(run["grads"][k]).max() > 0 for k in run["grads"] if k.startswith(head))

    jd = jax.jit(lambda v, b: model.apply(v, b, method=model.predict))(variables, jb)
    with torch.no_grad():
        td = port.predict(tb)
    v = np.asarray(jd.valid)
    assert v.any()
    np.testing.assert_array_equal(td.valid.numpy(), v)
    np.testing.assert_array_equal(td.labels.numpy()[v], np.asarray(jd.labels)[v])
    # boxes to 1e-3 px, as tests/test_torch_zoo.py: the DC5 head's first FC
    # sums 100,352 f32 products, which the two sides order apart (~1e-5
    # relative in the deltas, ~4e-4 px on a 64-px box)
    np.testing.assert_allclose(td.boxes.numpy()[v], np.asarray(jd.boxes)[v], atol=1e-3)
    np.testing.assert_allclose(td.scores.numpy()[v], np.asarray(jd.scores)[v], atol=1e-5)
    if kind == "RPNC4":
        assert tuple(td.boxes.shape) == (B, cfg.rpn_max_per_img, 4) and not td.labels.any()
    if masks:
        assert tuple(td.masks.shape) == (B, cfg.max_per_img, 14, 14)
        np.testing.assert_allclose(td.masks.numpy()[v], np.asarray(jd.masks)[v], atol=1e-4)


@pytest.mark.parametrize("config_file,kind", FAMILIES)
def test_c4_bridge_round_trip(config_file, kind):
    """state_dict_from_jax and jax_flat_from_state_dict are inverses on each
    family's checkpoint: the res5 shared head, the plain fc_cls/fc_reg
    with no task digit, the 2048-channel DC5 head, the mask head."""
    model, variables, port, _ = _family(config_file)
    params, stats = jax_flat_from_state_dict(port.state_dict())
    ref = _flatten_tree(variables["params"])
    assert params.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(params[k], np.asarray(ref[k]), err_msg=k)
    assert stats.keys() == _flatten_tree(variables["batch_stats"]).keys()
    names = set(port.state_dict())
    expect = {
        "FasterRCNNC4": {"roi_head.shared_head.layer4.0.downsample.0.weight",
                         "roi_head.shared_head.layer4.2.bn3.running_var",
                         "roi_head.bbox_head.fc_cls.weight", "roi_head.bbox_head.fc_reg.bias"},
        "FasterRCNNDC5": {"backbone.layer4.0.conv2.weight", "roi_head.bbox_head.fc_cls.1.weight",
                          "rpn_head.rpn_conv.weight"},
        "MaskRCNNC4": {"roi_head.mask_head.upsample.weight", "roi_head.shared_head.layer4.1.conv1.weight"},
        "RPNC4": {"backbone.layer3.0.conv1.weight", "rpn_head.rpn_reg.bias"},
    }[kind]
    assert expect <= names, expect - names
    assert not any(k.startswith("neck.") for k in names)
    if kind == "FasterRCNNDC5":
        assert tuple(port.state_dict()["roi_head.bbox_head.shared_fcs.0.weight"].shape) == (
            1024, 7 * 7 * 2048)
    again = state_dict_from_jax(params, stats)
    for k, t in port.state_dict().items():
        assert torch.equal(again[k], t), k

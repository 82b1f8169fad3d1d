"""The port's single-stage families against the JAX package: RetinaNet and
SSD300 (loss terms, every gradient, predict, the bridge round trip), the
focal loss, RetinaNet's prior bias, the FPN's extra convs, SSD's anchor
sizes, its VGG's ceil-mode pools and its hard-negative ranks.

The families run as in tests/test_torch_zoo.py: both packages' model zoos
build each ``_base_/models`` config at ZOO_SMALL (4 classes; RetinaNet
with one bottleneck per stage on two 64x64 images), the same perturbed
weights cross the bridge (RetinaNet's class biases spread over [-3, 0],
else every score sits at the prior 0.01, under the 0.05 threshold), the
same seeded images and gt boxes go in, in f32 on the CPU; JAX runs its
XLA paths, compiled once per family, with exact top-k. SSD's VGG has a
fixed width and needs 257 px or more for its six levels to be non-empty
(at 128 px levels 5-6 come out 0x0), so it runs on one 257x257 image.
Neither family draws at random in its loss.

Tolerances: loss terms to 1e-5 relative; every parameter gradient to
2e-4 of its largest magnitude, plus the slack of the ReLU flips counted
at the trainable bottlenecks and RetinaNet's towers, and at SSD's VGG
convs and extra levels (tests/torch_port_util.py::flip_slack);
predictions with the same valid slots and labels, boxes to 1e-3 px and
scores to 1e-5; the focal loss to 1e-6 relative and its gradient to 1e-6
of its largest magnitude; the FPN to 1e-5 of its largest output; anchors,
prior bias and hard-negative ranks exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.engine.train import normalize_images as jax_normalize
from nsgp_repre_tpu.models import losses as jax_losses
from nsgp_repre_tpu.models import ssd as jax_ssd
from nsgp_repre_tpu.models.fpn import FPN as JaxFPN
from nsgp_repre_tpu.testing import demo_det_batch as jax_demo_batch
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree

from nsgp_repre_tpu_torch import testing as ttesting
from nsgp_repre_tpu_torch.engine.train import normalize_images
from nsgp_repre_tpu_torch.models import losses as tlosses
from nsgp_repre_tpu_torch.models import ssd as tssd
from nsgp_repre_tpu_torch.models.fpn import FPN
from nsgp_repre_tpu_torch.models.single_stage import PRIOR_BIAS
from nsgp_repre_tpu_torch.models.zoo import build_detector
from nsgp_repre_tpu_torch.utils.config import load_config
from nsgp_repre_tpu_torch.utils.convert import jax_flat_from_state_dict, state_dict_from_jax
from torch_port_util import (MODELS, family_loss_runs, f32_matmuls, flip_slack, images, n_flips,
                             zoo_jax_and_port)

G = 4
LOSS_RTOL = 1e-5
GRAD_REL = 2e-4
# (config, class, batch, image side)
FAMILIES = [("retinanet_r50_fpn.py", "RetinaNet", 2, 64), ("ssd300.py", "SSD", 1, 257)]


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
def _family(config_file, side):
    return zoo_jax_and_port(config_file, image_hw=(side, side))


# ---------------------------------------------------------------------------
# the focal loss, the prior bias, the FPN's extra convs, SSD's anchors and ranks
# ---------------------------------------------------------------------------

def test_focal_loss_and_gradient_match_jax():
    """Values and logit gradients over anchors of every kind: positives of
    each class, background rows (label C: an all-zero target) and
    ignored rows (weight 0)."""
    rng = np.random.RandomState(0)
    C = 5
    logits = (rng.randn(3, 70, C) * 3).astype(np.float32)
    labels = rng.randint(0, C + 1, (3, 70)).astype(np.int32)
    weights = (rng.rand(3, 70) > 0.2).astype(np.float32)
    for gamma, alpha in ((2.0, 0.25), (1.5, 0.5)):
        def jf(x):
            return jax_losses.weighted_sigmoid_focal(x, jnp.asarray(labels), jnp.asarray(weights),
                                                     17.0, C, gamma=gamma, alpha=alpha)
        ref, ref_g = jax.value_and_grad(jf)(jnp.asarray(logits))
        x = _t(logits).requires_grad_(True)
        got = tlosses.weighted_sigmoid_focal(x, _t(labels), _t(weights), 17.0, C, gamma=gamma,
                                             alpha=alpha)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
        ref_g = np.asarray(ref_g)
        np.testing.assert_allclose(x.grad.numpy(), ref_g, atol=1e-6 * np.abs(ref_g).max(), rtol=0)


def test_retinanet_prior_bias_matches_jax():
    """retina_cls's bias starts at -log(99) (bias_prob 0.01) on both sides,
    every other head bias at 0; the head kernels are N(0, 0.01)."""
    model, _, _, _ = _family("retinanet_r50_fpn.py", 64)
    v = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))
    head = v["params"]["bbox_head"]
    np.testing.assert_array_equal(np.asarray(head["retina_cls"]["bias"]),
                                  np.full(9 * 4, PRIOR_BIAS, np.float32))
    det, cfg = build_detector(load_config(f"{MODELS}/retinanet_r50_fpn.py")["model"],
                              num_classes=4, device="cpu", backbone_blocks=(1, 1, 1, 1))
    h = det.bbox_head
    np.testing.assert_array_equal(h.retina_cls.bias.detach().numpy(),
                                  np.full(9 * 4, PRIOR_BIAS, np.float32))
    assert not h.retina_reg.bias.any() and not h.cls_convs[0].conv.bias.any()
    assert abs(float(h.cls_convs[3].conv.weight.detach().std()) - 0.01) < 1e-3
    sd = det.state_dict()
    assert "neck.fpn_convs.4.conv.weight" in sd and "neck.lateral_convs.2.conv.weight" in sd
    assert tuple(sd["neck.fpn_convs.3.conv.weight"].shape) == (256, 2048, 3, 3)


@pytest.mark.parametrize("extra,relu", [("on_input", False), ("on_output", False),
                                        ("on_output", True)])
def test_fpn_extra_convs_match_jax(extra, relu):
    """FPN(start_level=1) with two stride-2 extra convs, on the last
    backbone map or chained on the last output, ReLU'd before the second
    or not; mmdet's names (``fpn_convs.{3,4}``)."""
    rng = np.random.RandomState(1)
    shapes = [(1, 32, 48, 256), (1, 16, 24, 512), (1, 8, 12, 1024), (1, 4, 6, 2048)]
    feats = [rng.randn(*s).astype(np.float32) for s in shapes]
    jm = JaxFPN(out_channels=64, num_outs=5, start_level=1, add_extra_convs=extra,
                relu_before_extra_convs=relu)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])
    v = jax.tree_util.tree_map(lambda a: a + 0.01, v)  # nonzero biases
    ref = jm.apply(v, [jnp.asarray(f) for f in feats])
    sd = state_dict_from_jax({f"neck/{k}": np.asarray(a) for k, a in
                              _flatten_tree(v["params"]).items()}, {})
    port = FPN((256, 512, 1024, 2048), 64, num_outs=5, start_level=1, add_extra_convs=extra,
               relu_before_extra_convs=relu)
    port.load_state_dict({k[5:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        got = port([_t(f).permute(0, 3, 1, 2) for f in feats])
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        r = np.asarray(r)
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), rtol=0)


@pytest.mark.parametrize("size,levels,rng_range", [(300, 6, (0.15, 0.9)), (512, 7, (0.1, 0.9))])
def test_ssd_anchor_sizes_match_jax(size, levels, rng_range):
    assert tssd.ssd_anchor_sizes(size, levels, rng_range) == jax_ssd.ssd_anchor_sizes(
        size, levels, rng_range)
    for mn, mx, ratios, stride in ((21, 45, (2.0,), 8), (99, 153, (2.0, 3.0), 32)):
        np.testing.assert_array_equal(tssd.ssd_base_anchors(mn, mx, ratios, stride),
                                      jax_ssd.ssd_base_anchors(mn, mx, ratios, stride))


def test_ssd_anchors_match_jax():
    """SSD300's anchors over its six levels at 300 px: 8,732 in JAX's order."""
    model, variables, port, cfg = _family("ssd300.py", 257)
    sizes = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
    fake = [jnp.zeros((1, h, w, 1)) for h, w in sizes]
    ref, ref_sizes = model.apply(variables, fake, method=lambda m, f: m._anchors(f))
    got, got_sizes = port._anchors([torch.zeros(1, h, w, 1) for h, w in sizes])
    assert got.shape == (8732, 4) and got_sizes == list(ref_sizes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jax_hard_negatives(ce, pos, neg, ratio):
    """ssd.py:286-293 in JAX, per image."""
    def one(ce, pos, neg):
        num_neg = jnp.minimum(ratio * pos.sum(), neg.sum())
        order = jnp.argsort(-jnp.where(neg, ce, -1.0))
        rank = jnp.zeros_like(order).at[order].set(jnp.arange(order.shape[0]))
        return neg & (rank < num_neg)
    return np.asarray(jax.vmap(one)(jnp.asarray(ce), jnp.asarray(pos), jnp.asarray(neg)))


def test_ssd_vgg_ceil_mode_pools_match_jax():
    """SSD's VGG on an odd-sized map: JAX pads with -inf before each 2x2
    pool (ssd.py:127-133), the port pools in ceil mode; 75 -> 38 -> 19 ->
    10, so conv4_3 is 10x10 (floor mode would give 9x9) and fc7 5x5, and
    both outputs equal JAX's to 1e-5 of their largest value."""
    from nsgp_repre_tpu_torch.utils.convert import VGG_FEATURES

    x = np.random.RandomState(3).randn(1, 75, 75, 3).astype(np.float32)
    jm = jax_ssd.SSDVGG()
    v = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    sd = {}
    for name, p in v["params"].items():
        idx = VGG_FEATURES[name]
        sd[f"features.{idx}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        sd[f"features.{idx}.bias"] = _t(p["bias"])
    port = tssd.SSDVGG()
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    for g, r, hw, c in zip(got, ref, (10, 5), (512, 1024)):
        g, r = g.permute(0, 2, 3, 1).numpy(), np.asarray(r)
        assert g.shape == r.shape == (1, hw, hw, c)
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), rtol=0)


def test_ssd_hard_negatives_match_jax():
    """The kept negatives of a stable descending sort by CE, ties included:
    CEs drawn from a few values, so many negatives tie at the cut; a row
    with fewer negatives than 3x its positives keeps them all; a row with
    no positive keeps none."""
    rng = np.random.RandomState(4)
    B, N = 4, 300
    ce = rng.choice(np.array([0.0, 0.25, 0.5, 1.0, 2.0], np.float32), (B, N))
    kind = rng.choice(3, (B, N), p=[0.05, 0.8, 0.15])  # pos, neg, ignored
    kind[2, :] = np.where(rng.rand(N) < 0.4, 0, 2)  # few negatives
    kind[2, :5] = 1
    kind[3, kind[3] == 0] = 1  # no positive
    pos, neg = kind == 0, kind == 1
    ref = _jax_hard_negatives(ce, pos, neg, 3)
    got = tssd.hard_negatives(_t(ce), _t(pos), _t(neg), 3).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0].sum() == 3 * pos[0].sum() and got[2].sum() == neg[2].sum()
    assert not got[3].any()


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------

def _batches(batch, side, seed=0):
    jb = jax_demo_batch(batch, side, side, num_instances=(2, 3), num_classes=4, gt_capacity=G,
                        seed=seed)
    tb = ttesting.demo_det_batch(batch, side, side, num_instances=(2, 3), num_classes=4,
                                 gt_capacity=G, seed=seed)
    imgs = images((batch, side, side), seed=seed)
    jb = jb.replace(images=jax_normalize(jnp.asarray(imgs)))
    tb = tb.replace(images=normalize_images(torch.from_numpy(imgs)))
    return jb, tb


@pytest.mark.parametrize("config_file,kind,batch,side", FAMILIES)
def test_single_stage_family_matches_jax(config_file, kind, batch, side):
    model, variables, port, cfg = _family(config_file, side)
    assert type(port).__name__ == kind
    jb, tb = _batches(batch, side)
    rng = jax.random.PRNGKey(7)
    run = family_loss_runs(model, variables, port, jb, tb, rng, {})
    got, ref = run["losses"], run["jax_losses"]
    assert set(got) == set(ref) == {"loss_cls", "loss_bbox"}
    for k in ref:
        assert np.isfinite(got[k]) and got[k] > 0
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)

    flips = run["flips"]
    assert n_flips(flips) <= 16, flips
    towers = ("bbox_head/cls_conv", "bbox_head/reg_conv") if kind == "RetinaNet" else (
        "backbone/conv", "neck/extra")
    assert any(k.startswith(towers) for k in flips)
    frozen = ("backbone.conv1", "backbone.bn1", "backbone.layer1.")
    for k, r in run["jax_grads"].items():
        scale = np.abs(r).max()
        g = run["grads"][k]
        assert (np.abs(g).max() > 0) == (scale > 0) and not (k.startswith(frozen) and scale > 0), k
        err = np.abs(g - r).max()
        assert err <= (GRAD_REL + flip_slack(flips, k)) * max(scale, 1e-6), (k, err, scale, flips)
    # the regression reaches the head (SSD's first level, 21-px anchors,
    # holds no positive for these 51-128 px boxes)
    assert any(np.abs(g).max() > 0 for k, g in run["grads"].items()
               if k.startswith(("bbox_head.reg_convs.", "bbox_head.retina_reg.")))

    jd = jax.jit(lambda v, b: model.apply(v, b, method=model.predict))(variables, jb)
    with torch.no_grad():
        td = port.predict(tb)
    v = np.asarray(jd.valid)
    assert v.any()
    assert tuple(td.boxes.shape) == (batch, cfg.max_per_img, 4)
    np.testing.assert_array_equal(td.valid.numpy(), v)
    np.testing.assert_array_equal(td.labels.numpy()[v], np.asarray(jd.labels)[v])
    np.testing.assert_allclose(td.boxes.numpy()[v], np.asarray(jd.boxes)[v], atol=1e-3)
    np.testing.assert_allclose(td.scores.numpy()[v], np.asarray(jd.scores)[v], atol=1e-5)


@pytest.mark.parametrize("config_file,kind,batch,side", FAMILIES)
def test_single_stage_bridge_round_trip(config_file, kind, batch, side):
    """state_dict_from_jax and jax_flat_from_state_dict are inverses on each
    family's checkpoint: RetinaNet's towers and extra FPN convs; SSD's VGG
    at mmdet's ``features`` indices, its bare ``neck/l2_norm``, its extra
    levels and per-level head convs."""
    model, variables, port, _ = _family(config_file, side)
    params, stats = jax_flat_from_state_dict(port.state_dict())
    ref = _flatten_tree(variables["params"])
    assert params.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(params[k], np.asarray(ref[k]), err_msg=k)
    names = set(port.state_dict())
    if kind == "RetinaNet":
        assert {"bbox_head.cls_convs.3.conv.weight", "bbox_head.reg_convs.0.conv.bias",
                "bbox_head.retina_cls.bias", "neck.fpn_convs.4.conv.weight"} <= names
        assert stats.keys() == _flatten_tree(variables["batch_stats"]).keys()
    else:
        assert {"backbone.features.0.weight", "backbone.features.28.bias",
                "backbone.features.31.weight", "backbone.features.33.weight",
                "neck.l2_norm.weight", "neck.extra_layers.3.1.conv.weight",
                "bbox_head.cls_convs.5.0.weight", "bbox_head.reg_convs.0.0.bias"} <= names
        assert not stats and "neck/l2_norm" in params
        assert tuple(port.state_dict()["backbone.features.31.weight"].shape) == (1024, 512, 3, 3)
    again = state_dict_from_jax(params, stats)
    for k, t in port.state_dict().items():
        assert torch.equal(again[k], t), k

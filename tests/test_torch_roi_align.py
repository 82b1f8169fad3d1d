"""The port's RoIAlign (plain version of the CUDA kernel) against the JAX
package: the XLA gather path (reference routing) at f32 atol 1e-5, and
the Pallas window kernel (interpret=True) at atol 1e-4 on RoIs that its
window-fit routing leaves on their mmdet level (its separable-matmul
pooling sums in another order, tests/test_pallas_ops.py:68-70). The
backward (plain, and autograd through the wrapper) against ``jax.vjp``
of the gather path at f32 atol 1e-5 and against the Pallas backward
kernel (interpret=True) at atol 1e-4, for the same reasons."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.ops.roi_align import multilevel_roi_align as jax_roi_align
from nsgp_repre_tpu.ops.roi_align_pallas import (multilevel_roi_align_bwd_pallas,
                                                  multilevel_roi_align_pallas, route_levels)

from nsgp_repre_tpu_torch.ops.roi_align import (map_roi_levels, multilevel_roi_align,
                                                multilevel_roi_align_backward, roi_footprints,
                                                sample_taps)
from nsgp_repre_tpu_torch.ops.roi_align_cuda import multilevel_roi_align as roi_align_wrapper

STRIDES = (4, 8, 16, 32)


def _fixture(seed=0, B=2, C=32, R=48, canvas=(256, 384)):
    rng = np.random.RandomState(seed)
    H, W = canvas
    feats = [rng.randn(B, H // s, W // s, C).astype(np.float32) for s in STRIDES]
    x1 = rng.uniform(-20, W - 20, R).astype(np.float32)
    y1 = rng.uniform(-20, H - 20, R).astype(np.float32)
    side = np.exp(rng.uniform(np.log(8), np.log(700), R))
    aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), R))
    side_w = (side * np.sqrt(aspect)).astype(np.float32)
    side_h = (side / np.sqrt(aspect)).astype(np.float32)
    rois = np.stack([x1, y1, x1 + side_w, y1 + side_h], -1)
    rois[0] = [0, 0, 0, 0]  # a zero-area (padded) proposal
    bidx = rng.randint(0, B, R).astype(np.int32)
    return feats, rois, bidx


def _t(x):
    return torch.from_numpy(np.array(x))


def test_routing_matches_jax():
    _, rois, _ = _fixture()
    area = (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1])
    ref = np.clip(np.floor(np.log2(np.sqrt(np.maximum(area, 0)) / 56.0 + 1e-6)), 0, 3)
    got = map_roi_levels(_t(rois), 4).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert len(np.unique(got)) == 4  # every level used


def test_plain_matches_jax_gather_f32():
    feats, rois, bidx = _fixture()
    ref = jax_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(bidx),
                        strides=STRIDES)
    got = multilevel_roi_align([_t(f) for f in feats], _t(rois), _t(bidx), strides=STRIDES)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_lvl_override_matches_jax():
    feats, rois, bidx = _fixture(seed=1)
    lvl = np.random.RandomState(2).randint(0, 4, len(rois)).astype(np.int32)
    ref = jax_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(bidx),
                        strides=STRIDES, lvl_override=jnp.asarray(lvl))
    got = multilevel_roi_align([_t(f) for f in feats], _t(rois), _t(bidx), strides=STRIDES,
                               lvl_override=_t(lvl))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_plain_matches_pallas_window_interpret():
    feats, rois, bidx = _fixture(seed=3, R=64)
    level_hw = tuple((f.shape[1], f.shape[2]) for f in feats)
    bumped = np.asarray(route_levels(jnp.asarray(rois), level_hw, STRIDES, 7, 2, 56.0))
    keep = np.flatnonzero(bumped == map_roi_levels(_t(rois), 4).numpy())
    keep = keep[: 8 * (len(keep) // 8)]  # the Pallas kernel takes R % 8 == 0
    assert len(keep) >= 32
    r, b = rois[keep], bidx[keep]
    ref = multilevel_roi_align_pallas([jnp.asarray(f) for f in feats], jnp.asarray(r),
                                      jnp.asarray(b), strides=STRIDES, interpret=True)
    got = multilevel_roi_align([_t(f) for f in feats], _t(r), _t(b), strides=STRIDES)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_wrapper_bf16_on_cpu_matches_jax():
    """The wrapper on CPU tensors: plain version, f32 accumulation, result
    in the feature dtype (one bf16 rounding of the same f32 sum, up to
    the summation order)."""
    feats, rois, bidx = _fixture(seed=4)
    fb = [jnp.asarray(f).astype(jnp.bfloat16) for f in feats]
    ref = jax_roi_align(fb, jnp.asarray(rois), jnp.asarray(bidx), strides=STRIDES)
    ref = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
    tf = [_t(f).to(torch.bfloat16) for f in feats]
    got = roi_align_wrapper(tf, _t(rois), _t(bidx), strides=STRIDES)
    assert got.dtype == torch.bfloat16 and got.shape == (len(rois), 7, 7, 32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# backward: the gradient w.r.t. the level maps
# ---------------------------------------------------------------------------

def _jax_vjp(feats, rois, bidx, g, lvl=None):
    def f(fs):
        return jax_roi_align(fs, jnp.asarray(rois), jnp.asarray(bidx), strides=STRIDES,
                             lvl_override=None if lvl is None else jnp.asarray(lvl))

    _, vjp = jax.vjp(f, [jnp.asarray(x) for x in feats])
    return [np.asarray(x) for x in vjp(jnp.asarray(g))[0]]


def _levels_hit(grads):
    return sum(bool(np.abs(x).max() > 0) for x in grads)


def test_backward_plain_matches_jax_vjp():
    """All four levels and both images receive gradient; f32 sums of the
    same tap products in another order (index_add_ against XLA's scatter)."""
    feats, rois, bidx = _fixture(seed=5, R=64)
    g = np.random.RandomState(6).randn(len(rois), 7, 7, 32).astype(np.float32)
    ref = _jax_vjp(feats, rois, bidx, g)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    got = multilevel_roi_align_backward(_t(g), _t(rois), _t(bidx), level_hw, 2, strides=STRIDES)
    assert _levels_hit(ref) == 4 and all(np.abs(r[b]).max() > 0 for r in ref[:2] for b in (0, 1))
    for x, r in zip(got, ref):
        assert x.dtype == torch.float32 and x.shape == r.shape
        np.testing.assert_allclose(x.numpy(), r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_wrapper_matches_jax_vjp(dtype):
    """``multilevel_roi_align`` (RoIAlignFunction) differentiates w.r.t.
    the features only; the level gradients come back in the feature dtype
    (one rounding of the f32 sums in bf16; the reference gets the same
    bf16-valued output gradient)."""
    feats, rois, bidx = _fixture(seed=7, R=40)
    g = _t(np.random.RandomState(8).randn(len(rois), 7, 7, 32).astype(np.float32)).to(dtype)
    ref = _jax_vjp(feats, rois, bidx, g.float().numpy())
    tf = [_t(f).to(dtype).requires_grad_(True) for f in feats]
    r = _t(rois).requires_grad_(True)
    out = roi_align_wrapper(tf, r, _t(bidx), strides=STRIDES)
    assert out.dtype == dtype
    out.backward(g)
    assert r.grad is None  # proposals are data
    atol = 1e-5 if dtype == torch.float32 else 0.0
    for f, ref_l in zip(tf, ref):
        assert f.grad.dtype == dtype
        tol = atol + (2 ** -8 * np.abs(ref_l).max() if dtype == torch.bfloat16 else 0.0)
        np.testing.assert_allclose(f.grad.float().numpy(), ref_l, atol=tol, rtol=0)


def test_backward_plain_matches_pallas_bwd_interpret():
    """The port's backward against the TPU kernel in interpret mode on
    RoIs that its window-fit routing leaves on their mmdet level."""
    feats, rois, bidx = _fixture(seed=9, R=72)
    level_hw = tuple((f.shape[1], f.shape[2]) for f in feats)
    bumped = np.asarray(route_levels(jnp.asarray(rois), level_hw, STRIDES, 7, 2, 56.0))
    mmdet = map_roi_levels(_t(rois), 4).numpy()
    keep = np.flatnonzero(bumped == mmdet)
    keep = keep[: 8 * (len(keep) // 8)]  # the Pallas kernel takes R % 8 == 0
    np.testing.assert_array_equal(bumped[keep], mmdet[keep])
    assert len(keep) >= 32 and len(np.unique(mmdet[keep])) >= 3
    r, b = rois[keep], bidx[keep]
    g = np.random.RandomState(10).randn(len(keep), 7, 7, 32).astype(np.float32)
    ref = multilevel_roi_align_bwd_pallas(jnp.asarray(g), jnp.asarray(r), jnp.asarray(b),
                                          level_hw, 2, strides=STRIDES, interpret=True)
    got = multilevel_roi_align_backward(_t(g), _t(r), _t(b), level_hw, 2, strides=STRIDES)
    for x, y in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4, rtol=0)


@pytest.mark.parametrize("ss", [1, 2])
def test_footprints_hold_every_tap(ss):
    """The backward kernel's binning rule: every nonzero-weight tap of a
    RoI lies on the RoI's level, inside its footprint; a RoI whose
    samples all lie outside the map has an empty footprint and no tap.
    RoIs partly and wholly outside the map, tiny, zero-area, elongated."""
    rng = np.random.RandomState(11 + ss)
    H, W = 256, 384
    level_hw = [(H // s, W // s) for s in STRIDES]
    R = 160
    x1 = rng.uniform(-300, W + 50, R)
    y1 = rng.uniform(-300, H + 50, R)
    side = np.exp(rng.uniform(np.log(0.3), np.log(900), (R, 2)))
    side[:20, 0] = rng.uniform(500, 900, 20)  # elongated
    side[:20, 1] = rng.uniform(0.5, 3, 20)
    side[20:40, 1] = rng.uniform(500, 900, 20)
    side[20:40, 0] = rng.uniform(0.5, 3, 20)
    rois = np.stack([x1, y1, x1 + side[:, 0], y1 + side[:, 1]], -1).astype(np.float32)
    rois[40] = [0, 0, 0, 0]  # zero area at the origin
    rois[41] = [50, 60, 50, 90]  # zero width
    rois[42] = [-900, -900, -600, -600]  # wholly outside
    rois[43] = [W + 10, 5, W + 400, 300]
    rois[44] = [W - 0.5, H - 0.5, W + 0.5, H + 0.5]  # a corner of the map
    rois[45] = [-2, -2, 1, 1]
    rois = _t(rois)
    bidx = torch.zeros(R, dtype=torch.int32)
    lvl, box = roi_footprints(level_hw, rois, STRIDES, 7, ss)
    np.testing.assert_array_equal(lvl.numpy(), map_roi_levels(rois, 4).numpy())
    lin, w = sample_taps(level_hw, 1, rois, bidx, STRIDES, 7, ss)
    offs = np.cumsum([0] + [h * wd for h, wd in level_hw])
    hit = w != 0
    empty = box[:, 0] > box[:, 1]
    assert not hit[empty].any()
    assert 10 < int(empty.sum()) < R - 40  # both kinds present
    for r in range(R):
        taps = lin[r][hit[r]].numpy()
        if taps.size == 0:
            continue
        lv = int(np.searchsorted(offs, taps.max(), side="right") - 1)
        assert (taps >= offs[lv]).all() and lv == int(lvl[r])
        y, x = np.divmod(taps - offs[lv], level_hw[lv][1])
        y_lo, y_hi, x_lo, x_hi = box[r].tolist()
        assert y_lo <= y.min() and y.max() <= y_hi and x_lo <= x.min() and x.max() <= x_hi, r
        assert 0 <= y_lo and y_hi < level_hw[lv][0] and 0 <= x_lo and x_hi < level_hw[lv][1]

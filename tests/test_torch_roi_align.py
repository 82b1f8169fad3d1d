"""The port's RoIAlign (plain version of the CUDA kernel) against the JAX
package: the XLA gather path (reference routing) at f32 atol 1e-5, and
the Pallas window kernel (interpret=True) at atol 1e-4 on RoIs that its
window-fit routing leaves on their mmdet level (its separable-matmul
pooling sums in another order, tests/test_pallas_ops.py:68-70)."""
import jax.numpy as jnp
import numpy as np
import torch

from nsgp_repre_tpu.ops.roi_align import multilevel_roi_align as jax_roi_align
from nsgp_repre_tpu.ops.roi_align_pallas import multilevel_roi_align_pallas, route_levels

from nsgp_repre_tpu_torch.ops.roi_align import map_roi_levels, multilevel_roi_align
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

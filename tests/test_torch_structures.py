"""Parity of the port's box ops, anchors, top-k and sample containers
against the JAX package (exact, or atol 1e-5 where float ops differ)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.ops.anchors import AnchorGenerator as JaxAnchors
from nsgp_repre_tpu.structures import boxes as jboxes
from nsgp_repre_tpu.structures.sample import pad_instances as jax_pad

from nsgp_repre_tpu_torch.ops.anchors import AnchorGenerator
from nsgp_repre_tpu_torch.ops.topk import top_k
from nsgp_repre_tpu_torch.structures import boxes as tboxes
from nsgp_repre_tpu_torch.structures.sample import pad_instances


def _boxes(rng, n, canvas=100.0):
    xy = rng.uniform(-10, canvas, (n, 2)).astype(np.float32)
    wh = rng.uniform(0, 60, (n, 2)).astype(np.float32)
    b = np.concatenate([xy, xy + wh], -1)
    b[: n // 8] = 0.0  # padded (zero-area) rows
    return b


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_bbox_overlaps(mode):
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 24), _boxes(rng, 40)
    ref = np.asarray(jboxes.bbox_overlaps(jnp.asarray(a), jnp.asarray(b), mode=mode))
    got = tboxes.bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b), mode=mode).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_bbox2delta_delta2bbox_roundtrip_and_parity():
    rng = np.random.RandomState(1)
    p, g = _boxes(rng, 64)[8:], _boxes(rng, 64)[8:]
    stds = (0.1, 0.1, 0.2, 0.2)
    ref_d = np.asarray(jboxes.bbox2delta(jnp.asarray(p), jnp.asarray(g), stds=stds))
    got_d = tboxes.bbox2delta(torch.from_numpy(p), torch.from_numpy(g), stds=stds).numpy()
    np.testing.assert_allclose(got_d, ref_d, atol=1e-5, rtol=1e-6)
    # extreme deltas exercise the wh_ratio_clip clamp; max_shape clips
    d = rng.uniform(-8, 8, (56, 12)).astype(np.float32)
    ref_b = np.asarray(jboxes.delta2bbox(jnp.asarray(p), jnp.asarray(d), stds=stds,
                                         max_shape=(70, 90)))
    got_b = tboxes.delta2bbox(torch.from_numpy(p), torch.from_numpy(d), stds=stds,
                              max_shape=(70, 90)).numpy()
    np.testing.assert_allclose(got_b, ref_b, atol=1e-5, rtol=1e-6)
    # round trip on gts near their proposals (inside the ratio clamp)
    wide = p[((p[:, 2] - p[:, 0]) > 8) & ((p[:, 3] - p[:, 1]) > 8)]
    p = wide
    near = p + rng.uniform(-3, 3, p.shape).astype(np.float32)
    enc = tboxes.bbox2delta(torch.from_numpy(p), torch.from_numpy(near), stds=stds)
    back = tboxes.delta2bbox(torch.from_numpy(p), enc, stds=stds).numpy()
    np.testing.assert_allclose(back, near, atol=1e-3)


def test_delta2bbox_per_image_max_shape():
    """(B, 1, 1) clip shapes give each image its own bounds, as the JAX
    function does per image under vmap."""
    rng = np.random.RandomState(2)
    rois = np.stack([_boxes(rng, 16)[2:] for _ in range(2)])
    d = rng.uniform(-2, 2, (2, 14, 8)).astype(np.float32)
    shapes = np.array([[50, 60], [80, 40]], np.float32)
    ref = np.stack([
        np.asarray(jboxes.delta2bbox(jnp.asarray(rois[i]), jnp.asarray(d[i]),
                                     max_shape=tuple(shapes[i])))
        for i in range(2)
    ])
    s = torch.from_numpy(shapes)
    got = tboxes.delta2bbox(torch.from_numpy(rois), torch.from_numpy(d),
                            max_shape=(s[:, 0].view(2, 1, 1), s[:, 1].view(2, 1, 1))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)


def test_bbox_clip():
    b = _boxes(np.random.RandomState(3), 32)
    ref = np.asarray(jboxes.bbox_clip(jnp.asarray(b), (50, 70)))
    np.testing.assert_array_equal(tboxes.bbox_clip(torch.from_numpy(b), (50, 70)).numpy(), ref)


def test_anchors_exact():
    sizes = [(38, 64), (19, 32), (10, 16), (5, 8), (3, 4)]
    ja, ta = JaxAnchors(), AnchorGenerator()
    for x, y in zip(ja.grid_anchors(sizes), ta.grid_anchors(sizes)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(ja.valid_flags(sizes, (130, 250)), ta.valid_flags(sizes, (130, 250))):
        np.testing.assert_array_equal(x, y)


def test_top_k_tie_order_matches_jax():
    """bf16-rounded scores tie often; ties must come out lowest index
    first, as jax.lax.top_k orders them."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 500).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    assert len(np.unique(x[0])) < 500  # ties present
    jv, ji = jax.lax.top_k(jnp.asarray(x), 64)
    tv, ti = top_k(torch.from_numpy(x), 64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_pad_instances():
    rng = np.random.RandomState(5)
    b, lab, sc = _boxes(rng, 5), np.arange(5), rng.rand(5)
    j, t = jax_pad(b, lab, 8, sc), pad_instances(b, lab, 8, sc)
    for name in ("boxes", "labels", "valid", "scores"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.capacity == 8 and int(t.num_valid()) == 5

"""The port's NMS against the JAX package's, and the CUDA kernel's
algorithm (sorted candidates + suppression bitmask + greedy sweep)
emulated in numpy on the wrapper's own preprocessing.

Keep lists must be identical in their valid slots: NMS is discrete, and
both sides compute each IoU in the same operation order in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.ops.nms import batched_nms as jax_batched_nms
from nsgp_repre_tpu.ops.nms import nms as jax_nms
from nsgp_repre_tpu.ops.nms_pallas import nms_pallas

from nsgp_repre_tpu_torch.ops import nms as tnms
from nsgp_repre_tpu_torch.ops.nms_cuda import batched_nms, sort_candidates


def _inputs(seed, B=2, N=300, canvas=120.0, ties=False):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, canvas, (B, N, 2)).astype(np.float32)
    wh = rng.uniform(4, 40, (B, N, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.rand(B, N).astype(np.float32)
    if ties:
        scores = np.round(scores * 8) / 8  # 9 distinct values
        boxes[:, 1::7] = boxes[:, ::7][:, : boxes[:, 1::7].shape[1]]  # duplicate boxes
        # a pair at exactly IoU 0.5 (area 100 inside area 200): kept at thr 0.5
        boxes[:, 0] = [0, 0, 10, 20]
        boxes[:, 1] = [0, 0, 10, 10]
        scores[:, :2] = 1.0
    valid = rng.rand(B, N) > 0.15
    idxs = rng.randint(0, 4, (B, N)).astype(np.int32)
    return boxes, scores, valid, idxs


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_same_keeps(ti, tv, ji, jv):
    ti, tv, ji, jv = (np.asarray(a) for a in (ti, tv, ji, jv))
    np.testing.assert_array_equal(tv, jv)
    for b in range(tv.shape[0]):
        np.testing.assert_array_equal(ti[b][tv[b]], ji[b][jv[b]])


@pytest.mark.parametrize("ties", [False, True])
def test_plain_nms_matches_pallas_interpret(ties):
    boxes, scores, valid, _ = _inputs(0, ties=ties)
    ji, jv = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                        0.5, 40, interpret=True)
    ti, tv = tnms.nms(_t(boxes), _t(scores), _t(valid), 0.5, 40)
    if not ties:  # the Pallas wrapper orders equal scores arbitrarily
        _assert_same_keeps(ti, tv, ji, jv)
    else:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        for b in range(2):
            assert set(ti[b][tv[b]].tolist()) == set(np.asarray(ji[b])[np.asarray(jv[b])].tolist())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("max_out", [16, 400])
def test_batched_nms_matches_jax_xla(ties, max_out):
    """Per-image group offsets (ops/nms.py:190 under vmap), pick order,
    lowest index first among equal scores, 0 in unused slots."""
    boxes, scores, valid, idxs = _inputs(1, ties=ties)
    boxes[1] *= 3.0  # the two images' offsets differ
    ji, jv = jax.vmap(lambda b, s, i, v: jax_batched_nms(b, s, i, v, 0.5, max_out))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(idxs), jnp.asarray(valid))
    ti, tv = batched_nms(_t(boxes), _t(scores), _t(idxs), _t(valid), 0.5, max_out)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_single_image_nms_matches_jax():
    boxes, scores, valid, _ = _inputs(2, B=1, N=200)
    ji, jv = jax_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), jnp.asarray(valid[0]),
                     0.7, 64)
    ti, tv = tnms.nms(_t(boxes), _t(scores), _t(valid), 0.7, 64)
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))


def _sweep(sorted_boxes, order, n_valid, thr, max_out, block=64):
    """numpy emulation of csrc/nms.cu: upper-triangle suppression bits in
    64-wide words, then a block-by-block greedy sweep that stops at
    max_out keeps. IoU in the kernel's operation order, in f32."""
    B, N = order.shape
    keep = np.zeros((B, max_out), np.int32)
    count = np.zeros(B, np.int32)
    f = np.float32
    for b in range(B):
        nv = int(n_valid[b])
        bx = sorted_boxes[b].astype(f)
        area = (bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1])
        removed = np.zeros(N, bool)
        for i in range(nv):
            if count[b] >= max_out:
                break
            if removed[i]:
                continue
            keep[b, count[b]] = order[b, i]
            count[b] += 1
            a = bx[i]
            iw = np.maximum(np.minimum(a[2], bx[:, 2]) - np.maximum(a[0], bx[:, 0]), f(0))
            ih = np.maximum(np.minimum(a[3], bx[:, 3]) - np.maximum(a[1], bx[:, 1]), f(0))
            inter = iw * ih
            union = np.maximum(area[i] + area - inter, f(1e-6))
            sup = inter / union > f(thr)
            sup[: i + 1] = False
            removed |= sup
    return keep, np.arange(max_out)[None, :] < count[:, None]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("max_out", [10, 300])
def test_kernel_algorithm_matches_plain(ties, max_out):
    boxes, scores, valid, idxs = _inputs(3, ties=ties)
    shifted = tnms.offset_boxes(_t(boxes), _t(idxs), _t(valid))
    sb, order, nv = sort_candidates(shifted, _t(scores), _t(valid))
    ki, kv = _sweep(sb.numpy(), order.numpy(), nv.numpy(), 0.5, max_out)
    ti, tv = tnms.nms(shifted, _t(scores), _t(valid), 0.5, max_out)
    np.testing.assert_array_equal(kv, tv.numpy())
    np.testing.assert_array_equal(ki, ti.numpy())

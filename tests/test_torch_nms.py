"""The port's NMS against the JAX package's, and the CUDA kernel's
algorithm (sorted candidates walked in 64-box row blocks against the
kept set, with its division-skip IoU rule) emulated in numpy on the
wrapper's own preprocessing.

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

from nms_edge_pairs import edge_pairs, iou_f32


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


F = np.float32
KHI, KLO = F(1 + 2.0 ** -20), F(1 - 2.0 ** -20)  # csrc/nms.cu kHi, kLo


def _suppresses(a, b, thr, stats):
    """csrc/nms.cu::suppresses in numpy f32, broadcast over a (the earlier
    box) and b: the zero-intersection and multiply tests, the division
    only inside their band. Counts the IoUs and the divisions."""
    thr = F(thr)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = np.maximum(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), F(0))
    ih = np.maximum(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), F(0))
    inter = iw * ih
    uni = np.maximum(area_a + area_b - inter, F(1e-6))
    p = thr * uni
    normal = (p >= F(2.0 ** -100)) & (p <= F(2.0 ** 100))
    above = normal & (inter > p * KHI)
    below = normal & (inter < p * KLO)
    zero = inter == 0
    band = ~zero & ~above & ~below
    exact = np.where(band, inter / np.where(band, uni, F(1)), F(0)) > thr
    stats["ious"] += inter.size
    stats["divisions"] += int(band.sum())
    return np.where(zero, F(0) > thr, above | (band & exact))


def _resolve(alive, earlier):
    """csrc/nms.cu's resolve of one row block, in rounds: every live
    candidate that no live earlier candidate suppresses is kept, and the
    candidates those keeps suppress die. earlier[t, s]: s < t suppresses t."""
    keep = np.zeros_like(alive)
    earlier = earlier & alive[:, None]
    while alive.any():
        sure = alive & ~(earlier & alive[None, :]).any(1)
        assert sure.any()  # the lowest live candidate is always sure
        killed = (earlier & sure[None, :]).any(1)
        keep |= sure
        alive = alive & ~sure & ~killed
    return keep


def _walk(sorted_boxes, order, n_valid, thr, max_out, stats=None, row=64, cs=1):
    """numpy emulation of csrc/nms.cu's schedule: per image, 64-candidate
    row blocks in sorted order; each candidate tested against the kept
    set, dealt round-robin over ``cs`` blocks of a cluster whose verdicts
    are ORed; the in-block pairs of the live candidates, resolved in
    rounds; keeps past max_out dropped; stop at max_out keeps or at the
    valid count. IoU decisions by the kernel's division-skip rule, in f32."""
    stats = {"ious": 0, "divisions": 0} if stats is None else stats
    B, N = order.shape
    keep = np.zeros((B, max_out), np.int32)
    count = np.zeros(B, np.int32)
    for b in range(B):
        nv = int(n_valid[b])
        bx = sorted_boxes[b].astype(F)
        kept = []
        for start in range(0, nv, row):
            if len(kept) >= max_out:
                break
            cand = bx[start:min(nv, start + row)]
            rows = len(cand)
            sup = np.zeros(rows, bool)
            for rank in range(cs):  # each block's share: keeps rank, rank + cs, ...
                share = kept[rank::cs]
                if share:
                    sup |= _suppresses(bx[share][:, None], cand[None], thr, stats).any(0)
            alive = ~sup
            t = np.arange(rows)
            live = cand[alive]
            pair = np.zeros((rows, rows), bool)  # [earlier, later]
            pair[np.ix_(alive, alive)] = _suppresses(live[:, None], live[None], thr, stats)
            pair &= t[None, :] > t[:, None]
            got = np.flatnonzero(_resolve(alive, pair.T))
            kept += [start + int(i) for i in got[:max_out - len(kept)]]
        count[b] = len(kept)
        keep[b, :len(kept)] = order[b, kept]
    return keep, np.arange(max_out)[None, :] < count[:, None]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("max_out", [10, 300])
def test_kernel_algorithm_matches_plain(ties, max_out):
    boxes, scores, valid, idxs = _inputs(3, ties=ties)
    shifted = tnms.offset_boxes(_t(boxes), _t(idxs), _t(valid))
    sb, order, nv = sort_candidates(shifted, _t(scores), _t(valid))
    ti, tv = tnms.nms(shifted, _t(scores), _t(valid), 0.5, max_out)
    for cs in (1, 8):  # one block per image, and a cluster of 8
        ki, kv = _walk(sb.numpy(), order.numpy(), nv.numpy(), 0.5, max_out, cs=cs)
        np.testing.assert_array_equal(kv, tv.numpy())
        np.testing.assert_array_equal(ki, ti.numpy())


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_division_skip_rule_is_exact(thr):
    """The kernel's rule decides every pair as fl(inter / uni) > thr does:
    random overlapping pairs, pairs at the threshold and one ulp on either
    side of it, disjoint and touching pairs, and degenerate boxes."""
    rng = np.random.RandomState(11)
    n = 20000
    xy = rng.uniform(0, 60, (2, n, 2)).astype(F)
    wh = rng.uniform(0, 50, (2, n, 2)).astype(F)
    wh[:, :200] = 0  # degenerate: zero area
    a = np.concatenate([xy[0], xy[0] + wh[0]], -1)
    b = np.concatenate([xy[1], xy[1] + wh[1]], -1)
    b[200:400] = a[200:400] + F(1e-3)  # near copies
    b[400:600, :2] = a[400:600, 2:]  # touching corners
    edges = edge_pairs(thr, 50)
    a = np.concatenate([a] + [e[0] for e in edges.values()])
    b = np.concatenate([b] + [e[1] for e in edges.values()])
    stats = {"ious": 0, "divisions": 0}
    got = _suppresses(a, b, thr, stats)
    np.testing.assert_array_equal(got, iou_f32(a, b) > F(thr))
    # the band is exercised (every edge pair needs the division) and narrow
    assert 150 <= stats["divisions"] < stats["ious"] // 20, stats
    for kind, (ea, eb) in edges.items():
        np.testing.assert_array_equal(_suppresses(ea, eb, thr, stats), kind == "above")


@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_walk_at_threshold_edges_matches_plain_and_jax(thr):
    """Pairs at the threshold and one ulp either side of it, spread apart
    so that only the two boxes of a pair overlap: the earlier boxes fill
    the first row block, so the later ones meet them through the row
    block's triangle and through the kept set. The emulated schedule, the
    plain version and JAX keep the same boxes: the later box of a pair
    only where its IoU is at or below the threshold."""
    n_each = 12
    firsts, seconds, kinds = [], [], []
    for i, kind in enumerate(("at", "above", "below")):
        for j in range(n_each):
            slot = i * n_each + j
            ea, eb = edge_pairs(thr, 1, seed=slot, x0=150.0 * slot)[kind]
            firsts.append(ea[0])
            seconds.append(eb[0])
            kinds.append(kind)
    P = len(firsts)
    boxes = np.stack(firsts + seconds)[None]
    rng = np.random.RandomState(4)
    scores = np.concatenate([rng.uniform(0.9, 1.0, P), rng.uniform(0.1, 0.5, P)]).astype(F)[None]
    perm = rng.permutation(2 * P)
    boxes, scores = boxes[:, perm], scores[:, perm]
    valid = np.ones((1, 2 * P), bool)
    ti, tv = tnms.nms(_t(boxes), _t(scores), _t(valid), thr, 2 * P)
    sb, order, nv = sort_candidates(_t(boxes), _t(scores), _t(valid))
    stats = {"ious": 0, "divisions": 0}
    ki, kv = _walk(sb.numpy(), order.numpy(), nv.numpy(), thr, 2 * P, stats, cs=8)
    np.testing.assert_array_equal(kv, tv.numpy())
    np.testing.assert_array_equal(ki, ti.numpy())
    ji, jv = jax_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), jnp.asarray(valid[0]),
                     thr, 2 * P)
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    kept = set(ti[0][tv[0]].tolist())
    inv = np.argsort(perm)  # original position -> shuffled index
    for p, kind in enumerate(kinds):
        assert int(inv[p]) in kept
        assert (int(inv[P + p]) in kept) == (kind != "above"), kind
    assert stats["divisions"] >= P  # every pair decided inside the band

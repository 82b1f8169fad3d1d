"""The port's anchor assignment (plain version of the assign kernel) and
MaxIoU assigner against the JAX package.

The fixture is that of tests/test_pallas_ops.py's assign test: random
anchors and gts, gt 1 a copy of gt 0 (exact IoU ties in the argmax and
in the low-quality claims), padded gts and invalid anchors. ``assigned``
is equal and ``max_overlaps`` bit-equal to the Pallas kernel in
interpret mode and to ``max_iou_assign``; the regression targets agree
within 1e-6 (the same float32 operations; ``log`` may round one ulp
apart between XLA and PyTorch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.models.assigners import max_iou_assign as jax_max_iou_assign
from nsgp_repre_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from nsgp_repre_tpu.ops.assign_pallas import rpn_assign_targets_pallas

from nsgp_repre_tpu_torch.models.assigners import IGNORE, NEG, max_iou_assign
from nsgp_repre_tpu_torch.ops.assign_cuda import rpn_assign_targets, rpn_assign_targets_plain

THR = (0.7, 0.3, 0.3)  # pos, neg, min_pos (the RPN assigner)


def _fixture(seed=0, B=3, G=5, N=700):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 80, (N, 2)).astype(np.float32)
    wh = rng.uniform(4, 40, (N, 2)).astype(np.float32)
    anchors = np.concatenate([xy, xy + wh], -1)
    gxy = rng.uniform(0, 80, (B, G, 2)).astype(np.float32)
    gwh = rng.uniform(4, 50, (B, G, 2)).astype(np.float32)
    gt = np.concatenate([gxy, gxy + gwh], -1)
    gt[:, 1] = gt[:, 0]  # exact ties
    gt_valid = rng.rand(B, G) > 0.3
    gt_valid[:, :2] = True  # both tied copies take part
    gt_valid[-1] = False  # an image without gts
    prior_valid = rng.rand(B, N) > 0.1
    return anchors, gt, gt_valid, prior_valid


def _t(x):
    return torch.from_numpy(np.array(x))


def _check(got, ref, tgt_atol=1e-6):
    assigned, maxov, tgt = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(got[0].numpy(), assigned)
    np.testing.assert_array_equal(got[1].numpy(), maxov)  # bit-equal
    np.testing.assert_allclose(got[2].numpy(), tgt, rtol=1e-6, atol=tgt_atol)


def _jax_reference(anchors, gt, gt_valid, prior_valid):
    """max_iou_assign + one-hot gather + bbox2delta, as detector.py does
    off the TPU."""
    from nsgp_repre_tpu.structures.boxes import bbox2delta

    a = jnp.asarray(anchors)

    def one(gb, gv, pv):
        assigned, maxov = jax_max_iou_assign(a, gb, gv, *THR, match_low_quality=True,
                                             prior_valid=pv)
        onehot = jax.nn.one_hot(jnp.clip(assigned, 0), gb.shape[0], dtype=jnp.float32)
        return assigned, maxov, bbox2delta(a, onehot @ gb)

    return jax.vmap(one)(jnp.asarray(gt), jnp.asarray(gt_valid), jnp.asarray(prior_valid))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_interpret(seed):
    anchors, gt, gt_valid, prior_valid = _fixture(seed)
    ref = rpn_assign_targets_pallas(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(gt_valid),
                                    jnp.asarray(prior_valid), *THR, interpret=True)
    got = rpn_assign_targets(_t(anchors), _t(gt), _t(gt_valid), _t(prior_valid), *THR)
    _check(got, ref)
    assigned = got[0].numpy()
    assert (assigned >= 0).any() and (assigned == NEG).any() and (assigned == IGNORE).any()
    assert (assigned[-1] != IGNORE).sum() == (assigned[-1] == NEG).sum()  # no gts: no positives


def test_plain_matches_jax_assigner_and_targets():
    anchors, gt, gt_valid, prior_valid = _fixture(2, B=2, G=9, N=1500)
    got = rpn_assign_targets_plain(_t(anchors), _t(gt), _t(gt_valid), _t(prior_valid), *THR)
    _check(got, _jax_reference(anchors, gt, gt_valid, prior_valid))


def test_ties_go_to_first_gt_in_argmax_and_last_in_claims():
    """gt 1 copies gt 0: an anchor above pos_thr is assigned gt 0 by the
    argmax, and the anchors a gt claims as its best go to gt 1."""
    anchors = np.array([[0, 0, 10, 10], [0, 0, 10, 9], [50, 50, 60, 60], [52, 50, 60, 60]],
                       np.float32)
    gt = np.array([[[0, 0, 10, 10], [0, 0, 10, 10], [51, 50, 60, 60]]], np.float32)
    gt_valid = np.ones((1, 3), bool)
    prior_valid = np.ones((1, 4), bool)
    got = rpn_assign_targets(_t(anchors), _t(gt), _t(gt_valid), _t(prior_valid), *THR)
    ref = rpn_assign_targets_pallas(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(gt_valid),
                                    jnp.asarray(prior_valid), *THR, interpret=True)
    _check(got, ref)
    # anchor 0 is the best anchor of gts 0 and 1 (IoU 1): the last claim wins;
    # anchor 1 (IoU 0.9 with both) takes the first gt by the argmax
    assert got[0][0].tolist()[:2] == [1, 0]


def test_rcnn_assigner_matches_jax():
    """The RoI head's assigner: no low-quality matching, invalid candidates
    ignored, both gt_max_assign_all settings of the low-quality path."""
    anchors, gt, gt_valid, prior_valid = _fixture(3, B=2, G=6, N=400)
    for low_quality, assign_all in ((False, True), (True, True), (True, False)):
        got = max_iou_assign(_t(anchors), _t(gt), _t(gt_valid), 0.5, 0.5, 0.5,
                             match_low_quality=low_quality, prior_valid=_t(prior_valid),
                             gt_max_assign_all=assign_all)
        for b in range(2):
            ref = jax_max_iou_assign(jnp.asarray(anchors), jnp.asarray(gt[b]),
                                     jnp.asarray(gt_valid[b]), 0.5, 0.5, 0.5,
                                     match_low_quality=low_quality,
                                     prior_valid=jnp.asarray(prior_valid[b]),
                                     gt_max_assign_all=assign_all)
            np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(ref[0]))
            np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(ref[1]))


def test_plain_on_detector_anchors_matches_pallas_interpret():
    """The anchors of an FPN pyramid (5 levels, 3 ratios) on a 128x192
    canvas, gts and validity as on the main path."""
    gen = JaxAnchorGenerator(strides=(4, 8, 16, 32, 64), ratios=(0.5, 1.0, 2.0), scales=(8,))
    sizes = [(-(-128 // s), -(-192 // s)) for s in (4, 8, 16, 32, 64)]
    anchors = np.concatenate(gen.grid_anchors(sizes), 0).astype(np.float32)
    rng = np.random.RandomState(7)
    B, G = 2, 8
    xy = rng.uniform(0, 120, (B, G, 2)).astype(np.float32)
    wh = rng.uniform(8, 90, (B, G, 2)).astype(np.float32)
    gt = np.concatenate([xy, np.minimum(xy + wh, [192, 128])], -1).astype(np.float32)
    gt_valid = np.arange(G)[None] < np.array([[3], [8]])
    prior_valid = rng.rand(B, len(anchors)) > 0.05
    ref = rpn_assign_targets_pallas(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(gt_valid),
                                    jnp.asarray(prior_valid), *THR, interpret=True)
    got = rpn_assign_targets(_t(anchors), _t(gt), _t(gt_valid), _t(prior_valid), *THR)
    _check(got, ref, tgt_atol=1e-5)
    assert int((got[0] >= 0).sum()) > 0


F = np.float32


def _iou_skip(g, a):
    """csrc/assign.cu::iou in numpy f32, (V, 1, 4) gts against (N, 4)
    anchors: bbox_overlaps' order, the division skipped where inter == 0."""
    area_g = (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1])
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    iw = np.maximum(np.minimum(g[..., 2], a[..., 2]) - np.maximum(g[..., 0], a[..., 0]), F(0))
    ih = np.maximum(np.minimum(g[..., 3], a[..., 3]) - np.maximum(g[..., 1], a[..., 1]), F(0))
    inter = iw * ih
    uni = np.maximum(area_g + area_a - inter, F(1e-6))
    return np.where(inter == 0, inter, inter / uni)


def _assign_emulated(anchors, gt, gt_valid, prior_valid, span, seed):
    """numpy emulation of csrc/assign.cu. Phase 1: the valid gts compacted
    in index order; each block of ``span`` anchors takes its per-gt maxima
    (anchors past N count -1 and are never folded) and folds them, blocks
    in a shuffled order, into a zeroed uint32 buffer by an unsigned max
    on the bits. Phase 2: the rules against the compacted gts and the
    buffer read back as floats."""
    pos_thr, neg_thr, min_pos = THR
    rng = np.random.RandomState(seed)
    B, G = gt_valid.shape
    N = len(anchors)
    nblk = -(-N // span)
    assigned = np.full((B, N), -2, np.int32)
    maxov = np.full((B, N), -1, F)
    for b in range(B):
        idx = np.flatnonzero(gt_valid[b])
        iou = _iou_skip(gt[b][idx][:, None], anchors)  # (V, N)
        padded = np.concatenate([iou, np.full((len(idx), nblk * span - N), -1, F)], 1)
        gmax = np.zeros(len(idx), np.uint32)
        for blk in rng.permutation(nblk):
            m = padded[:, blk * span:(blk + 1) * span].max(1, initial=F(-1))
            fold = m >= 0  # the -1 of a missing anchor is never folded
            bits = (m + F(0)).view(np.uint32)  # -0 -> +0
            gmax = np.where(fold, np.maximum(gmax, bits), gmax)
        gm = gmax.view(F)
        if len(idx):
            maxov[b] = iou.max(0)
            amax = idx[iou.argmax(0)]  # the first gt among ties
            claim = (iou == gm[:, None]) & (gm[:, None] >= F(min_pos))
            last = len(idx) - 1 - claim[::-1].argmax(0)  # the last claiming gt
            claimed = np.where(claim.any(0), idx[last], -1)
        else:
            amax, claimed = np.zeros(N, np.int64), np.full(N, -1)
        r = np.full(N, -2)
        r[(maxov[b] >= 0) & (maxov[b] < F(neg_thr))] = -1
        r = np.where(maxov[b] >= F(pos_thr), amax, r)
        r = np.where(claimed >= 0, claimed, r)
        assigned[b] = np.where(prior_valid[b], r, -2)
    return assigned, maxov


def test_float_bits_order_needs_the_sign_guard():
    """Non-negative floats order as their unsigned bits do, so an unsigned
    atomicMax folds IoUs exactly; the -1 sentinel's bits are larger than
    any IoU's, which is why the kernel never folds it."""
    x = np.sort(np.concatenate([np.random.RandomState(0).rand(5000).astype(F),
                                F([0, 1, 2 ** -149, 0.5, np.nextafter(F(0.5), F(1))])]))
    bits = x.view(np.uint32)
    assert (np.diff(bits.astype(np.int64)) >= 0).all()
    assert F(-1).view(np.uint32) > F(1).view(np.uint32)
    assert (F(-0.0) + F(0)).view(np.uint32) == 0


@pytest.mark.parametrize("case", ["fixture", "detector"])
@pytest.mark.parametrize("span", [1024, 64])
def test_atomic_max_schedule_matches_plain(case, span):
    """The emulated two-phase schedule against max_iou_assign (the plain
    version) and JAX's assigner: tied gts (first in the argmax, last in
    the claims), padded gts (IoU -1 in the plain version), an image with
    no valid gt, a gt equal to an anchor (IoU exactly 1), N not a
    multiple of the block."""
    if case == "fixture":
        anchors, gt, gt_valid, prior_valid = _fixture(5, B=3, G=7, N=2500)
    else:
        gen = JaxAnchorGenerator(strides=(4, 8, 16, 32, 64), ratios=(0.5, 1.0, 2.0), scales=(8,))
        sizes = [(-(-96 // s), -(-160 // s)) for s in (4, 8, 16, 32, 64)]
        anchors = np.concatenate(gen.grid_anchors(sizes), 0).astype(F)
        rng = np.random.RandomState(8)
        B, G = 3, 9
        xy = rng.uniform(0, 90, (B, G, 2)).astype(F)
        gt = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 70, (B, G, 2)), [160, 96])],
                            -1).astype(F)
        gt[:, 1] = gt[:, 0]
        gt[:, 2] = anchors[100]
        gt_valid = np.arange(G)[None] < np.array([[4], [9], [0]])
        prior_valid = rng.rand(B, len(anchors)) > 0.05
    assert len(anchors) % span
    ref_a, ref_m = max_iou_assign(_t(anchors), _t(gt), _t(gt_valid), *THR, match_low_quality=True,
                                  prior_valid=_t(prior_valid))
    got_a, got_m = _assign_emulated(anchors, gt, gt_valid, prior_valid, span, seed=span)
    np.testing.assert_array_equal(got_a, ref_a.numpy())
    np.testing.assert_array_equal(got_m.view(np.uint32), ref_m.numpy().view(np.uint32))
    jax_a, jax_m, _ = _jax_reference(anchors, gt, gt_valid, prior_valid)
    np.testing.assert_array_equal(got_a, np.asarray(jax_a))
    np.testing.assert_array_equal(got_m, np.asarray(jax_m))
    assert (got_a >= 0).any() and (got_m == -1).any()

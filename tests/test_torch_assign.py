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

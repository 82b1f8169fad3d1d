"""Slice parity for the task-end passes: the covariance taps and
make_cov_step, the NSGP projections, the RePRE RoI store and prototypes,
and the EWC importance, in the port against the JAX package.

Both sides run the SMALL task-1 detector (tests/torch_port_util.py,
rpn_num 64, rcnn_num 32) on the same seeded 64x96 images and gt boxes at
B = 2, in f32 on the CPU, with JAX's random draws (the samplers'
priorities, the RoI store's ranking) passed to the port.

Tolerances: covariances within 2e-5 of each matrix's largest entry (f32
sums of the same patch products in another order); projections from the
same covariances within n * 2**-24 of their largest entry (the same
float64 decomposition on both sides, then one f32 product whose entries
sum up to n terms, in another order by XLA and by PyTorch); stored RoI
features within 1e-5 of their largest magnitude, their labels, weights and ranking exact, targets and boxes
within 1e-4; prototypes bit-equal (the same numpy code); importance
within 2 * (2e-4 + the ReLU-flip slack of test_torch_task2.py) of its
largest entry (it is a squared gradient), the stored weights exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from nsgp_repre_tpu.engine import ewc as jax_ewc
from nsgp_repre_tpu.engine import nsgp as jax_nsgp
from nsgp_repre_tpu.engine import replay as jax_replay
from nsgp_repre_tpu.engine.runner import translate_ignore_keys as jax_translate
from nsgp_repre_tpu.engine.train import make_cov_step as jax_make_cov_step
from nsgp_repre_tpu.engine.train import make_roi_extract_step as jax_make_roi_extract_step
from nsgp_repre_tpu.engine.train import normalize_images as jax_normalize
from nsgp_repre_tpu.engine.train import total_loss as jax_total_loss
from nsgp_repre_tpu.testing import demo_det_batch as jax_demo_batch

from nsgp_repre_tpu_torch import testing as ttesting
from nsgp_repre_tpu_torch.engine import ewc, nsgp, replay
from nsgp_repre_tpu_torch.engine.runner import translate_ignore_keys
from nsgp_repre_tpu_torch.engine.train import (TrainState, make_cov_step, make_importance_step,
                                               make_roi_extract_step)
from nsgp_repre_tpu_torch.models.layers import CovConv, CovDense
from nsgp_repre_tpu_torch.utils.convert import port_name_from_jax
from torch_port_util import (PortReluInputs, capture_relu_inputs, f32_matmuls, flip_slack,
                             images, jax_and_port, jax_relu_inputs, loss_priorities, n_flips,
                             relu_flips)

HW = (64, 96)
B = 2
G = 4
OVERRIDES = dict(rpn_num=64, rcnn_num=32)
N_TASKS = 2
COV_REL = 2e-5
GRAD_REL = 2e-4
SEEDS = (0, 1)  # two batches
IGNORE = ["rpn", "roi_head"]  # the configs' ignore_keys


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads and two BLAS threads for this module: the suite
    runs six workers on a few cores, and these R-50-width CPU passes would
    otherwise take them all (numpy's float64 eigh on an oversubscribed
    BLAS ran ~18x slower here)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(2):
        yield
    torch.set_num_threads(before)


def _batches(seed):
    jb = jax_demo_batch(B, *HW, num_instances=(2, 3), num_classes=4, gt_capacity=G, seed=seed)
    tb = ttesting.demo_det_batch(B, *HW, num_instances=(2, 3), num_classes=4, gt_capacity=G,
                                 seed=seed)
    imgs = images((B,) + HW, seed=seed)
    return jb.replace(images=jnp.asarray(imgs)), tb.replace(images=torch.from_numpy(imgs))


@pytest.fixture(scope="module")
def small():
    f32_matmuls()
    model, variables, port = jax_and_port(HW, seed=0, jit_init=True, **OVERRIDES)
    return model, variables, port


@pytest.fixture(scope="module")
def covs(small):
    """One covariance pass on both sides: JAX's dict (numpy) and the port's."""
    model, variables, port = small
    jb, tb = _batches(0)
    rng = jax.random.PRNGKey(42)
    jcov = jax_nsgp.cov_collection_to_param_names(jax_make_cov_step(model)(variables, jb, rng))
    pcov = make_cov_step(port)(tb, priorities=loss_priorities(rng, port.config, B, HW, G))
    return {k: np.asarray(v) for k, v in jcov.items()}, pcov


def test_cov_step_matches_jax(covs, small):
    """The same keys (JAX's parameter paths: every conv and dense layer
    the loss runs, the RPN head's dense call summed over the 5 levels,
    the bbox head's torch-order input) and values; no tap is left on a
    layer after the pass."""
    jcov, pcov = covs
    assert set(pcov) == set(jcov)
    assert "rpn_head/rpn_conv/kernel" in pcov and "bbox_head/fc_cls_bg/kernel" in pcov
    assert pcov["bbox_head/shared_fc1/kernel"].shape == (12544, 12544)
    assert pcov["backbone/layer2_0/conv2/kernel"].shape == (128 * 9, 128 * 9)
    for k, ref in jcov.items():
        got = pcov[k].numpy()
        scale = np.abs(ref).max()
        assert scale > 0, k
        err = np.abs(got - ref).max()
        assert err <= COV_REL * scale, (k, err, scale)
    _, _, port = small
    for m in port.modules():
        if isinstance(m, (CovConv, CovDense)):
            assert m.cov_tap is None and "cov_tap" not in vars(m)


def test_threshold_functions_match_jax():
    rng = np.random.RandomState(0)
    for n in (40, 128, 300, 1152):
        svals = np.sort(np.abs(rng.randn(n)) ** 3 * np.exp(-np.arange(n) / (n / 8)))[::-1]
        for offset in (0.0, 0.1, -0.3, 3, -7):
            assert nsgp.adaptive_threshold_index(svals, offset) == \
                jax_nsgp.adaptive_threshold_index(svals, offset), (n, offset)
            np.testing.assert_array_equal(nsgp.null_space_mask(svals, offset),
                                          jax_nsgp.null_space_mask(svals, offset))
        np.testing.assert_array_equal(nsgp.fixed_threshold_mask(svals, 1.5),
                                      jax_nsgp.fixed_threshold_mask(svals, 1.5))
    a = {"x": torch.ones(2, 2)}
    total = nsgp.accumulate_cov(nsgp.accumulate_cov(None, a), a)
    assert torch.equal(total["x"], torch.full((2, 2), 2.0))


@pytest.mark.parametrize("adaptive,offset", [(True, 0.0), (True, 0.2), (False, 0.0)])
def test_build_transforms_match_jax(covs, adaptive, offset):
    """P = V·Vᵀ (never V: its signs and degenerate bases are free) from the
    same covariances: the ignore patterns of the configs' ignore_keys skip
    the RPN and RoI heads; backbone projections are Frobenius-normalized.
    The 14 layers of up to 600 inputs (64 to 576: both sides of the
    Gaussian smoothing's 128) are decomposed here; layer4's 4608 takes
    tens of seconds per side on one core, and the card check runs all of
    R-50."""
    jcov, pcov = covs
    patterns = translate_ignore_keys(IGNORE)
    assert patterns == jax_translate(IGNORE)
    sub = {k: v for k, v in jcov.items() if v.shape[0] <= 600 or k.startswith(("rpn", "bbox"))}
    got = nsgp.build_transforms(sub, offset=offset, ignore_patterns=patterns, adaptive=adaptive)
    ref = jax_nsgp.build_transforms(sub, offset=offset, ignore_patterns=patterns,
                                    adaptive=adaptive)
    assert set(got) == set(ref) and len(got) == 14
    assert not any(k.startswith(("rpn_head", "bbox_head")) for k in got)
    for k, r in ref.items():
        r = np.asarray(r)
        g = got[k].numpy()
        assert g.dtype == np.float32 and g.shape == r.shape
        assert np.abs(g - r).max() <= r.shape[0] * 2 ** -24 * np.abs(r).max(), k
        if k.startswith("backbone"):
            np.testing.assert_allclose(np.linalg.norm(g.astype(np.float64)), 1.0,
                                       rtol=g.shape[0] * 2 ** -24)
    # a torch covariance gives the numpy one's projection
    k = "backbone/layer2_0/conv1/kernel"
    again = nsgp.build_transforms({k: torch.from_numpy(sub[k])}, offset=offset, adaptive=adaptive)
    assert torch.equal(again[k], got[k])


def _roi_draws(rng, cfg):
    """JAX's draws in get_bbox_stuff: split(rng, 3) → k1 (unused: no RPN
    loss), k2 (the sampler's, per image), k3 (the ranking, B * rcnn_num)."""
    _, k2, k3 = jax.random.split(rng, 3)
    n = G + cfg.rpn_max_per_img
    keys = jax.random.split(k2, B)
    roi = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    roi2 = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (n,))) for k in keys])
    cap = np.asarray(jax.random.uniform(k3, (B * cfg.rcnn_num,)))
    return {"roi": torch.from_numpy(roi), "roi2": torch.from_numpy(roi2),
            "cap": torch.from_numpy(cap)}


@pytest.fixture(scope="module")
def rois(small):
    model, variables, port = small
    jstep = jax_make_roi_extract_step(model)
    pstep = make_roi_extract_step(port)
    out = []
    for seed in SEEDS:
        jb, tb = _batches(seed)
        rng = jax.random.PRNGKey(7 + seed)
        ref = [np.asarray(x) for x in jstep(variables, jb, rng)]
        got = [x.numpy() for x in pstep(tb, priorities=_roi_draws(rng, port.config))]
        out.append((got, ref))
    return out


def test_roi_extract_matches_jax(rois):
    """get_bbox_stuff's 5 RoIs per batch: f32 features in torch (C, H, W)
    order, labels, cls weights, targets, bbox weights, rois, validity."""
    for got, ref in rois:
        assert [g.shape for g in got] == [r.shape for r in ref]
        assert got[0].shape == (5, 12544) and got[0].dtype == np.float32
        assert np.abs(got[0] - ref[0]).max() <= 1e-5 * np.abs(ref[0]).max()
        for i in (1, 2, 4, 6):
            np.testing.assert_array_equal(got[i], ref[i])
        np.testing.assert_allclose(got[3], ref[3], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[5], ref[5], rtol=1e-5, atol=1e-4)
        assert got[4].any()  # foreground RoIs ranked first


def test_prototypes_match_jax(rois):
    """build_prototypes (coarse + greedy cosine clusters, and again from the
    saved cluster masks), build_coarse_prototypes and subsample_per_class
    give the JAX package's arrays bit for bit: on clustered seeded
    features, and on the stored RoI features of the extract step."""
    rng = np.random.RandomState(4)
    centers = rng.randn(8, 12544).astype(np.float32)
    labels = rng.randint(0, 4, 120)
    feats = (centers[rng.randint(0, 8, 120)] + 0.6 * rng.randn(120, 12544)).astype(np.float32)
    stored = np.concatenate([g[0] for g, _ in rois])
    stored_labels = np.concatenate([g[1] for g, _ in rois])
    for f, lab in ((feats, labels), (stored, stored_labels)):
        got = replay.build_prototypes(f, lab, (0, 4, 6), 2, max_prototype=10)
        ref = jax_replay.build_prototypes(f, lab, (0, 4, 6), 2, max_prototype=10)
        if f is feats:  # fine prototypes beyond one coarse per class
            assert len(got[0]) > len(np.unique(lab))
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        again = replay.build_prototypes(f, lab, (0, 4, 6), 2, max_prototype=10, saved_masks=got[2])
        np.testing.assert_array_equal(again[0], got[0])
        for g, r in zip(replay.build_coarse_prototypes(f, lab, (0, 4, 6), 2),
                        jax_replay.build_coarse_prototypes(f, lab, (0, 4, 6), 2)):
            np.testing.assert_array_equal(g, r)
        for g, r in zip(replay.subsample_per_class([f, lab], lab, 3, num_classes=6),
                        jax_replay.subsample_per_class([f, lab], lab, 3, num_classes=6)):
            np.testing.assert_array_equal(g, r)


def test_importance_matches_jax(small):
    """Two batches of make_importance_step on the task-1 state, then
    accumulate_importance and append_task_terms: every BN's terms (the
    port's 34 at this depth, the frozen stem and layer1 included, whose
    importance is 0 on both sides at task 1: no term reaches them). The
    JAX side is make_importance_step's function at task 1 (train.py:
    323-341 with no teacher, replay or EWC term: jax.grad of the total
    loss over every parameter), jitted once with the ReLU inputs as its
    auxiliary output for the flip count."""
    model, variables, port = small
    cfg = port.config

    @jax.jit
    def jax_grads(params, batch, rng):
        batch = batch.replace(images=jax_normalize(batch.images))

        def loss_fn(p):
            losses, s = model.apply({"params": p, "batch_stats": variables["batch_stats"]}, batch,
                                    rng, method=model.loss,
                                    capture_intermediates=capture_relu_inputs,
                                    mutable=["intermediates"])
            return jax_total_loss(losses), s["intermediates"]

        return jax.grad(loss_fn, has_aux=True)(params)

    pstep = make_importance_step(port)
    tstate = TrainState(None)
    jimp = jax_ewc.init_importance(variables["params"])
    params = dict(port.named_parameters())
    pimp = ewc.init_importance(params)
    flips = []
    for seed in SEEDS:
        jb, tb = _batches(seed)
        rng = jax.random.PRNGKey(42 + seed)
        jg, inter = jax_grads(variables["params"], jb, rng)
        jimp = jax_ewc.accumulate_importance(jimp, jg, B, len(SEEDS))
        with PortReluInputs(port) as rec:
            grads = pstep(tstate, tb, priorities=loss_priorities(rng, cfg, B, HW, G))
        flips.append(relu_flips(jax_relu_inputs([inter]), rec.out))
        pimp = ewc.accumulate_importance(pimp, grads, B, len(SEEDS))
    assert sum(n_flips(f) for f in flips) <= 4, flips
    jterms = jax_ewc.append_task_terms({}, jimp, variables["params"])
    pterms = ewc.append_task_terms({}, pimp, params)
    assert len(pterms) == 34
    assert {port_name_from_jax(k, N_TASKS) for k in jterms} == set(pterms)
    for k, (imp, old) in jterms.items():
        name = port_name_from_jax(k, N_TASKS)
        got_imp, got_old = pterms[name]
        np.testing.assert_array_equal(got_old.numpy(), np.asarray(old), err_msg=k)
        ref = np.asarray(imp)
        if name.startswith(("backbone.bn1.", "backbone.layer1.")):
            assert not ref.any() and not got_imp.any(), name
            continue
        scale = np.abs(ref).max()
        assert scale > 0, name
        slack = sum(flip_slack(f, name) for f in flips)
        err = np.abs(got_imp.numpy() - ref).max()
        assert err <= 2 * (GRAD_REL + slack) * scale, (name, err, scale, flips)
    # the stored weights are the model's, copied
    name = "backbone.layer2.0.bn1.weight"
    assert torch.equal(pterms[name][1][0], params[name].detach())
    assert pterms[name][1].data_ptr() != params[name].data_ptr()


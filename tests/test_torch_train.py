"""Slice parity for training: the port's samplers, losses, task-1 loss,
gradients and train step against the JAX package.

Both sides run the same bridged weights (tests/torch_port_util.py, the
SMALL detector with rpn_num=64 and rcnn_num=32) on the same seeded
64x96 images and gt boxes at B = 2, in f32 on the CPU. JAX on the CPU
takes its XLA paths (detector.py:37-39): per-image max_iou_assign, XLA
NMS and the gather RoIAlign with reference routing. JAX's sampling
priorities are re-derived with the key splits of FasterRCNN.loss
(tests/test_grad_parity.py:206-236) and passed to the port, so both sides
sample the same anchors and RoIs.

Tolerances: the loss terms agree to rtol 1e-4 and every parameter
gradient to 2e-4 of its largest magnitude (the same f32 convolutions
summed in another order by XLA and by PyTorch, through the backward of
a 1-block-per-stage R-50 trunk); sampled sets are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.engine import optim as jax_optim
from nsgp_repre_tpu.engine.runner import build_optimizer as jax_build_optimizer
from nsgp_repre_tpu.engine.train import TrainState as JaxTrainState
from nsgp_repre_tpu.engine.train import make_lr_schedule as jax_lr_schedule
from nsgp_repre_tpu.engine.train import make_train_step as jax_make_train_step
from nsgp_repre_tpu.engine.train import normalize_images as jax_normalize
from nsgp_repre_tpu.engine.train import total_loss as jax_total_loss
from nsgp_repre_tpu.engine.train import trainable_mask as jax_trainable_mask
from nsgp_repre_tpu.models import losses as jax_losses
from nsgp_repre_tpu.models.samplers import random_sample_gather as jax_gather
from nsgp_repre_tpu.models.samplers import random_sample_masks as jax_masks
from nsgp_repre_tpu.testing import demo_det_batch as jax_demo_batch
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree
from nsgp_repre_tpu.utils.config import load_config as jax_load_config

from nsgp_repre_tpu_torch import testing as ttesting
from nsgp_repre_tpu_torch.engine.runner import build_train_optimizer
from nsgp_repre_tpu_torch.engine.train import (TrainState, make_train_step, normalize_images,
                                               trainable_mask)
from nsgp_repre_tpu_torch.models import losses as tlosses
from nsgp_repre_tpu_torch.models.detector import FasterRCNN
from nsgp_repre_tpu_torch.models.samplers import random_sample_gather, random_sample_masks
from nsgp_repre_tpu_torch.utils.config import load_config
from nsgp_repre_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_util import f32_matmuls, images, jax_and_port

HW = (64, 96)
B = 2
G = 4
OVERRIDES = dict(rpn_num=64, rcnn_num=32)
CFG = "cl_faster_rcnn_cfgs/incremental_task/cl_faster_rcnn_nsgp_repre_15_5_1.py"
LOSS_RTOL = 1e-4
GRAD_REL = 2e-4


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# samplers and losses
# ---------------------------------------------------------------------------

def _assigned(rng, n, n_pos, n_neg):
    a = np.full(n, -2, np.int32)
    idx = rng.permutation(n)
    a[idx[:n_pos]] = rng.randint(0, 5, n_pos)
    a[idx[n_pos:n_pos + n_neg]] = -1
    return a


@pytest.mark.parametrize("n_pos,n_neg", [(0, 700), (3, 900), (40, 40), (200, 2000), (30, 0)])
def test_sample_masks_match_jax(n_pos, n_neg):
    rng = np.random.RandomState(n_pos + n_neg)
    n, num, frac = 3000, 256, 0.5
    assigned = np.stack([_assigned(rng, n, n_pos, n_neg), _assigned(rng, n, n_pos // 2, n_neg)])
    keys = jax.random.split(jax.random.PRNGKey(n_pos), 2)
    u = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    got_p, got_n = random_sample_masks(_t(assigned), num, frac, _t(u))
    for i in range(2):
        ref_p, ref_n = jax_masks(keys[i], jnp.asarray(assigned[i]), num, frac)
        np.testing.assert_array_equal(got_p[i].numpy(), np.asarray(ref_p))
        np.testing.assert_array_equal(got_n[i].numpy(), np.asarray(ref_n))
    assert int(got_p.sum(1).max()) <= num * frac
    assert int((got_p | got_n).sum(1).max()) <= num


@pytest.mark.parametrize("n,num", [(1064, 512), (200, 512), (90, 32)])
def test_sample_gather_matches_jax(n, num):
    """The gather order breaks the many f32 ties of ``2e6 + u2`` by the
    lowest index, as jax.lax.top_k does."""
    rng = np.random.RandomState(n)
    assigned = np.stack([_assigned(rng, n, n // 20, n // 2), _assigned(rng, n, 0, n // 3)])
    keys = jax.random.split(jax.random.PRNGKey(n), 2)
    u = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    u2 = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (n,))) for k in keys])
    got = random_sample_gather(_t(assigned), num, 0.25, _t(u), _t(u2))
    for i in range(2):
        ref = jax_gather(keys[i], jnp.asarray(assigned[i]), num, 0.25)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(r))
    assert bool(got[2].any())


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(300).astype(np.float32) * 4
    t = (rng.rand(300) > 0.6).astype(np.float32)
    w = (rng.rand(300) > 0.3).astype(np.float32)
    cls = rng.randn(64, 7).astype(np.float32) * 3
    labels = rng.randint(-1, 7, 64).astype(np.int32)
    lw = (rng.rand(64) > 0.2).astype(np.float32)
    pred, tgt = rng.randn(64, 4).astype(np.float32), rng.randn(64, 4).astype(np.float32)
    pairs = [
        (tlosses.weighted_sigmoid_bce(_t(logits), _t(t), _t(w), 37.0),
         jax_losses.weighted_sigmoid_bce(jnp.asarray(logits), jnp.asarray(t), jnp.asarray(w), 37.0)),
        (tlosses.weighted_softmax_ce(_t(cls), _t(labels), _t(lw), _t(np.float32(lw.sum()))),
         jax_losses.weighted_softmax_ce(jnp.asarray(cls), jnp.asarray(labels), jnp.asarray(lw),
                                        lw.sum())),
        (tlosses.weighted_l1(_t(pred), _t(tgt), _t(lw[:, None]), 0.0),
         jax_losses.weighted_l1(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(lw[:, None]), 0.0)),
        (tlosses.accuracy(_t(cls), _t(labels), _t(lw)),
         jax_losses.accuracy(jnp.asarray(cls), jnp.asarray(labels), jnp.asarray(lw))),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the detector loss, its gradients and the train step
# ---------------------------------------------------------------------------

def _batches(seed=0):
    """The same batch for both sides: seeded smooth images, 2 and 3 gt
    boxes with labels of task 1 (classes 0-3 of the SMALL split)."""
    jb = jax_demo_batch(B, *HW, num_instances=(2, 3), num_classes=4, gt_capacity=G, seed=seed)
    tb = ttesting.demo_det_batch(B, *HW, num_instances=(2, 3), num_classes=4, gt_capacity=G,
                                 seed=seed)
    imgs = images((B,) + HW, seed=seed)
    return jb.replace(images=jnp.asarray(imgs)), tb.replace(images=torch.from_numpy(imgs))


def _priorities(rng, port_cfg):
    """JAX's draws in FasterRCNN.loss: split(rng) → k1 (RPN: one key per
    image, uniform over the anchors) and k2 (RoI head: one key per image,
    u over gts + proposals, u2 from fold_in(key, 1))."""
    A = port_cfg.num_base_priors
    N = sum(-(-HW[0] // s) * -(-HW[1] // s) * A for s in port_cfg.anchor_strides)
    n = G + port_cfg.rpn_max_per_img
    k1, k2 = jax.random.split(rng)
    rpn = [jax.random.uniform(k, (N,)) for k in jax.random.split(k1, B)]
    roi_keys = jax.random.split(k2, B)
    roi = [jax.random.uniform(k, (n,)) for k in roi_keys]
    roi2 = [jax.random.uniform(jax.random.fold_in(k, 1), (n,)) for k in roi_keys]
    return {name: torch.from_numpy(np.stack([np.asarray(x) for x in v]))
            for name, v in (("rpn", rpn), ("roi", roi), ("roi2", roi2))}


def _port_grads(port):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for n, p in port.named_parameters()}


def _assert_grads(got, ref_flat, trainable):
    """Every gradient within GRAD_REL of its largest magnitude; every
    trainable parameter's gradient nonzero."""
    ref = {k: v.numpy() for k, v in state_dict_from_jax(ref_flat, {}).items()}
    assert ref.keys() == got.keys()
    for k in ref:
        scale = np.abs(ref[k]).max()
        assert (scale > 0) == trainable[k], k
        err = np.abs(got[k] - ref[k]).max()
        assert err <= GRAD_REL * max(scale, 1e-6), (k, err, scale)


@pytest.fixture(scope="module")
def runs():
    """Loss terms and gradients of both sides, both RPN loss paths."""
    f32_matmuls()
    out = {}
    jb, tb = _batches()
    jbn = jb.replace(images=jax_normalize(jb.images))
    tbn = tb.replace(images=normalize_images(tb.images))
    rng = jax.random.PRNGKey(42)
    for sparse in (True, False):
        model, variables, port = jax_and_port(HW, seed=0, rpn_sparse_loss=sparse, **OVERRIDES)

        def loss_fn(p):
            losses = model.apply({"params": p, "batch_stats": variables["batch_stats"]}, jbn, rng,
                                 method=model.loss)
            return jax_total_loss(losses), losses

        (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        port.zero_grad(set_to_none=True)
        tl = port.loss(tbn, priorities=_priorities(rng, port.config))
        sum(v for k, v in tl.items() if "loss" in k).backward()
        out[sparse] = dict(jax_losses={k: float(v) for k, v in jl.items()},
                           jax_grads=_flatten_tree(jax.device_get(jg)),
                           losses={k: float(v.detach()) for k, v in tl.items()},
                           grads=_port_grads(port),
                           trainable=trainable_mask(port, port.config))
    return out


@pytest.mark.parametrize("sparse", [True, False])
def test_loss_terms_match_jax(runs, sparse):
    got, ref = runs[sparse]["losses"], runs[sparse]["jax_losses"]
    assert set(got) == set(ref)
    for k in ref:
        assert np.isfinite(got[k]) and ref[k] != 0.0
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("sparse", [True, False])
def test_gradients_match_jax(runs, sparse):
    _assert_grads(runs[sparse]["grads"], runs[sparse]["jax_grads"], runs[sparse]["trainable"])


def test_sparse_and_dense_rpn_paths_agree(runs):
    """The sparse RPN loss path reproduces the dense one (JAX pins the
    same at tests/test_models.py:133)."""
    for k, v in runs[False]["losses"].items():
        np.testing.assert_allclose(runs[True]["losses"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    for k, v in runs[False]["grads"].items():
        scale = max(np.abs(v).max(), 1e-6)
        assert np.abs(runs[True]["grads"][k] - v).max() <= 1e-4 * scale, k


def test_frozen_parameters_get_no_gradient(runs):
    """The stem and layer1 (frozen_stages=1) and the future task's heads
    receive nothing, on both sides."""
    for name, g in runs[True]["grads"].items():
        if name.startswith(("backbone.conv1", "backbone.bn1", "backbone.layer1.",
                            "roi_head.bbox_head.fc_cls.1", "roi_head.bbox_head.fc_reg.1")):
            assert not g.any(), name


def _jax_cfg(cfg_path):
    """The main config with a two-step warm-up, so three steps run at
    three learning rates (2e-5, 0.01, 0.02) and move the weights."""
    cfg = jax_load_config(cfg_path)
    cfg["param_scheduler"][0]["end"] = 2
    return cfg


@pytest.mark.parametrize("clip", [None, 0.5])
def test_train_steps_match_jax(clip):
    """Three make_train_step steps on both sides, without and with global
    gradient-norm clipping: the optimizer each
    builds from the config (SGDNSCL, lr 0.02, momentum 0.9, weight decay
    1e-4, trainable mask), the same priorities per step. The weights
    match after every step within 2e-4 of each tensor's largest update
    plus 4 ulps of its largest weight (an update of 1e-6 on a weight of
    0.1 keeps only a few bits of the update), and the frozen ones do not
    move at all. The third step runs at lr 0.02 on these perturbed
    weights and its loss jumps (to ~53), which the two sides follow
    alike. Seed 0: at seed 1 the first update of the shared FCs already
    differs by 0.5% with identical proposals and sampled RoIs (an f32
    near-tie inside the head, not a sampling difference)."""
    f32_matmuls()
    model, variables, port = jax_and_port(HW, seed=0, **OVERRIDES)
    jb, tb = _batches(seed=0)
    steps_per_epoch = 100

    jcfg = _jax_cfg(CFG)
    opt_cfg = jcfg["optim_wrapper"]["optimizer"]
    sched = jax_lr_schedule(opt_cfg["lr"], steps_per_epoch, max_epochs=30, milestones=(8, 11),
                            gamma=0.1, warmup_iters=2)
    params = variables["params"]
    jopt = jax_optim.masked(jax_build_optimizer(opt_cfg, sched, params),
                            jax_trainable_mask(params, model.config))
    jstate = JaxTrainState(params=params, batch_stats=variables["batch_stats"],
                           opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))
    jstep = jax_make_train_step(model, jopt, donate=False, clip_grad_norm=clip)

    tcfg = load_config(CFG)
    tcfg["param_scheduler"][0]["end"] = 2
    topt = build_train_optimizer(tcfg, port, steps_per_epoch)
    tstate = TrainState(topt)
    tstep = make_train_step(port, topt, clip_grad_norm=clip)

    before = {k: v.clone() for k, v in port.state_dict().items()}
    trainable = {n for n, p in port.named_parameters() if p.requires_grad}
    start = {k: v.numpy().copy() for k, v in state_dict_from_jax(_flatten_tree(params), {}).items()}
    for t in range(3):
        rng = jax.random.PRNGKey(100 + t)
        jstate, jm = jstep(jstate, jb, rng)
        tstate, tm = tstep(tstate, tb, priorities=_priorities(rng, port.config))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        ref = {k: v.numpy() for k, v in
               state_dict_from_jax(_flatten_tree(jax.device_get(jstate.params)), {}).items()}
        moved = 0
        for name, p in port.named_parameters():
            if name not in trainable:
                assert torch.equal(p, before[name]), name
                continue
            delta = np.abs(ref[name] - start[name]).max()
            moved += delta > 0
            err = np.abs(p.detach().numpy() - ref[name]).max()
            ulps = 4 * np.spacing(np.abs(ref[name]).max())
            assert err <= GRAD_REL * delta + ulps, (t, name, err, delta)
        assert moved > 0.8 * len(trainable)
    assert tstate.step == 3 and topt.count == 3
    for name, buf in port.named_buffers():
        assert torch.equal(buf, before[name]), name


def test_train_step_is_seeded_and_runs_task2_terms():
    """With no priorities, the step draws them from the generator: the
    same seed gives the same step, with a task-1 state and with a task-2
    state (teacher in the step, prototypes, EWC terms), whose step reports
    the replay and EWC terms. (It replaces a test that a task-2 state
    raised: those terms are ported.)"""
    import dataclasses

    from nsgp_repre_tpu_torch.engine import ewc
    from nsgp_repre_tpu_torch.engine.runner import build_teacher

    cfg = ttesting.tiny_detector_config()
    tcfg = load_config(CFG)
    batch = ttesting.demo_det_batch(2, 64, 64, num_instances=(1, 3), num_classes=2,
                                    gt_capacity=4, seed=3)
    for task_id in (1, 2):
        results = []
        for _ in range(2):
            m = FasterRCNN(dataclasses.replace(cfg, task_id=task_id))
            m.init_weights(torch.Generator().manual_seed(0))
            opt = build_train_optimizer(tcfg, m, 10)
            state, teacher = TrainState(opt), None
            if task_id == 2:
                teacher = build_teacher(m)
                params = dict(m.named_parameters())
                imp = {k: torch.full_like(v, 0.5) for k, v in ewc.init_importance(params).items()}
                g = torch.Generator().manual_seed(1)
                state = TrainState(opt, teacher_params=dict(teacher.named_parameters()),
                                   replay_feats=torch.randn(3, 12544, generator=g),
                                   replay_labels=torch.tensor([0, 1, 1], dtype=torch.int32),
                                   ewc_terms=ewc.append_task_terms({}, imp, params))
                with torch.no_grad():  # off the stored weights, so EWC counts
                    m.backbone.layer2[0].bn1.bias.add_(0.1)
            step = make_train_step(m, opt, teacher_model=teacher)
            _, metrics = step(state, batch, torch.Generator().manual_seed(7))
            results.append({k: float(v) for k, v in metrics.items()})
        assert results[0] == results[1]
        assert all(np.isfinite(v) for v in results[0].values())
        if task_id == 2:
            assert results[0]["replay_loss_cls"] > 0 and results[0]["ewc_loss"] > 0


def test_split_loss_and_grads_equals_loss():
    """testing.split_loss_and_grads (the card-vs-CPU comparison's cut
    between the RPN and the RoI head) computes FasterRCNN.loss and its
    gradients exactly, with its own proposals or the same ones passed
    back in."""
    cfg = ttesting.tiny_detector_config()
    m = FasterRCNN(cfg).init_weights(torch.Generator().manual_seed(2))
    batch = ttesting.demo_det_batch(2, 64, 64, num_instances=(2, 1), num_classes=2,
                                    gt_capacity=4, seed=5)
    n = sum((-(-64 // s)) ** 2 * cfg.num_base_priors for s in cfg.anchor_strides)
    g = torch.Generator().manual_seed(6)
    pri = {"rpn": torch.rand(2, n, generator=g),
           "roi": torch.rand(2, 4 + cfg.rpn_max_per_img, generator=g)}
    pri["roi2"] = torch.rand(pri["roi"].shape, generator=g)
    losses, grads, props = ttesting.split_loss_and_grads(m, batch, pri)
    again, grads2, _ = ttesting.split_loss_and_grads(m, batch, pri, proposals=props)
    m.zero_grad(set_to_none=True)
    ref = m.loss(batch.replace(images=normalize_images(batch.images)), priorities=pri)
    sum(v for k, v in ref.items() if "loss" in k).backward()
    assert losses == again == {k: float(v.detach()) for k, v in ref.items()}
    ref_g = {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
    assert grads.keys() == grads2.keys() == ref_g.keys()
    for k in ref_g:
        assert torch.equal(grads[k], ref_g[k]) and torch.equal(grads2[k], ref_g[k]), k

"""The port's optimizers, schedule, paramwise multipliers, trainable mask
and parameter-name bridge against the JAX package.

The optimizers run on a small tree of detector-named parameters (a 3x3
conv, a 1x1 conv, a dense layer, biases and a norm scale) with random
gradients for three steps, with symmetric random projections P on the
conv and the dense kernel, installed by JAX parameter path on both
sides. Parameters agree within 1e-6 relative (the same float32 operation
order; ``b ** t`` and the square root round alike on both sides to
within an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.engine import optim as jax_optim
from nsgp_repre_tpu.engine.train import make_lr_schedule as jax_lr_schedule
from nsgp_repre_tpu.engine.train import trainable_mask as jax_trainable_mask
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree

from nsgp_repre_tpu_torch.engine import optim
from nsgp_repre_tpu_torch.engine.train import make_lr_schedule, trainable_mask
from nsgp_repre_tpu_torch.utils.convert import port_name_from_jax, state_dict_from_jax
from torch_port_util import jax_and_port

SHAPES = {
    "backbone/layer2_0/conv2/kernel": (3, 3, 8, 8),
    "backbone/layer2_0/bn2/scale": (8,),
    "backbone/layer2_0/bn2/bias": (8,),
    "neck/lateral_conv0/kernel": (1, 1, 16, 8),
    "neck/lateral_conv0/bias": (8,),
    "bbox_head/shared_fc1/kernel": (24, 12),
    "bbox_head/shared_fc1/bias": (12,),
}
PROJECTED = {"backbone/layer2_0/conv2/kernel": 72, "bbox_head/shared_fc1/kernel": 24}
N_TASKS = 2


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def _symmetric_projection(rng, n):
    """A projection onto a random 3/4-dimensional subspace (symmetric)."""
    q, _ = np.linalg.qr(rng.randn(n, n))
    basis = q[:, : 3 * n // 4]
    return (basis @ basis.T).astype(np.float32)


def _port(flat):
    return {k: v.numpy() for k, v in state_dict_from_jax(flat, {}).items()}


@pytest.mark.parametrize("kind", ["sgd", "adam", "adamw"])
def test_optimizer_matches_jax(kind):
    rng = np.random.RandomState({"sgd": 0, "adam": 1, "adamw": 2}[kind])
    flat = {k: rng.randn(*s).astype(np.float32) * 0.1 for k, s in SHAPES.items()}
    transforms = {k: _symmetric_projection(rng, n) for k, n in PROJECTED.items()}
    sched = jax_lr_schedule(0.02, 10, warmup_iters=2)
    port_sched = make_lr_schedule(0.02, 10, warmup_iters=2)
    if kind == "sgd":
        tx = jax_optim.sgd_nscl(sched, momentum=0.9, weight_decay=1e-4)
        make = lambda named: optim.sgd_nscl(named, port_sched, momentum=0.9, weight_decay=1e-4)
    else:
        wd = 1e-2 if kind == "adam" else 5e-2
        tx = jax_optim.adam_nscl(sched, weight_decay=wd, decoupled_wd=kind == "adamw")
        make = lambda named: optim.adam_nscl(named, port_sched, weight_decay=wd,
                                             decoupled_wd=kind == "adamw")

    params = jax.tree.map(jnp.asarray, _nest(flat))
    state = jax_optim.set_transforms(tx.init(params), transforms)
    named = [(n, torch.nn.Parameter(torch.from_numpy(v.copy()))) for n, v in _port(flat).items()]
    opt = make(named)
    optim.set_transforms(opt, transforms, N_TASKS)
    assert set(opt.transforms) == {port_name_from_jax(k, N_TASKS) for k in PROJECTED}
    by_name = dict(named)
    for _ in range(3):
        gflat = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
        grads = jax.tree.map(jnp.asarray, _nest(gflat))
        updates, state = tx.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        for n, g in _port(gflat).items():
            by_name[n].grad = torch.from_numpy(g)
        opt.step()
        ref = _port(_flatten_tree(jax.device_get(params)))
        for n, p in by_name.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=1e-6, atol=1e-7, err_msg=n)
    assert opt.count == 3


def test_projection_keeps_updates_in_the_subspace():
    """The projected update of a conv lies in P's range: P u = u on the
    flattened (out, in*kh*kw) rows."""
    rng = np.random.RandomState(3)
    P = torch.from_numpy(_symmetric_projection(rng, 72))
    u = torch.from_numpy(rng.randn(8, 8, 3, 3).astype(np.float32))
    got = optim.project_update(u, P).reshape(8, -1)
    torch.testing.assert_close(got @ P, got, rtol=0, atol=1e-5)
    bias = u[0, 0, 0]
    assert optim.project_update(bias, P) is bias  # 1-D leaves pass through


def test_lr_schedule_matches_jax():
    sched = jax_lr_schedule(0.02, 50, max_epochs=12, milestones=(8, 11), warmup_iters=500)
    port = make_lr_schedule(0.02, 50, max_epochs=12, milestones=(8, 11), warmup_iters=500)
    for step in (0, 1, 2, 250, 499, 500, 501, 399, 400, 549, 550, 10_000):
        assert np.float32(port(step)) == np.float32(sched(step)), step


@pytest.fixture(scope="module")
def small():
    model, variables, port = jax_and_port((64, 96), seed=0)
    return model, variables["params"], port


def test_port_name_from_jax_is_a_bijection(small):
    """Every JAX parameter path maps to a distinct port parameter, and
    every port parameter is reached; the trainable masks agree."""
    model, params, port = small
    flat = _flatten_tree(params)
    n_tasks = len(model.config.task_split) - 1
    names = [port_name_from_jax(p, n_tasks) for p in flat]
    port_params = dict(port.named_parameters())
    assert len(set(names)) == len(names) == len(port_params)
    assert set(names) == set(port_params)
    # each name holds that leaf's values in the weight bridge
    sd = state_dict_from_jax(flat, {})
    for p, n in zip(flat, names):
        np.testing.assert_array_equal(np.sort(sd[n].numpy().ravel()),
                                      np.sort(np.asarray(flat[p]).ravel()), err_msg=p)
    jmask = _flatten_tree(jax_trainable_mask(params, model.config))
    tmask = trainable_mask(port, port.config)
    assert {port_name_from_jax(p, n_tasks): bool(v) for p, v in jmask.items()} == tmask
    assert 0 < sum(tmask.values()) < len(tmask)
    with pytest.raises(KeyError):
        port_name_from_jax("backbone/layer1_0/bn1/mean", n_tasks)


def test_paramwise_mults_match_jax(small):
    model, params, port = small
    cfg = {"norm_decay_mult": 0.0,
           "custom_keys": {"neck": {"lr_mult": 0.5, "decay_mult": 0.25},
                           "neck/fpn": {"lr_mult": 0.1}}}
    n_tasks = len(model.config.task_split) - 1
    jl, jw = jax_optim.paramwise_mults(params, cfg)
    jl, jw = _flatten_tree(jl), _flatten_tree(jw)
    # custom keys match names by substring: the port's names spell the
    # same modules with dots
    port_cfg = {"norm_decay_mult": 0.0,
                "custom_keys": {"neck": {"lr_mult": 0.5, "decay_mult": 0.25},
                                "neck.fpn": {"lr_mult": 0.1}}}
    got = optim.paramwise_mults(port, port_cfg)
    for p in jl:
        assert got[port_name_from_jax(p, n_tasks)] == (jl[p], jw[p]), p
    assert got["neck.fpn_convs.0.conv.weight"] == (0.1, 1.0)
    assert got["backbone.layer2.0.bn1.weight"][1] == 0.0

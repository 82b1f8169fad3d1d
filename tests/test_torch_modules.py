"""Module parity on bridged weights: the port's backbone + FPN
(``extract_feat``), bbox head (with the -1e10 masking of future tasks)
and FrozenBatchNorm against the JAX modules."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.models.layers import FrozenBatchNorm as JaxFrozenBN

from nsgp_repre_tpu_torch.models.bbox_head import NEG_INF_SCORE
from nsgp_repre_tpu_torch.models.layers import FrozenBatchNorm
from torch_port_util import f32_matmuls, jax_and_port

HW = (64, 96)


@pytest.fixture(scope="module")
def models():
    f32_matmuls()
    return jax_and_port(HW, seed=1)


@pytest.mark.parametrize("B,inference", [(1, False), (1, True), (2, True)])
def test_extract_feat_matches_jax(models, B, inference):
    """f32 rtol/atol 1e-4. ``inference=True`` at batch 1 runs the port's
    fused FPN convs (conv3x3 plain version); JAX on the CPU keeps XLA's."""
    model, variables, port = models
    x = np.random.RandomState(B).randn(B, *HW, 3).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(x), method=model.extract_feat)
    with torch.no_grad():
        got = port.extract_feat(torch.from_numpy(x), inference=inference)
    assert len(got) == 5
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models_bf16():
    return jax_and_port(HW, seed=1, compute_dtype="bfloat16")


@pytest.mark.parametrize("B,inference", [(1, False), (1, True), (2, True)])
def test_extract_feat_bf16_matches_jax(models_bf16, B, inference):
    """bf16: within 2**-6 of the largest magnitude (a few bf16 ulps). Both
    sides round each conv sum, BN factor and add to bf16 at the same
    points; the sums run in another order, so roundings can flip."""
    model, variables, port = models_bf16
    x = np.random.RandomState(B).randn(B, *HW, 3).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(x), method=model.extract_feat)
    with torch.no_grad():
        got = port.extract_feat(torch.from_numpy(x), inference=inference)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=2 ** -6 * np.abs(r).max())


@pytest.mark.parametrize("layout", ["nhwc", "torch_flat"])
def test_bbox_head_matches_jax(models, layout):
    model, variables, port = models
    x = np.random.RandomState(5).randn(12, 7, 7, 256).astype(np.float32)
    if layout == "torch_flat":  # stored RoI features: (R, C*H*W) torch order
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2).reshape(12, -1))
    cls_ref, reg_ref = model.apply(variables, jnp.asarray(x),
                                   method=lambda m, v: m.bbox_head(v))
    with torch.no_grad():
        cls, reg = port.bbox_head(torch.from_numpy(x))
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_ref), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(reg.numpy(), np.asarray(reg_ref), atol=1e-5, rtol=1e-6)
    # task_id=1 of (0, 4, 6): classes 4..5 are future, background last
    assert (cls[:, 4:6] == NEG_INF_SCORE).all() and torch.isfinite(cls).all()
    assert (reg[:, 16:24] == 0).all()
    assert (cls[:, [0, 6]] != NEG_INF_SCORE).all()


def test_frozen_bn_rounding_points_bf16():
    """inv = rsqrt(var + eps) * scale in f32; x * inv + (bias - mean *
    inv) with both factors rounded to bf16 (layers.py:284-285). One bf16
    rounding of the result apart at most."""
    rng = np.random.RandomState(6)
    c = 16
    scale, bias = rng.uniform(0.5, 1.5, c), rng.uniform(-0.5, 0.5, c)
    mean, var = rng.uniform(-0.5, 0.5, c), rng.uniform(0.5, 1.5, c)
    x = rng.randn(2, 5, 6, c).astype(np.float32)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    ref = JaxFrozenBN().apply(
        {"params": {"scale": f32(scale), "bias": f32(bias)},
         "batch_stats": {"mean": f32(mean), "var": f32(var)}},
        jnp.asarray(x).astype(jnp.bfloat16))
    bn = FrozenBatchNorm(c)
    bn.load_state_dict({k: torch.tensor(v, dtype=torch.float32) for k, v in dict(
        weight=scale, bias=bias, running_mean=mean, running_var=var).items()})
    with torch.no_grad():
        got = bn(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=8e-3, atol=8e-3)

"""Plain versions of the conv3x3 and fused RPN-head kernels against the
Pallas kernels they replace (nsgp_repre_tpu/ops/rpn_head_pallas.py, run
with interpret=True), and the port's RPNHead against the JAX RPNHead.

f32: atol 1e-4 (the conv sums run in another order). bf16: rtol 2e-2,
since both sides round the conv sum, the bias and the 1x1 sum to bf16
at the same points, and one flipped rounding of an input to the 1x1
stage moves an output by a few bf16 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.models.rpn_head import RPNHead as JaxRPNHead
from nsgp_repre_tpu.ops.rpn_head_pallas import conv3x3_fused, rpn_head_fused

from nsgp_repre_tpu_torch.models.rpn_head import RPNHead
from nsgp_repre_tpu_torch.ops import rpn_head_cuda
from torch_port_util import f32_matmuls

A = 3


def _weights(rng, c, f):
    w1 = (rng.randn(3, 3, c, f) / np.sqrt(9 * c)).astype(np.float32)
    b1 = rng.randn(f).astype(np.float32) * 0.1
    wcr = (rng.randn(f, 5 * A) / np.sqrt(f)).astype(np.float32)
    bcr = rng.randn(5 * A).astype(np.float32) * 0.1
    return w1, b1, wcr, bcr


def _pad128(wcr, bcr):
    f = wcr.shape[0]
    return (np.concatenate([wcr, np.zeros((f, 128 - 5 * A), np.float32)], 1),
            np.concatenate([bcr, np.zeros(128 - 5 * A, np.float32)]))


def _t(x, dt=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dt)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(1, 12, 16, 32), (2, 5, 7, 16)])
def test_conv3x3_plain_matches_pallas_f32(shape, relu):
    f32_matmuls()
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w1, b1, _, _ = _weights(rng, shape[-1], 24)
    ref = conv3x3_fused(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), relu=relu,
                        interpret=True)
    got = rpn_head_cuda.conv3x3(_t(x), _t(w1), _t(b1), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", [(1, 16, 24, 32), (2, 5, 7, 32)])
def test_rpn_head_plain_matches_pallas_f32(shape):
    f32_matmuls()
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    w1, b1, wcr, bcr = _weights(rng, shape[-1], 32)
    ref = rpn_head_fused(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                         *map(jnp.asarray, _pad128(wcr, bcr)), interpret=True)
    got = rpn_head_cuda.rpn_head(_t(x), _t(w1), _t(b1), _t(wcr), _t(bcr))
    assert got.shape == shape[:3] + (5 * A,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[..., : 5 * A], atol=1e-4, rtol=0)


@pytest.mark.parametrize("kernel", ["conv3x3", "rpn_head"])
def test_plain_matches_pallas_bf16(kernel):
    rng = np.random.RandomState(2)
    x = rng.randn(1, 16, 24, 32).astype(np.float32)
    w1, b1, wcr, bcr = _weights(rng, 32, 32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tx = _t(x, torch.bfloat16)
    if kernel == "conv3x3":
        ref = conv3x3_fused(xb, jnp.asarray(w1), jnp.asarray(b1), relu=True, interpret=True)
        got = rpn_head_cuda.conv3x3(tx, _t(w1), _t(b1), relu=True)
    else:
        ref = rpn_head_fused(xb, jnp.asarray(w1), jnp.asarray(b1),
                             *map(jnp.asarray, _pad128(wcr, bcr)), interpret=True)[..., : 5 * A]
        got = rpn_head_cuda.rpn_head(tx, _t(w1), _t(b1), _t(wcr), _t(bcr))
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2 * np.abs(ref).max())


def test_rpn_head_module_matches_jax():
    """The port's RPNHead, fused (plain-version path) and unfused, on
    weights copied from a JAX RPNHead (HWIO → OIHW)."""
    f32_matmuls()
    c = 32
    rs = np.random.RandomState(3)
    feats = [rs.randn(1, h, w, c).astype(np.float32) for h, w in ((16, 24), (8, 12), (4, 6))]
    head = JaxRPNHead(feat_channels=c, num_base_priors=A)
    variables = head.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])
    port = RPNHead(c, c, A)
    sd = {}
    for name in ("rpn_conv", "rpn_cls", "rpn_reg"):
        p = variables["params"][name]
        sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        sd[f"{name}.bias"] = _t(p["bias"]) + 0.05  # nonzero biases
    port.load_state_dict(sd)
    cls_ref, reg_ref = head.apply(
        {"params": {k: {"kernel": v["kernel"], "bias": v["bias"] + 0.05}
                    for k, v in variables["params"].items()}},
        [jnp.asarray(f) for f in feats])
    for fused in (False, True):
        with torch.no_grad():
            cls, reg = port([_t(f) for f in feats], fused=fused)
        for a, b in zip(cls, cls_ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
        for a, b in zip(reg, reg_ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


def test_forward_only_kernels_refuse_grad():
    """The fused head and conv have no backward: with grad mode on and an
    input that requires grad they raise, on the CPU as on the card; under
    no_grad (as RPNHead._fused calls them) they run."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 4, 5, 32, generator=g, requires_grad=True)
    w, b = torch.randn(3, 3, 32, 32, generator=g), torch.zeros(32)
    wcr, bcr = torch.randn(32, 15, generator=g), torch.zeros(15)
    with pytest.raises(RuntimeError, match="forward only"):
        rpn_head_cuda.rpn_head(x, w, b, wcr, bcr)
    with pytest.raises(RuntimeError, match="forward only"):
        rpn_head_cuda.conv3x3(x, w, b)
    with torch.no_grad():
        assert rpn_head_cuda.rpn_head(x, w, b, wcr, bcr).shape == (1, 4, 5, 15)
    head = RPNHead(32, 32, 3)
    cls, reg = head._fused([x])
    assert not cls[0].requires_grad and cls[0].shape == (1, 4, 5, 3) and reg[0].shape[-1] == 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_at_positions_matches_jax(dtype):
    """RPNHead.at_positions (the sparse RPN loss) against the JAX method on
    the same weights and patches. Its rounding points are JAX's: kernels
    cast to the patch dtype, each product and bias add in that dtype, so
    bf16 agrees to one bf16 rounding of f32 sums taken in another order."""
    f32_matmuls()
    c = 32
    rs = np.random.RandomState(4)
    head = JaxRPNHead(feat_channels=c, num_base_priors=A)
    variables = head.init(jax.random.PRNGKey(1), [jnp.zeros((1, 4, 6, c), jnp.float32)])
    params = {k: {"kernel": v["kernel"], "bias": v["bias"] + 0.05}
              for k, v in variables["params"].items()}
    port = RPNHead(c, c, A)
    port.load_state_dict({f"{k}.{leaf}": _t(np.transpose(np.asarray(v["kernel"]), (3, 2, 0, 1)))
                          if leaf == "weight" else _t(v["bias"])
                          for k, v in params.items() for leaf in ("weight", "bias")})
    patches = rs.randn(40, 3, 3, c).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = head.apply({"params": params}, jnp.asarray(patches).astype(jdt), method=head.at_positions)
    got = port.at_positions(_t(patches).to(getattr(torch, dtype)))
    for g, r in zip(got, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert g.dtype == getattr(torch, dtype) and g.shape == r.shape
        tol = 1e-5 if dtype == "float32" else 2 ** -7 * np.abs(r).max()
        np.testing.assert_allclose(g.detach().float().numpy(), r, atol=tol, rtol=0)

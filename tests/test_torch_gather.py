"""The port's row gather (plain version) against the Pallas TPU kernel it
replaces (nsgp_repre_tpu/ops/gather_pallas.py, run with interpret=True).

A gather is a copy, so the two must be exactly equal, out-of-range
indices (below 0 and >= N) clamped to the first and last row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.ops.gather_pallas import gather_rows as gather_rows_pallas

from nsgp_repre_tpu_torch.ops import gather_cuda


@pytest.mark.parametrize("N,C,M", [(64, 1024, 700), (37, 2048, 300)])
def test_gather_plain_matches_pallas(N, C, M):
    rng = np.random.RandomState(N + M)
    table = rng.randn(N, C).astype(np.float32)
    idx = rng.randint(-5, N + 6, M).astype(np.int32)
    idx[:3] = [-1, N, N - 1]
    assert (idx < 0).any() and (idx >= N).any() and M % 512
    ref = np.asarray(gather_rows_pallas(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    got = gather_cuda.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == (M, C) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gather_plain_dtypes_and_shapes():
    """bf16 rows copy exactly; a non-2-D table raises."""
    rng = np.random.RandomState(0)
    table = torch.from_numpy(rng.randn(9, 24).astype(np.float32)).to(torch.bfloat16)
    idx = torch.tensor([-3, 0, 8, 9, 2 ** 30], dtype=torch.int32)
    got = gather_cuda.gather_rows(table, idx)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, table[[0, 0, 8, 8, 8]])
    with pytest.raises(ValueError, match="table must be"):
        gather_cuda.gather_rows(table[None], idx)

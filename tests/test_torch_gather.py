"""Residency-masked gather and gather-matmul in the PyTorch port: the
wrappers' CPU path (the plain versions) against the JAX oracles
(``tiered_gather_ref``, ``tiered_gather_matmul_ref``) and the JAX wrappers
running their Pallas kernels in interpret mode, on the same numpy inputs.
Miss masks, miss rows and gathered rows compare exactly; gather-matmul rows
at an fp32 tolerance, because the reference's interpret-mode kernel is not
bitwise equal to its own einsum oracle. The CUDA kernels are held against
the plain versions in tests/test_torch_cuda.py (card only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tiered_gather import ops as jax_ops
from repro.kernels.tiered_gather.ref import tiered_gather_matmul_ref, tiered_gather_ref
from repro_torch.kernels.tiered_gather import ops

# fp32 products over D <= 128 terms of unit normals (|out| < 50): the two
# frameworks' reduction orders differ by a few ulps of the output
MATMUL_ATOL, MATMUL_RTOL = 1e-4, 1e-5

# V, D, N, group_size, mask: "all", "none" or "random"
GATHER_CASES = [
    pytest.param((1024, 64, 32, 128, "random"), id="random-mask"),
    pytest.param((500, 128, 17, 100, "random"), id="ragged-last-group"),
    pytest.param((64, 8, 16, 16, "all"), id="all-resident"),
    pytest.param((64, 8, 16, 16, "none"), id="none-resident"),
]


def _gather_inputs(case, seed=0):
    V, D, N, gs, kind = case
    rs = np.random.default_rng(seed)
    table = rs.standard_normal((V, D), dtype=np.float32)
    ids = rs.integers(-5, V + 5, N).astype(np.int32)
    ids[:4] = [-1, V, 2**31 - 1, -(2**31)]  # edge ids: never dereferenced
    G = -(-V // gs)
    mask = {"all": np.ones(G), "none": np.zeros(G), "random": rs.integers(0, 2, G)}[kind].astype(np.int32)
    return table, ids, mask


def _port_gather(table, ids, mask, gs):
    out, miss = ops.tiered_gather(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(mask),
                                  group_size=gs)
    return out.numpy(), miss.numpy()


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_matches_oracle_and_pallas_interpret(case):
    table, ids, mask = _gather_inputs(case)
    gs = case[3]
    out, miss = _port_gather(table, ids, mask, gs)
    args = (jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask))
    for rout, rmiss in (tiered_gather_ref(*args, group_size=gs),
                        jax_ops.tiered_gather(*args, group_size=gs, interpret=True)):
        np.testing.assert_array_equal(miss, np.asarray(rmiss))
        np.testing.assert_array_equal(out, np.asarray(rout))
    assert miss.dtype == np.int32 and np.all(miss[:4] == 1)
    assert np.all(out[miss == 1] == 0)


def test_gather_casts_ids_and_mask_to_int32():
    table, ids, mask = _gather_inputs(GATHER_CASES[0].values[0], seed=1)
    out32, miss32 = _port_gather(table, ids, mask, 128)
    out, miss = ops.tiered_gather(torch.from_numpy(table), torch.from_numpy(ids.astype(np.int64)),
                                  torch.from_numpy(mask.astype(bool)), group_size=128)
    np.testing.assert_array_equal(out.numpy(), out32)
    np.testing.assert_array_equal(miss.numpy(), miss32)
    assert miss.dtype == torch.int32


# V, D, F, N, group_size, mask
MATMUL_CASES = [
    pytest.param((256, 32, 64, 16, 32, "random"), id="random-mask"),
    pytest.param((500, 64, 48, 33, 17, "random"), id="ragged-last-group"),
    pytest.param((64, 16, 16, 8, 8, "all"), id="all-resident"),
    pytest.param((1024, 128, 96, 40, 128, "none"), id="none-resident"),
]


@pytest.mark.parametrize("case", MATMUL_CASES)
def test_gather_matmul_matches_oracle_and_pallas_interpret(case):
    V, D, F, N, gs, kind = case
    table, ids, mask = _gather_inputs((V, D, N, gs, kind), seed=2)
    w = np.random.default_rng(3).standard_normal((D, F), dtype=np.float32)
    out, miss = ops.tiered_gather_matmul(torch.from_numpy(table), torch.from_numpy(w), torch.from_numpy(ids),
                                         torch.from_numpy(mask), group_size=gs)
    out, miss = out.numpy(), miss.numpy()
    args = (jnp.asarray(table), jnp.asarray(w), jnp.asarray(ids), jnp.asarray(mask))
    for rout, rmiss in (tiered_gather_matmul_ref(*args, group_size=gs),
                        jax_ops.tiered_gather_matmul(*args, group_size=gs, interpret=True)):
        np.testing.assert_array_equal(miss, np.asarray(rmiss))
        np.testing.assert_allclose(out, np.asarray(rout), atol=MATMUL_ATOL, rtol=MATMUL_RTOL)
    assert out.shape == (N, F) and out.dtype == np.float32
    assert np.all(out[miss == 1] == 0) and np.all(miss[:4] == 1)


def test_wrappers_refuse_other_devices():
    table = torch.empty(8, 8, device="meta")
    ids = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.tiered_gather(table, ids, ids, group_size=4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.tiered_gather_matmul(table, table, ids, ids, group_size=4)

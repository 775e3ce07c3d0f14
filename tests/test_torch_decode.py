"""Decode attention in the PyTorch port, dense and paged: the wrappers' CPU
path (the clamps, then the plain versions) against the JAX oracles
(``decode_attention_ref``, ``paged_decode_attention_ref``) and against the
JAX wrappers running their Pallas kernels in interpret mode, on the same
numpy inputs. The CUDA kernel itself is held against the plain versions in
tests/test_torch_cuda.py (card only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jax_ops
from repro.kernels.decode_attention.ref import decode_attention_ref, paged_decode_attention_ref
from repro.models.attention import densify_pages as jax_densify
from repro_torch.kernels.decode_attention import ops

# fp32 on both sides; the reference's own decode tests hold its kernel to
# its oracle at 2e-5 (tests/test_kernels.py), and the two frameworks' sums
# differ by a few ulps of O(1) outputs
TOL = 2e-5

# B, H, Hkv, hd, Skv, rolling, softcap, kv_len
DENSE_CASES = [
    pytest.param((2, 4, 4, 32, 96, False, None, [1, 96]), id="G1-linear"),
    pytest.param((2, 12, 2, 32, 130, False, None, [17, 129]), id="G6-linear-ragged"),
    pytest.param((1, 16, 1, 64, 80, True, None, [80 + 37]), id="G16-rolling-wrapped"),
    pytest.param((2, 12, 2, 32, 64, False, 30.0, [64 + 50, 5]), id="G6-softcap-past-Skv"),
    pytest.param((3, 16, 1, 32, 48, True, 20.0, [3, 48, 48 + 64]), id="G16-rolling-softcap"),
]


def _dense_inputs(case, seed=0):
    B, H, Hkv, hd, Skv = case[:5]
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((B, H, hd), dtype=np.float32)
    k = rs.standard_normal((B, Skv, Hkv, hd), dtype=np.float32)
    v = rs.standard_normal((B, Skv, Hkv, hd), dtype=np.float32)
    return q, k, v, np.asarray(case[7], np.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_plain_matches_oracle(case):
    q, k, v, kv_len = _dense_inputs(case)
    rolling, softcap = case[5:7]
    ref = decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
                               rolling=rolling, softcap=softcap)
    out = ops.decode_attention_plain(*_t(q, k, v, kv_len), rolling=rolling, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_wrapper_matches_pallas_interpret(case):
    q, k, v, kv_len = _dense_inputs(case, seed=1)
    rolling, softcap = case[5:7]
    ref = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
                                   rolling=rolling, softcap=softcap, bk=128, interpret=True)
    before = ops.decode_attention.launches
    out = ops.decode_attention(*_t(q, k, v, kv_len), rolling=rolling, softcap=softcap)
    assert ops.decode_attention.launches == before  # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_dense_wrapper_takes_a_scalar_kv_len():
    q, k, v, _ = _dense_inputs(DENSE_CASES[1].values[0], seed=2)
    ref = decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 40)
    out = ops.decode_attention(*_t(q, k, v), 40)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


# B, Hkv, G, hd, P, ps, NP, rolling, softcap, kv_len
PAGED_CASES = [
    pytest.param((2, 2, 6, 32, 16, 8, 4, False, None, [32, 13]), id="G6-full-and-partial-page"),
    pytest.param((3, 1, 16, 32, 24, 4, 5, True, None, [20, 20 + 7, 2]), id="G16-rolling-wrapped"),
    pytest.param((2, 4, 1, 16, 20, 8, 3, False, 30.0, [24 + 40, 1]), id="G1-softcap-past-capacity"),
    pytest.param((1, 2, 6, 64, 8, 16, 3, True, 25.0, [40]), id="G6-rolling-softcap"),
]


def _paged_inputs(case, seed=0):
    B, Hkv, G, hd, P, ps, NP = case[:7]
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((B, Hkv * G, hd), dtype=np.float32)
    k = rs.standard_normal((P, ps, Hkv, hd), dtype=np.float32)
    v = rs.standard_normal((P, ps, Hkv, hd), dtype=np.float32)
    pt = rs.permutation(P)[: B * NP].reshape(B, NP).astype(np.int32)  # disjoint, out of order
    return q, k, v, pt, np.asarray(case[9], np.int32)


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_matches_oracle(case):
    q, k, v, pt, kv_len = _paged_inputs(case)
    rolling, softcap = case[7:9]
    ref = paged_decode_attention_ref(*(jnp.asarray(a) for a in (q, k, v, pt, kv_len)),
                                     rolling=rolling, softcap=softcap)
    out = ops.paged_decode_attention_plain(*_t(q, k, v, pt, kv_len), rolling=rolling, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_wrapper_matches_pallas_interpret(case):
    q, k, v, pt, kv_len = _paged_inputs(case, seed=1)
    rolling, softcap = case[7:9]
    ref = jax_ops.paged_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pt, kv_len)),
                                         rolling=rolling, softcap=softcap, interpret=True)
    before = ops.paged_decode_attention.launches
    out = ops.paged_decode_attention(*_t(q, k, v, pt, kv_len), rolling=rolling, softcap=softcap)
    assert ops.paged_decode_attention.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_paged_tail_clamp_matches_the_reference_wrapper():
    """Table entries past a slot's last occupied page (here -1 and past the
    pool) are never followed: the port's clamp gives the reference
    wrapper's table, and both wrappers the same output."""
    case = PAGED_CASES[0].values[0]
    q, k, v, pt, _ = _paged_inputs(case, seed=3)
    P, ps = case[4], case[5]
    kv_len = np.asarray([2 * ps - 3, ps], np.int32)  # 2 pages and 1 page occupied
    pt[0, 2:] = -1
    pt[1, 1:] = [P + 5, 10**6, -7]
    clamped = ops.clamp_page_table(torch.from_numpy(pt), torch.from_numpy(kv_len), P, ps)
    assert clamped.tolist() == [[pt[0, 0], pt[0, 1], pt[0, 1], pt[0, 1]], [pt[1, 0]] * 4]
    ref = jax_ops.paged_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pt, kv_len)), interpret=True)
    out = ops.paged_decode_attention(*_t(q, k, v, pt, kv_len))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_densify_pages_matches_reference_bitwise():
    q, k, v, pt, _ = _paged_inputs(PAGED_CASES[1].values[0], seed=4)
    np.testing.assert_array_equal(ops.densify_pages(torch.from_numpy(k), torch.from_numpy(pt)).numpy(),
                                  np.asarray(jax_densify(jnp.asarray(k), jnp.asarray(pt))))


def test_wrappers_refuse_other_devices():
    q = torch.empty(1, 4, 64, device="meta")
    k = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.paged_decode_attention(q, k, k, torch.zeros(1, 1, dtype=torch.int32, device="meta"),
                                   torch.ones(1, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("n_sms", [132, 114, 1])
@pytest.mark.parametrize("B,Hkv,cap", [(2, 8, 1040), (8, 8, 32768), (2, 1, 2048), (1, 1, 1), (64, 8, 100),
                                        (1, 1, 1 << 20)])
def test_split_plan_covers_the_cache(B, Hkv, cap, n_sms):
    chunk, splits = ops.split_plan(B, Hkv, cap, n_sms)
    assert chunk % 64 == 0 and 1 <= splits <= 1024
    assert (splits - 1) * chunk < cap <= splits * chunk  # no split starts past the capacity

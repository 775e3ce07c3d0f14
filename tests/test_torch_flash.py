"""Prefill flash attention in the PyTorch port: the wrapper's CPU path (the
plain version) against the JAX Pallas kernel in interpret mode and against
``flash_attention_jnp``, on the same numpy inputs. The CUDA kernel itself is
held against the plain version in tests/test_torch_cuda.py (card only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.models.attention import flash_attention_jnp
from repro_torch.kernels.flash_attention import ops as fa_ops

# B, Sq, Sk, H, Hkv, hd, causal, window, softcap, q_offset
CASES = [
    pytest.param((2, 64, 64, 4, 4, 32, True, None, None, 0), id="causal"),
    pytest.param((1, 96, 96, 4, 2, 32, True, 24, None, 0), id="window-shorter-than-S"),
    pytest.param((1, 64, 64, 4, 2, 32, True, None, 5.0, 0), id="softcap"),
    pytest.param((2, 48, 48, 6, 2, 16, True, None, None, 0), id="gqa-G3"),
    pytest.param((1, 100, 100, 4, 1, 32, True, 40, None, 0), id="S-not-multiple-of-tile"),
    pytest.param((1, 72, 72, 4, 2, 32, False, None, None, 0), id="non-causal"),
    pytest.param((1, 50, 83, 4, 2, 32, True, 30, None, 33), id="q-offset-window"),
]

# fp32 tolerance of tests/test_kernels.py's flash property test
TOL = 3e-5


def _inputs(case, seed=0):
    B, Sq, Sk, H, Hkv, hd = case[:6]
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k = rs.standard_normal((B, Sk, Hkv, hd), dtype=np.float32)
    v = rs.standard_normal((B, Sk, Hkv, hd), dtype=np.float32)
    return q, k, v


def _port(case, q, k, v):
    causal, window, softcap, q_offset = case[6:]
    out = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    return out.numpy()


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret(case):
    q, k, v = _inputs(case)
    causal, window, softcap, q_offset = case[6:]
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              window=window, softcap=softcap, q_offset=q_offset,
                              bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(_port(case, q, k, v), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_flash_attention_jnp(case):
    q, k, v = _inputs(case, seed=1)
    causal, window, softcap, q_offset = case[6:]
    ref = flash_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              window=window, softcap=softcap, q_offset=q_offset,
                              chunk_q=32, chunk_k=32, differentiable=False)
    np.testing.assert_allclose(_port(case, q, k, v), np.asarray(ref), atol=TOL, rtol=TOL)


def test_cpu_wrapper_launches_nothing():
    before = fa_ops.flash_attention.launches
    q, k, v = _inputs(CASES[0].values[0])
    _port(CASES[0].values[0], q, k, v)
    assert fa_ops.flash_attention.launches == before


def test_wrapper_refuses_other_devices():
    q = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa_ops.flash_attention(q, q[:, :, :1], q[:, :, :1])


# the reduced configs' head dims, which the card's wrapper pads to 64
PADDED_CASES = [
    pytest.param((1, 48, 48, 4, 2, 16, True, None, None, 0), id="hd16-causal-gqa"),
    pytest.param((2, 80, 80, 4, 1, 8, True, 32, None, 0), id="hd8-window32-mqa"),
    pytest.param((1, 64, 64, 6, 2, 16, True, 32, None, 0), id="hd16-window32-gqa"),
]


@pytest.mark.parametrize("case", PADDED_CASES)
def test_zero_padded_head_dim_is_the_same_attention(case):
    """What the card's wrapper does at hd 8 and 16: q, k, v zero-padded to 64
    columns, the true head_dim's scale, O's first hd columns kept. On the
    plain version (whose scale is its head_dim's, so q comes pre-scaled by
    sqrt(64 / hd) to give the true one) it equals the unpadded attention,
    and the padded output columns are exactly zero; both match the Pallas
    kernel (interpret mode)."""
    q, k, v = _inputs(case, seed=2)
    causal, window, softcap, q_offset = case[6:]
    hd = q.shape[3]
    prescaled = q * np.float32((fa_ops.PADDED_HD / hd) ** 0.5)
    padded = [fa_ops.pad_head_dim(torch.from_numpy(t)) for t in (prescaled, k, v)]
    assert all(t.shape[3] == fa_ops.PADDED_HD and t.is_contiguous() for t in padded)
    out = fa_ops.flash_attention_plain(*padded, causal=causal, window=window, softcap=softcap,
                                       q_offset=q_offset)
    assert torch.count_nonzero(out[..., hd:]) == 0
    np.testing.assert_allclose(out[..., :hd].numpy(), _port(case, q, k, v), atol=1e-5, rtol=1e-5)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              window=window, softcap=softcap, q_offset=q_offset,
                              bq=16, bk=16, interpret=True)
    np.testing.assert_allclose(out[..., :hd].numpy(), np.asarray(ref), atol=TOL, rtol=TOL)

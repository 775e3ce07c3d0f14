"""The PyTorch port's RG-LRU against the JAX reference, on the same numpy
inputs at float32 on the CPU: the scan's plain version against
``rglru_scan_ref`` and the Pallas kernel in interpret mode, ``causal_conv1d``
with and without a carried state, and the whole recurrent block's prefill
(against both of the reference's scan paths) and decode step. The CUDA
kernel itself is held against the plain version in tests/test_torch_cuda.py
(card only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref
from repro.models import recurrent as ref_rec
from repro.models.spec import init_params as ref_init_params
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.models import recurrent as rec

ARCH = "recurrentgemma-9b"
# fp32: the scan's error grows with the carried magnitude, so the limit is
# 1e-5 per unit of max(1, |s|)
SCAN_TOL = 1e-5
# block outputs are D- and W-term fp32 dot products whose reduction order
# differs between the frameworks: the fp32 tolerance of test_torch_models.py
EPS = float(np.finfo(np.float32).eps)
TOL = 256 * EPS


def _scan_inputs(shape, seed=0):
    rs = np.random.default_rng(seed)
    a = rs.uniform(0.5, 0.999, shape).astype(np.float32)
    b = rs.standard_normal(shape, dtype=np.float32)
    return a, b


def _assert_scan_close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max() <= SCAN_TOL


def _port_scan(a, b):
    return lru_ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("shape", [(2, 37, 200), (1, 300, 64), (3, 1, 5)], ids=str)
def test_plain_scan_matches_reference_oracle(shape):
    a, b = _scan_inputs(shape)
    _assert_scan_close(_port_scan(a, b), rglru_scan_ref(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("shape", [(2, 37, 200), (1, 300, 64)], ids=str)
def test_plain_scan_matches_pallas_interpret(shape):
    a, b = _scan_inputs(shape, seed=1)
    ref = jax_rglru_scan(jnp.asarray(a), jnp.asarray(b), bt=32, bw=128, interpret=True)
    _assert_scan_close(_port_scan(a, b), ref)


def test_cpu_wrapper_launches_nothing_and_refuses_other_devices():
    before = lru_ops.rglru_scan.launches
    _port_scan(*_scan_inputs((1, 4, 8)))
    assert lru_ops.rglru_scan.launches == before
    a = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        lru_ops.rglru_scan(a, a)


@pytest.mark.parametrize("n_sms", [132, 114, 1])
@pytest.mark.parametrize("B,W", [(2, 4096), (1, 4096), (3, 4096), (2, 1), (1, 4128), (2, 20), (64, 2560)])
def test_scan_lane_plan_covers_the_width(B, W, n_sms):
    """Each block owns 32 or 64 lanes of one batch row; the blocks cover W
    exactly once per row, and cover the card whenever there are lanes for it."""
    lanes, blocks, threads = lru_ops.lane_plan(B, W, n_sms)
    assert lanes in (32, 64) and threads == lanes + 32  # one producer warp
    per_row = blocks // B
    assert blocks == B * per_row and (per_row - 1) * lanes < W <= per_row * lanes
    if B * W >= 32 * n_sms:
        assert blocks >= n_sms


def test_plain_scan_traces_without_mutation():
    """The analyzer treats an op that mutates an input as live; the plain
    scan builds its output by stacking, so its traced graph has none."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.param_graph import _is_mutating

    gm = make_fx(lru_ops.rglru_scan_plain)(torch.rand(1, 5, 3), torch.rand(1, 5, 3))
    assert not any(_is_mutating(n) for n in gm.graph.nodes)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9])
def test_causal_conv1d_matches_reference(with_state, S):
    rs = np.random.default_rng(S)
    B, W, cw = 2, 24, 4
    x = rs.standard_normal((B, S, W), dtype=np.float32)
    w = rs.standard_normal((cw, W), dtype=np.float32)
    bias = rs.standard_normal(W, dtype=np.float32)
    state = rs.standard_normal((B, cw - 1, W), dtype=np.float32) if with_state else None
    ref_y, ref_state = ref_rec.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                             None if state is None else jnp.asarray(state))
    y, new_state = rec.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                                     None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(new_state.numpy(), np.asarray(ref_state))


@pytest.fixture(scope="module")
def block():
    """Reference-initialized RG-LRU block params (Λ from the lru_a init) of
    reduced RecurrentGemma at float32, in both packages."""
    ref_cfg = ref_get_reduced(ARCH).replace(dtype="float32")
    ref_params = ref_init_params(ref_rec.rglru_block_spec(ref_cfg), jax.random.PRNGKey(3))
    flat = {p: np.asarray(v) for p, v in ref_flatten(ref_params)}
    cfg = get_reduced(ARCH).replace(dtype="float32")
    return ref_cfg, ref_params, cfg, params_from_numpy(flat, "cpu")


def _assert_tree_close(ref, got):
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=TOL, rtol=TOL, err_msg=key)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas-branch", "associative-scan"])
def test_block_forward_matches_reference(block, use_pallas):
    ref_cfg, ref_params, cfg, params = block
    x = np.random.default_rng(5).standard_normal((2, 37, cfg.d_model), dtype=np.float32)
    ref_y, ref_cache = ref_rec.rglru_block_forward(ref_params, jnp.asarray(x), ref_cfg, use_pallas=use_pallas)
    y, cache = rec.rglru_block_forward(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=TOL, rtol=TOL)
    assert set(cache) == set(ref_cache) == {"conv", "lru"}
    _assert_tree_close(ref_cache, cache)


def test_block_decode_matches_reference(block):
    ref_cfg, ref_params, cfg, params = block
    rs = np.random.default_rng(6)
    W, cw = cfg.recurrent.lru_width, cfg.recurrent.conv_width
    x = rs.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
    cache = {"conv": rs.standard_normal((2, cw - 1, W), dtype=np.float32),
             "lru": rs.standard_normal((2, W), dtype=np.float32)}
    assert {k: v.shape for k, v in cache.items()} == rec.rglru_cache_shapes(cfg, 2)
    ref_y, ref_cache = ref_rec.rglru_block_decode(
        ref_params, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()}, ref_cfg)
    y, new_cache = rec.rglru_block_decode(params, torch.from_numpy(x),
                                          {k: torch.from_numpy(v) for k, v in cache.items()}, cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=TOL, rtol=TOL)
    _assert_tree_close(ref_cache, new_cache)


def test_lru_a_init_follows_reference_band():
    """Λ drawn by the port's init lands in the reference's band: the decay
    a = sigmoid(Λ)^c with a² ∈ [0.9, 0.999]."""
    from repro_torch.models.spec import ParamSpec, init_params

    lam = init_params({"lam": ParamSpec((4096,), (None,), init="lru_a")},
                      torch.Generator().manual_seed(0), device="cpu")["lam"]
    a2 = (torch.sigmoid(lam.double()) ** 8) ** 2
    assert a2.min() >= 0.9 - 1e-6 and a2.max() <= 0.999 + 1e-6
    assert a2.max() - a2.min() > 0.09  # uniform over the band, not a constant

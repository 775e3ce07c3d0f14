"""The paged-KV path of the PyTorch port against the JAX package: the
``PagePool`` allocator under one scripted alloc/free/exhaust sequence
(tables, stats, errors), ``paged_kv_write`` and ``densify_pages`` bit for
bit, and ``paged_gqa_decode`` step for step against the reference's (plain
and, through its Pallas kernel, in interpret mode) and against the port's
own dense ``gqa_decode``, on reference weights, linear and rolling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.models import attention as ref_attn
from repro.serving.paged_kv import PagePool as RefPagePool
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ops import densify_pages
from repro_torch.models import attention
from repro_torch.serving import PagePool

# fp32 decode through two frameworks: tests/test_paged_kv.py holds the
# reference's paged and dense decode to each other at 3e-5
TOL = 3e-5

# (op, slot, tokens) — grants, frees, a re-grant of a live slot, exhaustion
SCRIPT = [
    ("alloc", 0, 9), ("alloc", 1, 4), ("alloc", 2, 1), ("free", 1, None), ("alloc", 3, 17),
    ("alloc", 0, 4), ("free", 0, None), ("free", 0, None), ("alloc", 4, 40), ("alloc", 1, 12),
    ("free", 3, None), ("alloc", 4, 5), ("alloc", 5, 20), ("free", 2, None), ("alloc", 6, 3),
]


def _run_script(pool):
    trace = []
    for op, slot, n in SCRIPT:
        try:
            res = pool.alloc(slot, n) if op == "alloc" else pool.free(slot)
        except ValueError as e:
            res = f"ValueError: {e}"
        pool.assert_consistent()
        trace.append((res, pool.free_pages, pool.used_pages, [pool.owned(s) for s in range(8)],
                      pool.page_table(np_max=6).tolist(), pool.page_table().tolist(), pool.stats.to_dict(),
                      pool.can_admit(9), pool.step_kv_positions({s: 7 for s in range(8)})))
    return trace


def test_pool_script_matches_reference():
    port, ref = _run_script(PagePool(12, page_size=4, n_slots=8)), _run_script(RefPagePool(12, page_size=4, n_slots=8))
    assert port == ref
    assert any(isinstance(r[0], str) for r in port) and any(r[0] is False for r in port)


def test_pool_rejects_what_the_reference_rejects():
    for args in ((0, 4, 2), (4, 0, 2), (4, 4, 0)):
        with pytest.raises(ValueError, match="positive sizes"):
            PagePool(*args)
        with pytest.raises(ValueError, match="positive sizes"):
            RefPagePool(*args)
    pool = PagePool(4, page_size=4, n_slots=2)
    pool.alloc(0, 8)
    pool._free.append(pool.owned(0)[0])  # a page both free and owned
    with pytest.raises(AssertionError, match="corrupt"):
        pool.assert_consistent()


def _pool_and_table(B, NP, ps, spare=3):
    """A pool that granted and freed other slots first, so each slot's
    pages are out of order in the pool."""
    pool = PagePool(B * NP + spare, ps, B + 2)
    pool.alloc(B, 2 * ps)
    pool.alloc(B + 1, ps * spare)
    pool.free(B)
    for b in reversed(range(B)):
        assert pool.alloc(b, NP * ps)
    pool.free(B + 1)
    return pool, pool.page_table(np_max=NP)[:B]


def test_paged_kv_write_and_densify_match_reference_bitwise():
    B, NP, ps, Hkv, hd = 3, 3, 4, 2, 8
    pool, pt = _pool_and_table(B, NP, ps)
    rs = np.random.default_rng(0)
    k = rs.standard_normal((pool.n_pages, ps, Hkv, hd), dtype=np.float32)
    v = rs.standard_normal((pool.n_pages, ps, Hkv, hd), dtype=np.float32)
    kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    for step, slot in enumerate(([0, 5, 11], [3, 4, 0], [11, 11, 7])):
        slot = np.asarray(slot, np.int32)
        k_new = rs.standard_normal((B, Hkv, hd), dtype=np.float32)
        v_new = rs.standard_normal((B, Hkv, hd), dtype=np.float32)
        kt, vt = attention.paged_kv_write(kt, vt, torch.from_numpy(pt), torch.from_numpy(slot),
                                          torch.from_numpy(k_new), torch.from_numpy(v_new))
        kj, vj = ref_attn.paged_kv_write(kj, vj, jnp.asarray(pt), jnp.asarray(slot), jnp.asarray(k_new),
                                         jnp.asarray(v_new))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj), err_msg=f"write {step}")
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj), err_msg=f"write {step}")
        np.testing.assert_array_equal(densify_pages(kt, torch.from_numpy(pt)).numpy(),
                                      np.asarray(ref_attn.densify_pages(kj, jnp.asarray(pt))))


def _gqa_params(cfg, seed=1):
    D, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rs = np.random.default_rng(seed)
    shapes = {"wq": (D, H * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd), "wo": (H * hd, D)}
    return {n: rs.standard_normal(s, dtype=np.float32) * 0.1 for n, s in shapes.items()}


@pytest.mark.parametrize("rolling_window", [None, 8], ids=["linear", "rolling"])
def test_paged_gqa_decode_matches_reference_and_dense(rolling_window):
    """Step for step, with ragged positions per slot: the port's paged decode
    equals the reference's paged decode (jnp and Pallas-interpret), and the
    port's dense gqa_decode; the densified pages equal the dense cache bit for
    bit after every write."""
    ref_cfg = ref_get_reduced("mixtral-8x22b")
    cfg = get_reduced("mixtral-8x22b")
    B, NP, ps = 2, 2, 4
    Skv = rolling_window or NP * ps  # the rolling pages hold exactly the window
    Hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    flat = _gqa_params(cfg)
    params, ref_params = params_from_numpy(flat, "cpu"), {n: jnp.asarray(a) for n, a in flat.items()}
    pool, pt = _pool_and_table(B, NP, ps)
    P = pool.n_pages
    k_pages, v_pages = torch.zeros(P, ps, Hkv, hd), torch.zeros(P, ps, Hkv, hd)
    k_cache, v_cache = torch.zeros(B, Skv, Hkv, hd), torch.zeros(B, Skv, Hkv, hd)
    ref_pages = {use: (jnp.zeros((P, ps, Hkv, hd)), jnp.zeros((P, ps, Hkv, hd))) for use in (False, True)}
    start = np.asarray([0, 3])  # slot 1 starts at position 3: ragged lengths
    n_steps = Skv + 3 if rolling_window else Skv - int(start.max())
    rs = np.random.default_rng(7)
    pt_t = torch.from_numpy(pt)
    launches = da_ops.paged_decode_attention.launches
    for t in range(n_steps):
        x = rs.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        pos = (start + t).astype(np.int64)
        xt, post = torch.from_numpy(x), torch.from_numpy(pos)
        out_p, k_pages, v_pages = attention.paged_gqa_decode(params, xt, post, k_pages, v_pages, pt_t, cfg,
                                                             rolling_window=rolling_window)
        out_d, k_cache, v_cache = attention.gqa_decode(params, xt, post, k_cache, v_cache, cfg,
                                                       rolling_window=rolling_window)
        np.testing.assert_allclose(out_p.numpy(), out_d.numpy(), atol=TOL, rtol=TOL, err_msg=f"step {t}")
        for use_pallas, (kr, vr) in ref_pages.items():
            out_r, kr, vr = ref_attn.paged_gqa_decode(
                ref_params, jnp.asarray(x), jnp.asarray(pos, jnp.int32), kr, vr, jnp.asarray(pt), ref_cfg,
                rolling_window=rolling_window, use_pallas=use_pallas)
            ref_pages[use_pallas] = (kr, vr)
            np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), atol=TOL, rtol=TOL,
                                       err_msg=f"step {t}, use_pallas={use_pallas}")
        np.testing.assert_array_equal(densify_pages(k_pages, pt_t)[:, :Skv].numpy(), k_cache.numpy())
        np.testing.assert_array_equal(densify_pages(v_pages, pt_t)[:, :Skv].numpy(), v_cache.numpy())
    assert da_ops.paged_decode_attention.launches == launches  # CPU tensors: the plain version only

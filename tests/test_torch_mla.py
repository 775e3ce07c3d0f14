"""DeepSeek-V2-Lite in the port against the JAX reference, on the CPU at
float32 with the reduced config (MLA with a 32-wide latent cache, a dense
lead layer, 8 routed experts top-2 plus a shared expert) and reference
weights:

  * ``mla_forward`` (expanded heads) and ``mla_decode`` (absorbed over the
    latent cache) alone, within 256 eps; the decode writes ``ckv`` / ``kr``
    in place;
  * serving the reference's strict artifact under strict, stats and full:
    the same tokens; under strict the same faulted units, bytes and
    LoadEvent sequence, under full the same loaded units; an artifact the port writes from the same
    weights equals the reference's byte for byte;
  * the scheduler on that artifact: the reference scheduler's tokens, stats
    and loads for one arrival script, and each request's own
    ``generate()`` tokens."""

import json
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.core import DeploymentProfile as RefProfile
from repro.core import analyze as ref_analyze
from repro.core import build_artifact as ref_build_artifact
from repro.models import attention as ref_attn
from repro.models.zoo import build_model as ref_build_model
from repro.serving import ContinuousBatchingScheduler as RefScheduler
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import DeploymentProfile, analyze, build_artifact
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine, cold_start

ARCH = "deepseek-v2-lite-16b"
# fp32 tolerance of tests/test_torch_models.py: the two frameworks' reduction
# orders differ by O(10) ulps of O(1) values; 256 eps keeps a >10x margin
TOL = 256 * float(np.finfo(np.float32).eps)
MAX_SEQ = 16
# the scheduler's arrival script: (prompt length, steps) before the loop,
# then after two loop steps; (14, 4) is over-length at MAX_SEQ
FIRST = [(6, 5), (9, 3), (6, 6), (14, 4)]
SECOND = [(4, 2), (9, 4), (12, 3)]
REQ_STATS = ("steps", "prefill_retries", "decode_retries", "faulted_units", "faulted_bytes")
SCHED_STATS = ("admitted", "completed", "rejected", "steps", "max_active", "kv_tokens_dense", "kv_tokens_paged")


def _strict(cfg):
    return dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                vocab_row_group=max(64, cfg.vocab_size // 16))


def _ref_cfg():
    return ref_get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)


def _cfg():
    return get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's strict artifact of reduced DeepSeek-V2-Lite, its plan
    and weights, and the port's model and plan."""
    model = ref_build_model(_ref_cfg())
    result = ref_analyze(model, RefProfile(**_strict(model.cfg)), trace_B=1, trace_S=32)
    params = model.init(jax.random.PRNGKey(0))
    outdir = str(tmp_path_factory.mktemp("ref_deepseek"))
    ref_build_artifact(params, result, outdir)
    port = build_model(_cfg())
    port_result = analyze(port, DeploymentProfile(**_strict(port.cfg)), trace_B=1, trace_S=32)
    return model, result, params, outdir, port, port_result


def _mla_params(ref_params):
    """Layer lead.b0's MLA weights in both frameworks."""
    ref = ref_params["lead"]["b0"]["attn"]
    return ref, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}


def test_mla_forward_matches_reference(reference):
    ref_model, _, ref_params, _, port, _ = reference
    ref_p, p = _mla_params(ref_params)
    B, S = 2, 10
    rs = np.random.default_rng(3)
    x = rs.standard_normal((B, S, port.cfg.d_model), dtype=np.float32)
    positions = np.broadcast_to(np.arange(S), (B, S))
    ref_out, (ref_ckv, ref_kr) = ref_attn.mla_forward(ref_p, jnp.asarray(x), jnp.asarray(positions),
                                                      ref_model.cfg, return_cache=True)
    launches = fa_ops.flash_attention.launches
    out, (ckv, kr) = attn.mla_forward(p, torch.from_numpy(x), torch.from_numpy(positions.copy()), port.cfg)
    assert fa_ops.flash_attention.launches == launches  # MLA's attention is plain, as the reference's
    m = port.cfg.mla
    assert ckv.shape == (B, S, m.kv_lora_rank) and kr.shape == (B, S, m.qk_rope_head_dim)
    for got, want in ((out, ref_out), (ckv, ref_ckv), (kr, ref_kr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_mla_decode_matches_reference_and_writes_in_place(reference):
    """Absorbed decode steps over a latent cache grafted from a prefill:
    outputs and caches equal the reference's functional step, and each step
    returns the very cache tensors it was given."""
    ref_model, _, ref_params, _, port, _ = reference
    ref_p, p = _mla_params(ref_params)
    cfg, m = port.cfg, port.cfg.mla
    B, S, S_max = 2, 7, 16
    rs = np.random.default_rng(4)
    x = rs.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    _, (ckv0, kr0) = attn.mla_forward(p, torch.from_numpy(x), torch.arange(S)[None].expand(B, S), cfg)
    ckv = torch.zeros(B, S_max, m.kv_lora_rank)
    kr = torch.zeros(B, S_max, m.qk_rope_head_dim)
    ckv[:, :S], kr[:, :S] = ckv0, kr0
    ref_ckv, ref_kr = jnp.asarray(ckv.numpy()), jnp.asarray(kr.numpy())
    for step in range(4):
        xt = rs.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        pos = np.array([S + step, S + 2 * step], dtype=np.int64)  # ragged positions
        ref_out, ref_ckv, ref_kr = ref_attn.mla_decode(ref_p, jnp.asarray(xt), jnp.asarray(pos, jnp.int32),
                                                       ref_ckv, ref_kr, ref_model.cfg)
        out, ckv_new, kr_new = attn.mla_decode(p, torch.from_numpy(xt), torch.from_numpy(pos), ckv, kr, cfg)
        assert ckv_new is ckv and kr_new is kr
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(ckv.numpy(), np.asarray(ref_ckv), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(kr.numpy(), np.asarray(ref_kr), atol=TOL, rtol=TOL)


def _events(stats):
    return [(e.key, e.nbytes, e.source, e.phase) for e in stats.events]


@pytest.mark.parametrize("policy", ["strict", "stats", "full"])
@pytest.mark.parametrize("B,S,steps,seed", [(2, 8, 6, 7), (1, 12, 4, 3)])
def test_port_serves_reference_deepseek_artifact_identically(reference, B, S, steps, seed, policy):
    """Under strict the port faults the reference's units from the same
    sources in the same order, with the same evictions and refaults. Under
    full (no budget) the prefetcher loads hinted row groups while the request
    thread faults, so once both drain the loaded units and bytes are the
    reference's, whoever loaded them, as for Yi in
    tests/test_torch_serving.py. Under stats
    the prefetcher's loads race the request thread, so the tokens are held
    to the reference's strict run and the budget invariant to the plan, as
    for Mixtral in tests/test_torch_serving.py."""
    ref_model, ref_result, _, outdir, model, result = reference
    tokens = np.random.default_rng(seed).integers(0, ref_model.cfg.vocab_size, (B, S))
    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2",
                                residency="strict" if policy == "stats" else policy, compile_warm_set=False)
    ref_out, ref_stats = RefEngine(ref_server, max_seq=S + steps + 4).generate(
        jnp.asarray(tokens, jnp.int32), steps)
    if policy == "full":
        assert ref_server.prefetcher.drain(30.0)
    ref_server.close()
    if policy == "stats":  # the budget to compare with
        ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="stats",
                                    compile_warm_set=False)
        ref_server.close()

    assert result.plan.summary() == ref_result.plan.summary()
    with cold_start(model, outdir, result, residency=policy, warm_shapes=((B, S),), device="cpu") as server:
        assert server.report.bytes_read == ref_server.report.bytes_read
        out, stats = GenerationEngine(server, max_seq=S + steps + 4).generate(torch.from_numpy(tokens), steps)
        tiered, ref_tiered = server.tiered, ref_server.tiered
        np.testing.assert_array_equal(out, ref_out)
        assert tiered.residency.budget_bytes == ref_tiered.residency.budget_bytes
        assert stats.faulted_units > 0
        if policy == "stats":
            budget = tiered.residency.budget_bytes
            assert tiered.residency.max_resident_bytes <= budget or tiered.residency.overshoot_events > 0
            assert server.prefetcher.drain(30.0)
            assert tiered.resident_bytes <= budget
        elif policy == "full":
            # no budget: every unit either side touched is loaded once; who
            # loaded it (fault or prefetch of a hinted row group) is a race
            assert server.prefetcher.drain(30.0)
            assert Counter((e.key, e.nbytes) for e in tiered.stats.events) == \
                Counter((e.key, e.nbytes) for e in ref_tiered.stats.events)
            assert tiered.stats.evictions == ref_tiered.stats.evictions == 0
        else:
            assert _events(tiered.stats) == _events(ref_tiered.stats)
            assert tiered.resident_keys == ref_tiered.resident_keys
            assert stats.faulted_units == ref_stats.faulted_units
            assert stats.faulted_bytes == ref_stats.faulted_bytes
            assert (stats.prefill_retries, stats.decode_retries) == \
                (ref_stats.prefill_retries, ref_stats.decode_retries)
            assert tiered.stats.evictions == ref_tiered.stats.evictions
            assert tiered.stats.refaults == ref_tiered.stats.refaults
            assert all(".moe.w_" in e.key or e.key.startswith("embed#") for e in tiered.stats.events)


def test_port_deepseek_artifact_equals_reference(reference, tmp_path):
    _, _, ref_params, ref_dir, _, result = reference
    params = params_from_numpy({p: np.asarray(v) for p, v in ref_flatten(ref_params)}, "cpu")
    meta = build_artifact(params, result, str(tmp_path))
    with open(os.path.join(ref_dir, "artifact.json")) as f:
        assert json.load(f) == meta
    for name in ("artifact.json", "tier0.bin", "tier0.index.json", "optional.blob",
                 "optional.blob.manifest.json"):
        with open(os.path.join(ref_dir, name), "rb") as f1, open(tmp_path / name, "rb") as f2:
            assert f1.read() == f2.read(), name


def _prompt(S, seed):
    return np.random.default_rng(seed).integers(0, 512, S).astype(np.int32)


def _drive(sched) -> list:
    first = [(_prompt(S, i), n) for i, (S, n) in enumerate(FIRST)]
    second = [(_prompt(S, 10 + i), n) for i, (S, n) in enumerate(SECOND)]
    reqs = [sched.submit(p, n) for p, n in first]
    sched.run(max_steps=2)  # the second wave arrives mid-run
    reqs += [sched.submit(p, n) for p, n in second]
    sched.run()
    return reqs, first + second


def test_deepseek_scheduler_matches_reference_and_solo_runs(reference):
    """One arrival script through both schedulers under strict (3 slots):
    equal tokens, errors, per-request and loop stats and loads; then on a
    full server every request's tokens equal its own generate()."""
    ref_model, ref_result, _, outdir, model, result = reference
    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="strict",
                                compile_warm_set=False)
    ref_sched = RefScheduler(RefEngine(ref_server, max_seq=MAX_SEQ), max_batch=3)
    ref_reqs, _ = _drive(ref_sched)
    ref_server.close()
    with cold_start(model, outdir, result, residency="strict", compile_warm_set=False, device="cpu") as server:
        sched = ContinuousBatchingScheduler(GenerationEngine(server, max_seq=MAX_SEQ), max_batch=3)
        reqs, _ = _drive(sched)
        loads = [(e.key, e.nbytes, e.source) for e in server.tiered.stats.events]
    assert [(e.key, e.nbytes, e.source) for e in ref_server.tiered.stats.events] == loads
    assert sched.stats.rejected == 1 and sched.stats.completed == len(reqs) - 1
    for r, ref in zip(reqs, ref_reqs):
        assert r.done and r.error == ref.error
        np.testing.assert_array_equal(r.output, ref.output)
        assert [getattr(r.stats, f) for f in REQ_STATS] == [getattr(ref.stats, f) for f in REQ_STATS]
    assert [getattr(sched.stats, f) for f in SCHED_STATS] == [getattr(ref_sched.stats, f) for f in SCHED_STATS]

    with cold_start(model, outdir, result, residency="full", compile_warm_set=False, device="cpu") as server:
        eng = GenerationEngine(server, max_seq=MAX_SEQ)
        reqs, script = _drive(ContinuousBatchingScheduler(eng, max_batch=3))
        for r, (p, n) in zip(reqs, script):
            if r.error is None:
                solo, _ = eng.generate(torch.from_numpy(p[None].astype(np.int64)), n)
                np.testing.assert_array_equal(r.output, solo[0])
    assert sum(r.error is None for r in reqs) == len(reqs) - 1

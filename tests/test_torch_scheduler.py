"""The port's continuous-batching scheduler and compiled decode against the
JAX reference, on the CPU at float32 with reduced configs and reference
weights:

  * one fixed arrival script (mixed prompt lengths and steps, an over-length
    request, admission between decode steps) served by both schedulers from
    the reference's strict artifact: the same tokens, per-request
    ``RequestStats``, ``SchedulerStats`` and load sequence;
  * each request's tokens equal its own ``generate()`` in the port;
  * mirrors of the reference's scheduler and admission tests: slot reuse,
    over-length rejection, pages freed at retire and none leaked by a failed
    request, page exhaustion, FIFO and SLO admission, and the policy and
    pool shape a scheduler takes from ``cold_start``'s defaults;
  * ``decode_step_masked``'s usage masks equal the reference's, so a free
    slot never faults an expert;
  * the in-place decode: K/V written into the caches given, carry state
    committed separately, N steps equal to the reference's for Mixtral, Yi
    with a rolling window, RecurrentGemma, Gemma-3's local/global stack and
    DeepSeek's latent MLA caches, and xLSTM's fp32 state; a step run twice
    equals one;
  * ``_graft_slot_cache`` equals the reference's on group, lead and tail
    leaves and on carry-state leaves;
  * the compiled entries' contract on the CPU (the plain calls)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.core import DeploymentProfile as RefProfile
from repro.core import analyze as ref_analyze
from repro.core import build_artifact as ref_build_artifact
from repro.models.zoo import build_model as ref_build_model
from repro.serving import ContinuousBatchingScheduler as RefScheduler
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro.serving.engine import _graft_prefill_cache as ref_graft
from repro.serving.engine import _strip_usage as ref_strip
from repro.serving.scheduler import _graft_slot_cache as ref_graft_slots
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import DeploymentProfile, analyze
from repro_torch.models import build_model
from repro_torch.serving import (
    ContinuousBatchingScheduler,
    FIFOAdmission,
    GenerationEngine,
    RequestQueue,
    SLOAdmission,
    cold_start,
)
from repro_torch.serving.engine import _graft_prefill_cache, _strip_usage, commit_decode_caches
from repro_torch.serving.scheduler import _graft_slot_cache
from repro_torch.utils.tree import flatten_with_paths

ARCH = "mixtral-8x22b"
MAX_SEQ = 16
# fp32 tolerance of tests/test_torch_models.py: the two frameworks' reduction
# orders differ by O(10) ulps of O(1) values; 256 eps keeps a >10x margin
TOL = 256 * float(np.finfo(np.float32).eps)
# the arrival script: (prompt length, steps) submitted before the loop, then
# after two loop steps; (14, 4) is over-length at max_seq 16
FIRST = [(6, 5), (9, 3), (6, 6), (14, 4)]
SECOND = [(4, 2), (9, 4), (12, 3)]
REQ_STATS = ("steps", "prefill_retries", "decode_retries", "faulted_units", "faulted_bytes")
SCHED_STATS = ("admitted", "completed", "rejected", "steps", "max_active", "kv_tokens_dense",
               "kv_tokens_paged", "kv_pages_high_water")


def _strict(cfg):
    return dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                vocab_row_group=max(64, cfg.vocab_size // 16))


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    """The reference's strict artifact of reduced Mixtral (fp32) and the
    port's model and plan for it."""
    ref_cfg = ref_get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)
    ref_model = ref_build_model(ref_cfg)
    ref_result = ref_analyze(ref_model, RefProfile(**_strict(ref_cfg)), trace_B=1, trace_S=32)
    outdir = str(tmp_path_factory.mktemp("sched_artifact"))
    ref_build_artifact(ref_model.init(jax.random.PRNGKey(0)), ref_result, outdir)
    cfg = get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)
    model = build_model(cfg)
    result = analyze(model, DeploymentProfile(**_strict(cfg)), trace_B=1, trace_S=32)
    return ref_model, ref_result, model, result, outdir


def _prompt(S, seed):
    return np.random.default_rng(seed).integers(0, 512, S).astype(np.int32)


def _script():
    first = [(_prompt(S, i), n) for i, (S, n) in enumerate(FIRST)]
    second = [(_prompt(S, 10 + i), n) for i, (S, n) in enumerate(SECOND)]
    return first, second


def _drive(sched) -> list:
    first, second = _script()
    reqs = [sched.submit(p, n) for p, n in first]
    sched.run(max_steps=2)  # the second wave arrives mid-run
    reqs += [sched.submit(p, n) for p, n in second]
    sched.run()
    return reqs


def _port_server(app, **kw):
    _, _, model, result, outdir = app
    kw.setdefault("residency", "strict")
    return cold_start(model, outdir, result, compile_warm_set=False, device="cpu", **kw)


@pytest.mark.parametrize("max_batch", [2, 3])
def test_scheduler_matches_reference_scheduler(app, max_batch):
    """The same arrival script through both schedulers under strict: equal
    tokens, errors, per-request stats, loop stats and loads."""
    ref_model, ref_result, _, _, outdir = app
    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="strict",
                                compile_warm_set=False)
    ref_sched = RefScheduler(RefEngine(ref_server, max_seq=MAX_SEQ), max_batch=max_batch)
    ref_reqs = _drive(ref_sched)
    ref_server.close()
    with _port_server(app) as server:
        sched = ContinuousBatchingScheduler(GenerationEngine(server, max_seq=MAX_SEQ), max_batch=max_batch)
        reqs = _drive(sched)
        loads = [(e.key, e.nbytes, e.source) for e in server.tiered.stats.events]
    assert [(e.key, e.nbytes, e.source) for e in ref_server.tiered.stats.events] == loads
    assert sched.stats.rejected == 1 and sched.stats.completed == len(reqs) - 1
    assert sched.stats.max_active == max_batch
    for r, ref in zip(reqs, ref_reqs):
        assert r.done and r.error == ref.error
        np.testing.assert_array_equal(r.output, ref.output)
        assert [getattr(r.stats, f) for f in REQ_STATS] == [getattr(ref.stats, f) for f in REQ_STATS]
    assert [getattr(sched.stats, f) for f in SCHED_STATS] == [getattr(ref_sched.stats, f) for f in SCHED_STATS]


def test_scheduler_matches_solo_generate(app):
    """Every request of the script gives the tokens of its own generate()."""
    with _port_server(app, residency="full") as server:
        eng = GenerationEngine(server, max_seq=MAX_SEQ)
        sched = ContinuousBatchingScheduler(eng, max_batch=3)
        reqs = _drive(sched)
        first, second = _script()
        for r, (p, n) in zip(reqs, first + second):
            if r.error is not None:
                continue
            solo, _ = eng.generate(torch.from_numpy(p[None].astype(np.int64)), n)
            np.testing.assert_array_equal(r.output, solo[0])
    assert sum(r.error is None for r in reqs) == len(reqs) - 1


def test_slot_reuse_after_completion(app):
    """More requests than slots: freed slots re-admit from the queue, every
    request completes over one decode shape, FIFO completion order."""
    with _port_server(app) as server:
        sched = ContinuousBatchingScheduler(GenerationEngine(server, max_seq=MAX_SEQ), max_batch=2)
        reqs = [sched.submit(_prompt(6, 20 + i), 3) for i in range(6)]
        sched.run()
        assert set(server._compiled) == {("prefill", 2, 6), ("decode_masked", 2, MAX_SEQ)}
    assert all(r.done and r.error is None for r in reqs)
    assert [len(r.out) for r in reqs] == [3] * 6
    assert sched.stats.admitted == 6 and sched.stats.completed == 6 and sched.stats.max_active <= 2
    finish = [r.finished_t for r in reqs]
    assert finish == sorted(finish)


def test_over_length_rejected_loop_survives(app):
    with _port_server(app) as server:
        eng = GenerationEngine(server, max_seq=MAX_SEQ)
        with pytest.raises(ValueError, match="max_seq"):
            eng.generate(torch.zeros((1, 6), dtype=torch.int64), MAX_SEQ)
        sched = ContinuousBatchingScheduler(eng, max_batch=2)
        ok1 = sched.submit(_prompt(6, 40), 3)
        bad = sched.submit(np.zeros(MAX_SEQ, np.int32), 4)
        ok2 = sched.submit(_prompt(6, 41), 3)
        sched.run()
    assert bad.done and "rejected" in bad.error and bad.out == []
    for r in (ok1, ok2):
        assert r.done and r.error is None and len(r.out) == 3
    assert sched.stats.rejected == 1 and sched.stats.completed == 2


def test_pages_freed_at_retire_are_reused(app):
    with _port_server(app) as server:
        sched = ContinuousBatchingScheduler(GenerationEngine(server, max_seq=MAX_SEQ), max_batch=2,
                                            kv_page_size=4)
        pool = sched.page_pool
        per_req = pool.pages_for(6 + 3)
        reqs = [sched.submit(_prompt(6, 80 + i), 3) for i in range(6)]
        sched.run()
    assert all(r.done and r.error is None for r in reqs)
    pool.assert_consistent()
    assert pool.used_pages == 0 and pool.stats.allocs == 6 and pool.stats.frees == 6
    assert pool.stats.high_water_pages <= 2 * per_req
    assert sched.stats.kv_pages_high_water == pool.stats.high_water_pages
    assert 0 < sched.stats.kv_tokens_paged <= sched.stats.kv_tokens_dense


def test_failed_requests_leak_no_pages(app):
    """A prefill that raises and a decode step that raises both return their
    pages and fail their requests; the loop then serves a healthy one."""
    with _port_server(app) as server:
        eng = GenerationEngine(server, max_seq=MAX_SEQ)
        sched = ContinuousBatchingScheduler(eng, max_batch=2)
        pool = sched.page_pool

        def boom(*a, **kw):
            raise RuntimeError("injected fault")

        real_prefill, eng.prefill_step = eng.prefill_step, boom
        r1 = sched.submit(_prompt(6, 90), 3)
        sched.run()
        assert r1.done and "prefill failed" in r1.error
        pool.assert_consistent()
        assert pool.used_pages == 0
        eng.prefill_step = real_prefill

        real_decode, eng.decode_once = eng.decode_once, boom
        r2 = sched.submit(_prompt(6, 91), 3)
        sched.run()
        assert r2.done and "decode step failed" in r2.error
        pool.assert_consistent()
        assert pool.used_pages == 0
        eng.decode_once = real_decode

        r3 = sched.submit(_prompt(6, 90), 2)
        sched.run()
    assert r3.done and r3.error is None and len(r3.out) == 2
    assert pool.used_pages == 0 and sched.stats.failed == 2


def test_scheduler_takes_its_defaults_from_the_server(app):
    """``cold_start(admission=, kv_page_size=, kv_pages=)`` keeps the three on
    the server, and a scheduler built without keyword arguments takes the
    policy and the pool's page size and count from it, as the reference's
    does; a keyword argument still wins, and a server without them gives
    FIFO and a pool of exactly max_batch × max_seq positions."""
    from repro.serving import SLOAdmission as RefSLO

    ref_model, ref_result, _, _, outdir = app
    kw = dict(kv_page_size=8, kv_pages=5)
    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="strict",
                                compile_warm_set=False, admission=RefSLO(step_est_s=5e-3), **kw)
    ref_sched = RefScheduler(RefEngine(ref_server, max_seq=MAX_SEQ), max_batch=2)
    ref_server.close()
    slo = SLOAdmission(step_est_s=5e-3)
    with _port_server(app, admission=slo, **kw) as server:
        assert (server.admission, server.kv_page_size, server.kv_pages) == (slo, 8, 5)
        eng = GenerationEngine(server, max_seq=MAX_SEQ)
        sched = ContinuousBatchingScheduler(eng, max_batch=2)
        assert sched.admission is slo and type(ref_sched.admission).__name__ == "SLOAdmission"
        for pool in (sched.page_pool, ref_sched.page_pool):
            assert (pool.page_size, pool.n_pages, pool.n_slots) == (8, 5, 2)
        fifo = FIFOAdmission()
        own = ContinuousBatchingScheduler(eng, max_batch=2, admission=fifo, kv_page_size=4, kv_pages=9)
        assert own.admission is fifo and (own.page_pool.page_size, own.page_pool.n_pages) == (4, 9)
        reqs = [sched.submit(_prompt(6, 60 + i), 3) for i in range(3)]
        sched.run()
    assert all(r.done and r.error is None and len(r.out) == 3 for r in reqs)
    with _port_server(app) as server:
        plain = ContinuousBatchingScheduler(GenerationEngine(server, max_seq=MAX_SEQ), max_batch=2)
        assert isinstance(plain.admission, FIFOAdmission)
        assert (plain.page_pool.page_size, plain.page_pool.n_pages) == (16, 2)


def test_page_exhaustion_rejects_cleanly(app):
    with _port_server(app) as server:
        sched = ContinuousBatchingScheduler(GenerationEngine(server, max_seq=MAX_SEQ), max_batch=2,
                                            kv_page_size=4, kv_pages=2)  # 8 positions in all
        pool = sched.page_pool
        big = sched.submit(_prompt(6, 95), 4)  # 6 + 4 positions: 3 pages
        small = sched.submit(np.asarray([1, 2], np.int32), 2)  # 2 + 2: 1 page
        sched.run()
    assert big.done and "kv page pool exhausted" in big.error and big.out == []
    assert small.done and small.error is None and len(small.out) == 2
    assert sched.stats.rejected == 1 and sched.stats.completed == 1
    pool.assert_consistent()
    assert pool.used_pages == 0 and pool.stats.exhausted == 1
    assert all(s is None for s in sched._slots)


def _validate_max8(req):
    S = int(req.tokens.size)
    if S == 0 or S + req.n_steps > 8 or req.n_steps < 1:
        return f"rejected: prompt {S} + {req.n_steps} steps exceeds max_seq=8 (or is empty)"
    return None


def test_fifo_admission_pops_arrival_order_and_rejects():
    q = RequestQueue()
    good1, bad, good2 = q.submit([1, 2], 3), q.submit([1, 2, 3], 99), q.submit([3], 2)
    pol = FIFOAdmission()
    admit, drop = pol.select(q, 2, time.perf_counter(), _validate_max8)
    assert [r.rid for r in admit] == [good1.rid, good2.rid]
    assert [(r.rid, kind) for r, kind, _ in drop] == [(bad.rid, "rejected")]
    assert drop[0][2].startswith("rejected: prompt 3 + 99 steps") and pol.pending() == 0
    q.submit([5], 1)
    assert pol.select(q, 0, time.perf_counter(), _validate_max8) == ([], []) and len(q) == 1


def test_slo_admission_sheds_reorders_and_tracks_service_times():
    """Shed on hopeless before service, re-order a burst by priority then
    deadline, fall back to FIFO without deadlines, shed a backlogged request
    once it becomes hopeless, and follow observed step times."""
    q = RequestQueue()
    hopeless, fine = q.submit([1, 2], 5, deadline_s=1e-6), q.submit([1, 2], 5)
    pol = SLOAdmission(step_est_s=1e-3, prefill_est_s=1e-3)
    admit, drop = pol.select(q, 4, time.perf_counter(), _validate_max8)
    assert [r.rid for r in admit] == [fine.rid]
    assert [(r.rid, kind) for r, kind, _ in drop] == [(hopeless.rid, "shed")] and drop[0][2].startswith("shed: ")

    q = RequestQueue()
    slow, urgent, vip = (q.submit([1], 2, deadline_s=60.0), q.submit([1], 2, deadline_s=1.0),
                         q.submit([1], 2, priority=5))
    pol = SLOAdmission(step_est_s=1e-4, prefill_est_s=1e-4)
    admit, drop = pol.select(q, 2, time.perf_counter(), _validate_max8)
    assert [r.rid for r in admit] == [vip.rid, urgent.rid] and drop == [] and pol.pending() == 1
    assert [r.rid for r in pol.select(q, 2, time.perf_counter(), _validate_max8)[0]] == [slow.rid]

    q = RequestQueue()
    reqs = [q.submit([1], 2) for _ in range(5)]
    pol = SLOAdmission()
    assert [r.rid for r in pol.select(q, 3, time.perf_counter(), _validate_max8)[0]] == [0, 1, 2]
    assert [r.rid for r in pol.select(q, 3, time.perf_counter(), _validate_max8)[0]] == [3, 4]
    assert pol.shed_total == 0 and len(reqs) == 5

    q = RequestQueue()
    first, late = q.submit([1], 2, priority=1), q.submit([1], 2, deadline_s=0.05)
    pol = SLOAdmission(step_est_s=1e-4, prefill_est_s=1e-4)
    assert [r.rid for r in pol.select(q, 1, time.perf_counter(), _validate_max8)[0]] == [first.rid]
    admit, drop = pol.select(q, 1, time.perf_counter() + 0.06, _validate_max8)  # its deadline has passed
    assert admit == [] and [(r.rid, kind) for r, kind, _ in drop] == [(late.rid, "shed")]

    pol = SLOAdmission(step_est_s=1e-3, ema=0.5)
    for _ in range(8):
        pol.note_step(0.1, 2)
    assert pol._step_est == pytest.approx(0.1, rel=0.05)


def test_slo_burst_sheds_and_serves_rest_exactly(app):
    """A burst in which two requests carry a deadline no service can meet
    (the step estimate is injected): those two are shed unserved, the rest
    give their solo tokens, and run() drains the backlog."""
    with _port_server(app, residency="full") as server:
        eng = GenerationEngine(server, max_seq=MAX_SEQ)
        prompts = [_prompt(6, 50 + i) for i in range(4)]
        refs = [eng.generate(torch.from_numpy(p[None].astype(np.int64)), 3)[0][0] for p in prompts]
        sched = ContinuousBatchingScheduler(eng, max_batch=2, admission=SLOAdmission(step_est_s=5e-3))
        good = [sched.submit(p, 3) for p in prompts[:2]]
        doomed = [sched.queue.submit(p, 3, deadline_s=1e-6) for p in prompts[2:]]
        sched.run()
        assert sched.idle
    for r, ref in zip(good, refs):
        assert r.done and r.error is None
        np.testing.assert_array_equal(r.output, ref)
    for r in doomed:
        assert r.done and r.shed and r.out == []
    assert sched.stats.shed == 2 and sched.stats.completed == 2


def _models(arch, **replace):
    cfg_kw = dict(dtype="float32", collect_moe_usage=True, **replace)
    ref_model = ref_build_model(ref_get_reduced(arch).replace(**cfg_kw))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat = {p: np.asarray(v) for p, v in ref_flatten(ref_params)}
    return ref_model, ref_params, build_model(get_reduced(arch).replace(**cfg_kw)), params_from_numpy(flat, "cpu")


def _assert_close(ref_tree, port_tree):
    ref_flat, port_flat = dict(ref_flatten(ref_tree)), dict(flatten_with_paths(port_tree))
    assert list(ref_flat) == list(port_flat)
    for p, v in port_flat.items():
        np.testing.assert_allclose(v.float().numpy(), np.asarray(ref_flat[p], np.float32), atol=TOL, rtol=TOL,
                                   err_msg=p)


def test_masked_decode_usage_matches_reference():
    """With slot 1 inactive, every layer's usage mask equals the reference's
    and leaves out the experts only slot 1 routed to; with every slot
    inactive, no expert is marked. Logits equal the unmasked step's."""
    ref_model, ref_params, model, params = _models(ARCH)
    B, S, S_max = 3, 6, 12
    tokens = np.random.default_rng(5).integers(0, 512, (B, S))
    _, ref_c = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    _, c = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    tok = np.random.default_rng(6).integers(0, 512, (B, 1))
    for active in ([True, False, True], [False, False, False]):
        caches = _graft_prefill_cache(model.init_cache(B, S_max, multimodal=False, device="cpu"), _strip_usage(c))
        ref_caches = ref_graft(ref_model.init_cache(B, S_max, multimodal=False), ref_strip(ref_c))
        batch = {"tokens": torch.from_numpy(tok), "pos": torch.full((B,), S), "active": torch.tensor(active)}
        ref_batch = {"tokens": jnp.asarray(tok, jnp.int32), "pos": jnp.full((B,), S, jnp.int32),
                     "active": jnp.asarray(active)}
        ref_logits, ref_new = ref_model.decode_step_masked(ref_params, ref_caches, ref_batch)
        logits, new = model.decode_step_masked(params, caches, batch)
        usage = {p: v.numpy() for p, v in flatten_with_paths(new) if p.endswith("moe_usage")}
        ref_usage = {p: np.asarray(v) for p, v in ref_flatten(ref_new) if p.endswith("moe_usage")}
        assert usage.keys() == ref_usage.keys() and usage
        for p in usage:
            np.testing.assert_array_equal(usage[p], ref_usage[p])
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=TOL, rtol=TOL)
        if not any(active):
            assert not any(u.any() for u in usage.values())
    with pytest.raises(ValueError, match="active"):
        model.decode_step_masked(params, caches, {"tokens": batch["tokens"], "pos": batch["pos"]})


@pytest.mark.parametrize("arch,replace,S", [(ARCH, {}, 28), ("yi-34b", {"sliding_window": 8}, 6),
                                            ("recurrentgemma-9b", {"num_layers": 5}, 28),
                                            ("gemma3-27b", {}, 12), ("deepseek-v2-lite-16b", {}, 28),
                                            ("xlstm-125m", {}, 32)], ids=str)
def test_in_place_decode_matches_reference(arch, replace, S):
    """Steps across the window (32, 16 for Gemma-3's local layers, or 8 for
    Yi; the prompt stays inside it, as the prefill graft needs): every K/V
    leaf the step returns (MLA's latent ``ckv`` / ``kr``) is the cache tensor
    it was given (written in place), every other leaf (xLSTM's whole state)
    a new one, and after each commit the caches and logits equal the
    reference's functional step."""
    ref_model, ref_params, model, params = _models(arch, **replace)
    B, S_max, steps = 2, 48, 6
    ref_decode = jax.jit(ref_model.decode_step)
    tokens = np.random.default_rng(7).integers(0, 512, (B, S))
    ref_logits, ref_c = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    _, c = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    ref_caches = ref_graft(ref_model.init_cache(B, S_max, multimodal=False), ref_strip(ref_c))
    caches = _graft_prefill_cache(model.init_cache(B, S_max, multimodal=False, device="cpu"), _strip_usage(c))
    leaves = dict(flatten_with_paths(caches))
    if replace.get("sliding_window"):
        assert leaves["groups.u0.k"].shape[2] == 8  # rolling: the cache holds the window
    tok = np.argmax(np.asarray(ref_logits), -1)
    for step in range(steps):
        ref_logits, ref_caches = ref_decode(ref_params, ref_caches, {
            "tokens": jnp.asarray(tok[:, None], jnp.int32), "pos": jnp.full((B,), S + step, jnp.int32)})
        logits, new = model.decode_step(params, caches, {"tokens": torch.from_numpy(tok[:, None]),
                                                        "pos": torch.full((B,), S + step)})
        for p, leaf in flatten_with_paths(_strip_usage(new)):
            assert (leaf is leaves[p]) == p.endswith((".k", ".v", ".ckv", ".kr")), p
        commit_decode_caches(caches, new)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=TOL, rtol=TOL)
        ref_caches = ref_strip(ref_caches)
        _assert_close(ref_caches, caches)
        tok = np.argmax(np.asarray(ref_logits), -1)


def test_decode_step_run_twice_equals_one_run():
    """RecurrentGemma (rec groups and tail, attention group): a step re-run
    on the same caches, as the engine does after a fault, gives the same
    logits and, once committed, the same caches as a single run."""
    _, _, model, params = _models("recurrentgemma-9b", num_layers=5)
    B, S = 2, 10
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 512, (B, S)))
    _, c = model.prefill(params, {"tokens": tokens})
    batch = {"tokens": tokens[:, -1:], "pos": torch.full((B,), S)}
    once = _graft_prefill_cache(model.init_cache(B, 20, multimodal=False, device="cpu"), _strip_usage(c))
    twice = _graft_prefill_cache(model.init_cache(B, 20, multimodal=False, device="cpu"), _strip_usage(c))
    logits_once, new = model.decode_step(params, once, batch)
    commit_decode_caches(once, new)
    first, _ = model.decode_step(params, twice, batch)
    logits_twice, new = model.decode_step(params, twice, batch)
    commit_decode_caches(twice, new)
    assert torch.equal(first, logits_twice) and torch.equal(logits_once, logits_twice)
    for (p, a), (_, b) in zip(flatten_with_paths(once), flatten_with_paths(twice)):
        assert torch.equal(a, b), p
    assert any(p.endswith(".lru") for p, _ in flatten_with_paths(once))


def test_graft_slot_cache_matches_reference():
    """RecurrentGemma's 5-layer caches (a group of rec, rec, attn with batch
    on axis 1; a rec tail) plus a lead K/V leaf: an admission group of two
    grafted into slots 3 and 1 of four, in place, equals the reference's."""
    _, _, model, params = _models("recurrentgemma-9b", num_layers=5)
    B, S_max, S = 4, 16, 6
    rs = np.random.default_rng(9)
    _, c = model.prefill(params, {"tokens": torch.from_numpy(rs.integers(0, 512, (2, S)))})
    small = _strip_usage(c)
    small["lead"] = {"b0": {"k": torch.from_numpy(rs.standard_normal((2, S, 1, 4), dtype=np.float32))}}
    big = model.init_cache(B, S_max, multimodal=False, device="cpu")
    big["lead"] = {"b0": {"k": torch.zeros(B, S_max, 1, 4)}}
    for _, leaf in flatten_with_paths(big):
        leaf.copy_(torch.from_numpy(rs.standard_normal(tuple(leaf.shape), dtype=np.float32)))
    def to_jax(tree):
        return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)

    ref = dict(ref_flatten(ref_graft_slots(to_jax(big), to_jax(small), jnp.asarray([3, 1], jnp.int32))))
    leaves = dict(flatten_with_paths(big))
    assert _graft_slot_cache(big, small, [3, 1]) is big
    assert set(leaves) == set(ref) >= {"groups.u0.conv", "groups.u2.k", "tail.b0.lru", "lead.b0.k"}
    for p, leaf in flatten_with_paths(big):
        assert leaf is leaves[p]  # written in place
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref[p]), err_msg=p)


def test_compiled_entries_on_cpu(app):
    """On the CPU each entry is the plain call, made once per shape; a decode
    entry owns its caches, and a call with other params, other caches or
    another shape raises."""
    with _port_server(app) as server:
        eng = GenerationEngine(server, max_seq=MAX_SEQ)
        out, _ = eng.generate(torch.from_numpy(_prompt(6, 3)[None].astype(np.int64)), 4)
        pre, dec = server.compiled_prefill(1, 6), server.compiled_decode(1, MAX_SEQ)
        assert server.compiled_prefill(1, 6) is pre and list(server._compiled) == [("decode", 1, MAX_SEQ),
                                                                                   ("prefill", 1, 6)]
        params = server.live_params()
        batch = {"tokens": torch.zeros(1, 1, dtype=torch.int64), "pos": torch.zeros(1, dtype=torch.int64)}
        with pytest.raises(ValueError, match="params"):
            pre(dict(params), {"tokens": torch.zeros(1, 6, dtype=torch.int64)})
        with pytest.raises(ValueError, match="own caches"):
            dec(params, server.model.init_cache(1, MAX_SEQ, multimodal=False, device="cpu"), batch)
        with pytest.raises(ValueError, match="shape"):
            pre(params, {"tokens": torch.zeros(2, 6, dtype=torch.int64)})
        before = {p: t.data_ptr() for p, t in flatten_with_paths(dec.caches)}
        again, _ = eng.generate(torch.from_numpy(_prompt(6, 3)[None].astype(np.int64)), 4)
        assert {p: t.data_ptr() for p, t in flatten_with_paths(dec.caches)} == before
    np.testing.assert_array_equal(out, again)
    assert not server._compiled  # close() frees the entries

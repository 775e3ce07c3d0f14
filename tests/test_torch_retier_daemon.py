"""The port's online re-tiering daemon (``repro_torch.core.retier_daemon``)
and the trace hooks it drives on ``TieredParams``, against the reference's
(tests/test_retier_daemon.py), each package over an optional store the
reference wrote:

  * ``rotate_trace`` / ``trace_snapshot`` give the reference's windows;
  * under a budget with no prefetcher (strict), a scripted run ticks both
    daemons to the same promoted and demoted keys, ``RetierReport``,
    resident set, loads and ``RetierDaemonStats``, tick for tick;
  * the reference's contract: live promotion and demotion, preload through
    the prefetcher and the predictor refresh, decay forgetting a phase,
    cadence by step and by wall clock (the daemon's clock patched), a
    compaction failure absorbed, compaction off the serving thread,
    ``pull_window`` / ``apply_plan`` (a plan that breaks the tier-0
    invariant is refused before anything changes);
  * a threaded stress: pinned units never evicted, the budget holds at rest;
  * end to end on reduced Mixtral (fp32, the reference's strict artifact):
    tokens with the daemon on equal tokens with it off and the reference's,
    through ``generate`` and through the scheduler."""

import json
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.core import DeploymentProfile as RefProfile
from repro.core import RetierDaemon as RefDaemon
from repro.core import TieredParams as RefTiered
from repro.core import analyze as ref_analyze
from repro.core import build_artifact as ref_build_artifact
from repro.core.entrypoints import SERVING_PROFILE as REF_SERVING_PROFILE
from repro.core.optional_store import OptionalStore as RefStore
from repro.core.optional_store import write_store as ref_write_store
from repro.core.param_graph import ReachabilityReport as RefReach
from repro.core.partition import TierDecision as RefDecision
from repro.core.partition import TierPlan as RefPlan
from repro.core.partition import Unit as RefUnit
from repro.models.zoo import build_model as ref_build_model
from repro.serving import ContinuousBatchingScheduler as RefScheduler
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro_torch.configs import get_reduced
from repro_torch.core import DeploymentProfile, Prefetcher, RetierDaemon, TieredParams, analyze
from repro_torch.core import retier_daemon as rd_mod
from repro_torch.core.optional_store import OptionalStore
from repro_torch.core.param_graph import ReachabilityReport
from repro_torch.core.partition import TierDecision, TierPlan, Unit
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine, cold_start

ROWS, COLS, N_UNITS = 16, 32, 8
UNIT_BYTES = ROWS * COLS * 4
KEYS = [f"emb#rg{g}" for g in range(N_UNITS)]
W_SHAPE = (4, 8)  # a tier-0 leaf every entry reaches: the invariant's required set
# the daemon's timing fields differ run to run; every other stat is held exactly
TIMING = ("max_tick_s", "compact_wall_s")
JOIN_S = 60.0


@pytest.fixture
def twin(tmp_path):
    """Makes a (reference, port) pair of one-leaf tiered trees of N_UNITS
    row-group units over the same store (the reference wrote it) plus a
    tier-0 leaf ``w``, with each package's reach report; closes the stores."""
    opened = []

    def make(budget=None, name="mini", resident=(), seed=0):
        rng = np.random.default_rng(seed)
        data = rng.standard_normal((N_UNITS * ROWS, COLS)).astype(np.float32)
        path = str(tmp_path / f"{name}.blob")
        ref_write_store(path, [(k, data[g * ROWS:(g + 1) * ROWS]) for g, k in enumerate(KEYS)])
        w_bytes = int(np.prod(W_SHAPE)) * 4
        trees = []
        for pkg in ("ref", "port"):
            U, D, P = (RefUnit, RefDecision, RefPlan) if pkg == "ref" else (Unit, TierDecision, TierPlan)
            units = tuple(U(k, "emb", rows=(g * ROWS, (g + 1) * ROWS), nbytes=UNIT_BYTES) for g, k in enumerate(KEYS))
            plan = P({"emb": D("emb", 1, "rows", "test", data.nbytes, units=units, resident_units=tuple(resident)),
                      "w": D("w", 0, "leaf", "test", w_bytes)},
                     REF_SERVING_PROFILE if pkg == "ref" else DeploymentProfile(name="serving"), [])
            reach = (RefReach if pkg == "ref" else ReachabilityReport)(
                entry_names=["prefill", "decode_step"], reachable={"emb": {"prefill"}, "w": {"prefill"}})
            if pkg == "ref":
                store = RefStore(path)
                tp = RefTiered({"emb": jnp.zeros(data.shape, jnp.float32), "w": jnp.ones(W_SHAPE, jnp.float32)},
                               plan, store, device_budget_bytes=budget)
            else:
                store = OptionalStore(path)
                tp = TieredParams({"emb": torch.zeros(data.shape), "w": torch.ones(W_SHAPE)}, plan, store,
                                  device_budget_bytes=budget)
            opened.append(store)
            trees.append((tp, reach))
        return trees[0], trees[1], data

    yield make
    for st in opened:
        st.close()


def _rows(tp, g):
    return np.asarray(tp.leaf("emb"))[g * ROWS:(g + 1) * ROWS]


def _stats(daemon) -> dict:
    return {k: v for k, v in daemon.stats.to_dict().items() if k not in TIMING}


def _report(rep):
    if rep is None:
        return None
    return {k: getattr(rep, k) for k in ("promoted_resident", "demoted_resident", "promoted_leaves",
                                         "demoted_leaves", "promoted_bytes", "demoted_bytes", "budget_skipped")}


def _loads(tp) -> list:
    return [(e.key, e.nbytes, e.source) for e in tp.stats.events]


def _join(threads, timeout=JOIN_S):
    for t in threads:
        t.join(timeout)
    alive = [t.name for t in threads if t.is_alive()]
    assert not alive, f"threads still running after {timeout} s (a deadlock?): {alive}"


# ---------------------------------------------------------------------------
# trace hooks
# ---------------------------------------------------------------------------

def test_rotate_trace_and_snapshot_match_reference(twin):
    (ref, _), (port, _), _ = twin()
    assert ref.rotate_trace() is None and port.rotate_trace() is None  # tracing never started
    assert ref.trace_snapshot() is None and port.trace_snapshot() is None
    for tp in (ref, port):
        tp.start_trace()
        tp.trace.max_assoc_batch = 3
        tp.ensure(KEYS[:2])
        tp.ensure(KEYS[1:5])  # over max_assoc_batch: no pairs, chain reset
        tp.ensure([KEYS[6]])
    snaps = [tp.trace_snapshot() for tp in (ref, port)]
    assert snaps[0].to_dict() == snaps[1].to_dict()
    assert snaps[1] is not port.trace  # a copy: recording goes on into the live one
    port.ensure([KEYS[7]])
    assert snaps[1].to_dict() != port.trace.to_dict()
    ref.ensure([KEYS[7]])
    windows = [tp.rotate_trace() for tp in (ref, port)]
    assert windows[0].to_dict() == windows[1].to_dict()
    for tp in (ref, port):
        assert tp.trace.batches == 0 and tp.trace.max_assoc_batch == 3  # the fresh window keeps the cap
    fresh = type(port.trace)()
    assert port.rotate_trace(fresh) is not fresh and port.trace is fresh


# ---------------------------------------------------------------------------
# tick-for-tick parity under strict (no prefetcher)
# ---------------------------------------------------------------------------

# each window: the ensure batches served before the next tick, (indices, pinned)
WINDOWS = [
    [([0], False), ([4, 5], True)],
    [([4], False), ([6], False)],
    [([6, 7], True), ([2], False), ([3], False)],
    [],
    [([3], False), ([4], False), ([5, 6], False)],
    [([6], False), ([6], False)],
    [([1], False)],
]


@pytest.mark.parametrize("budget_units,decay", [(None, 0.5), (4, 0.5), (3, 0.5), (4, 1.0), (3, 0.0)])
def test_daemon_ticks_match_reference_under_strict(twin, budget_units, decay):
    budget = budget_units * UNIT_BYTES if budget_units else None
    (ref, ref_reach), (port, reach), _ = twin(budget=budget, resident=(KEYS[0], KEYS[1]))
    daemons = []
    for tp, rr, D in ((ref, ref_reach, RefDaemon), (port, reach, RetierDaemon)):
        tp.ensure(KEYS[:2], source="preload")  # the cold start's hot set
        daemons.append(D(tp, rr, interval_steps=1, decay=decay))
    for window in WINDOWS:
        for tp in (ref, port):
            for idxs, pin in window:
                ks = [KEYS[g] for g in idxs]
                tp.ensure(ks, pin=pin)
                if pin:
                    tp.release(ks)
        reps = [d.maybe_tick() for d in daemons]
        assert _report(reps[0]) == _report(reps[1])
        assert ({p: d.resident_units for p, d in ref.plan.decisions.items()}
                == {p: d.resident_units for p, d in port.plan.decisions.items()})
        assert ref.resident_keys == port.resident_keys
        assert _loads(ref) == _loads(port)
        assert _stats(daemons[0]) == _stats(daemons[1])
        assert daemons[0].trace_snapshot().to_dict() == daemons[1].trace_snapshot().to_dict()
    s = daemons[1].stats
    assert s.applies >= 5 and s.invariant_checks == s.applies and s.errors == 0
    if budget:
        assert port.resident_bytes <= budget


def test_sync_preload_trims_hottest_first_to_the_headroom(twin):
    """Without a prefetcher, promotions are preloaded hottest first (trace
    touches + faults, not the replan's fault order) into what the budget
    leaves free; the rest stay demand-faultable, as in the reference."""
    (ref, ref_reach), (port, reach), _ = twin(budget=4 * UNIT_BYTES)
    daemons = []
    for tp, rr, D in ((ref, ref_reach, RefDaemon), (port, reach, RetierDaemon)):
        daemons.append(D(tp, rr, interval_steps=1))
        tp.ensure([KEYS[5]])
        tp.evict([KEYS[5]])
        tp.ensure([KEYS[5]])     # rg5: 2 faults, 2 touches (heat 4)
        for _ in range(5):
            tp.ensure([KEYS[6]])  # rg6: 1 fault, 5 touches (heat 6)
        tp.evict([KEYS[5], KEYS[6]])
        tp.ensure(KEYS[:3])       # 3 of 4 units resident: room for one more
    reps = [d.tick() for d in daemons]
    assert _report(reps[0]) == _report(reps[1])
    assert reps[1].promoted_resident[0] == KEYS[5]  # the replan ranks by faults...
    for tp in (ref, port):
        assert tp.is_resident(KEYS[6]) and not tp.is_resident(KEYS[5])  # ...the preload by heat
    assert _loads(ref) == _loads(port) and _stats(daemons[0]) == _stats(daemons[1])
    assert daemons[1].stats.preload_bytes == UNIT_BYTES


# ---------------------------------------------------------------------------
# the reference's contract
# ---------------------------------------------------------------------------

def test_daemon_applies_promotions_and_demotions_live(twin):
    _, (tp, reach), data = twin(resident=(KEYS[0], KEYS[1]))
    tp.ensure(KEYS[:2], source="preload")
    daemon = RetierDaemon(tp, reach, interval_steps=1)
    assert tp.trace is not None  # the daemon attached its live trace
    tp.ensure([KEYS[0]])           # touch one preload, never the other
    tp.ensure([KEYS[4], KEYS[5]])  # two demand faults
    assert daemon.maybe_tick() is not None
    res = tp.plan.decisions["emb"].resident_units  # the plan swapped in place
    assert KEYS[4] in res and KEYS[5] in res and KEYS[0] in res and KEYS[1] not in res
    assert not tp.is_resident(KEYS[1])  # demoted: evicted back to zeros
    np.testing.assert_array_equal(_rows(tp, 1), np.zeros((ROWS, COLS), np.float32))
    for g in (4, 5):
        assert tp.is_resident(KEYS[g])
        np.testing.assert_array_equal(_rows(tp, g), data[g * ROWS:(g + 1) * ROWS])
    s = daemon.stats
    assert s.ticks == s.applies == s.invariant_checks == 1
    assert (s.promoted_units, s.demoted_units, s.evicted_units, s.evicted_bytes) == (2, 1, 1, UNIT_BYTES)


def test_daemon_preloads_through_prefetcher_and_refreshes_predictor(twin):
    _, (tp, reach), data = twin()
    pf = Prefetcher(tp, batch_units=4)
    daemon = RetierDaemon(tp, reach, prefetcher=pf, interval_steps=1)
    try:
        tp.ensure([KEYS[2]])
        tp.ensure([KEYS[3]])
        tp.evict([KEYS[2], KEYS[3]])
        rep = daemon.tick()
        assert rep is not None and set(rep.promoted_resident) == {KEYS[2], KEYS[3]}
        assert pf.drain(10.0)  # promotions rode the prefetch queue
        for g in (2, 3):
            assert tp.is_resident(KEYS[g])
            np.testing.assert_array_equal(_rows(tp, g), data[g * ROWS:(g + 1) * ROWS])
        assert len([e for e in tp.stats.events if e.key in KEYS[2:4] and e.source == "prefetch"]) == 2
        assert daemon.stats.predictor_refreshes == 1 and daemon.stats.preload_bytes == 0
        assert KEYS[3] in pf.predictor.successors(KEYS[2])
    finally:
        pf.stop()


def test_daemon_decay_forgets_shifted_away_phase(twin):
    """A unit hot in an old window decays out of the merged trace and is
    demoted and evicted, as in the reference."""
    (ref, ref_reach), (tp, reach), _ = twin()
    d_ref, daemon = RefDaemon(ref, ref_reach, interval_steps=1, decay=0.5), RetierDaemon(tp, reach, interval_steps=1,
                                                                                           decay=0.5)
    for t in (ref, tp):
        t.ensure([KEYS[2]])  # phase A
    assert daemon.tick() is not None and d_ref.tick() is not None
    assert KEYS[2] in tp.plan.decisions["emb"].resident_units
    for _ in range(3):  # phase B: rg2 never touched again
        for t in (ref, tp):
            t.ensure([KEYS[6]])
        daemon.tick()
        d_ref.tick()
    assert KEYS[2] not in tp.plan.decisions["emb"].resident_units and not tp.is_resident(KEYS[2])
    assert KEYS[6] in tp.plan.decisions["emb"].resident_units
    assert daemon.stats.demoted_units >= 1
    assert _stats(daemon) == _stats(d_ref)
    assert daemon.merged_trace.to_dict() == d_ref.merged_trace.to_dict()


def test_daemon_cadence_step_and_wallclock_triggers(twin, monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(rd_mod, "time", types.SimpleNamespace(monotonic=lambda: now[0]))
    _, (tp, reach), _ = twin()
    daemon = RetierDaemon(tp, reach, interval_steps=3)
    tp.ensure([KEYS[0]])
    assert daemon.maybe_tick() is None      # 1
    assert daemon.maybe_tick() is None      # 2
    assert daemon.maybe_tick() is not None  # 3: due
    assert daemon.stats.ticks == 1
    assert daemon.maybe_tick(steps=3) is None  # an empty window is skipped, counted
    assert (daemon.stats.skipped_empty, daemon.stats.applies) == (1, 1)

    wall = RetierDaemon(tp, reach, interval_steps=10**9, interval_s=0.05)
    tp.ensure([KEYS[1]])
    now[0] += 0.04
    assert wall.maybe_tick(steps=0) is None
    now[0] += 0.02  # past interval_s with zero new steps
    assert wall.maybe_tick(steps=0) is not None
    assert wall.stats.ticks == 1 and wall.maybe_tick(steps=0) is None  # the clock restarted at the tick

    with pytest.raises(ValueError, match="interval_steps"):
        RetierDaemon(tp, reach, interval_steps=0)
    with pytest.raises(ValueError, match="artifact_dir"):
        RetierDaemon(tp, reach, compact_every=2)
    with pytest.raises(ValueError, match="decay"):
        RetierDaemon(tp, reach, decay=1.5)


def test_daemon_compact_failure_absorbed_serving_survives(twin, tmp_path):
    _, (tp, reach), _ = twin()
    daemon = RetierDaemon(tp, reach, interval_steps=1, compact_every=1, artifact_dir=str(tmp_path / "no-such"))
    tp.ensure([KEYS[0]])
    assert daemon.maybe_tick() is not None  # the failure is the worker's, not the tick's
    assert daemon.join_compaction(timeout=10.0)
    assert daemon.stats.compact_errors == 1 and daemon.last_compact_error
    assert (daemon.stats.errors, daemon.stats.compactions) == (0, 0)
    assert KEYS[0] in tp.plan.decisions["emb"].resident_units
    tp.ensure([KEYS[1]])
    daemon.compact_every = 0
    assert daemon.maybe_tick() is not None
    assert daemon.stats.compact_errors == 1


def test_tick_error_absorbed_and_counted(twin):
    """A tick that raises (a store read failing in the synchronous preload)
    never reaches the serving loop: it lands in ``errors`` / ``last_error``."""
    _, (tp, reach), _ = twin(budget=8 * UNIT_BYTES)
    daemon = RetierDaemon(tp, reach, interval_steps=1)
    tp.ensure([KEYS[3]])
    tp.evict([KEYS[3]])  # faulted, now cold: the tick will preload it

    def broken(*a, **k):
        raise OSError("store gone")

    tp.store.read_raw_many = broken
    assert daemon.maybe_tick() is None
    assert daemon.stats.errors == 1 and "store gone" in daemon.last_error
    assert not tp.is_resident(KEYS[3]) and tp.residency.state_of(KEYS[3]) == "cold"  # claim rolled back


def test_compaction_runs_off_thread_and_never_blocks_a_tick(twin, tmp_path, monkeypatch):
    gate, started, calls = threading.Event(), threading.Event(), []

    def slow_retier(artifact_dir, plan, *, out_dir=None, report=None, trace=None):
        started.set()
        assert gate.wait(10.0)
        calls.append(out_dir)
        return {"fake": True}

    monkeypatch.setattr(rd_mod, "retier_artifact", slow_retier)
    _, (tp, reach), _ = twin()
    daemon = RetierDaemon(tp, reach, interval_steps=1, compact_every=1, artifact_dir=str(tmp_path / "art"))
    tp.ensure([KEYS[0]])
    t0 = time.monotonic()
    assert daemon.maybe_tick() is not None  # returned...
    tick_wall = time.monotonic() - t0
    assert started.wait(10.0)               # ...while the rewrite still runs
    assert not gate.is_set() and daemon.stats.compactions == 0
    tp.ensure([KEYS[1]])
    assert daemon.maybe_tick() is not None  # a cadence hit while one is in flight: dropped, counted
    assert daemon.stats.compact_skipped_inflight == 1
    gate.set()
    assert daemon.join_compaction(timeout=10.0)
    assert daemon.stats.compactions == 1 and calls == [str(tmp_path / "art") + "-compact"]
    assert daemon.stats.compact_errors == 0 and daemon.last_compaction == {"fake": True}
    assert daemon.stats.max_tick_s < 5.0 and tick_wall < 5.0 and daemon.stats.compact_wall_s > 0.0


def test_pull_window_and_apply_plan_match_reference(twin):
    """The fleet's hooks: ``pull_window`` hands over everything observed since
    the last pull, ticks' windows included; ``apply_plan`` applies a remote
    plan (synchronously with ``sync_preload``) as the reference does, and
    refuses one that takes a reachable leaf out of tier-0 before any change."""
    (ref, ref_reach), (tp, reach), data = twin(budget=6 * UNIT_BYTES)
    daemons = (RefDaemon(ref, ref_reach, interval_steps=1), RetierDaemon(tp, reach, interval_steps=1))
    for t, d in zip((ref, tp), daemons):
        t.ensure([KEYS[2]])
        d.tick()                    # a tick's window stays owed to the fleet
        t.ensure([KEYS[3], KEYS[4]])
    pulled = [d.pull_window() for d in daemons]
    assert pulled[0].to_dict() == pulled[1].to_dict()
    assert pulled[1].faults == {KEYS[2]: 1, KEYS[3]: 1, KEYS[4]: 1}
    assert all(d.pull_window() is None for d in daemons)  # nothing new

    plans = []
    for t in (ref, tp):
        dec = t.plan.decisions["emb"]
        plans.append(dict(t.plan.decisions, emb=type(dec)(**{**dec.__dict__, "resident_units": (KEYS[6], KEYS[7])})))
    outs = [d.apply_plan(type(t.plan)(p, t.plan.profile, []), sync_preload=True)
            for d, t, p in zip(daemons, (ref, tp), plans)]
    assert outs[0] == outs[1] and outs[1]["promoted"] == 2
    assert ref.resident_keys == tp.resident_keys and {KEYS[6], KEYS[7]} <= tp.resident_keys
    np.testing.assert_array_equal(_rows(tp, 7), data[7 * ROWS:8 * ROWS])
    assert _stats(daemons[0]) == _stats(daemons[1])

    before = (tp.plan, set(tp.resident_keys), _stats(daemons[1]), _loads(tp))
    w = tp.plan.decisions["w"]
    bad = dict(tp.plan.decisions, w=TierDecision("w", 1, "leaf", "adversarial", w.nbytes, units=(Unit("w", "w"),)),
               emb=type(tp.plan.decisions["emb"])(**{**tp.plan.decisions["emb"].__dict__,
                                                     "resident_units": (KEYS[0],)}))
    with pytest.raises(ValueError, match="entry-reachable leaves left tier-0"):
        daemons[1].apply_plan(TierPlan(bad, tp.plan.profile, []), sync_preload=True)
    assert (tp.plan, set(tp.resident_keys), _stats(daemons[1]), _loads(tp)) == before


# ---------------------------------------------------------------------------
# threaded stress: the daemon against pinned request traffic
# ---------------------------------------------------------------------------

def test_daemon_stress_never_evicts_pinned_budget_holds(twin):
    budget = 4 * UNIT_BYTES
    _, (tp, reach), data = twin(budget=budget)
    daemon = RetierDaemon(tp, reach, interval_steps=1, decay=0.5)
    errors: list = []
    stop = threading.Event()

    def requester(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(30):
                step = [str(k) for k in rng.choice(KEYS, size=2, replace=False)]
                tp.ensure(step, pin=True)
                try:
                    for k in step:
                        assert tp.is_resident(k), f"pinned {k} not resident"
                        g = KEYS.index(k)
                        np.testing.assert_array_equal(_rows(tp, g), data[g * ROWS:(g + 1) * ROWS])
                finally:
                    tp.release(step)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    def daemon_loop():
        while not stop.is_set():
            daemon.tick()
            time.sleep(0.002)

    threads = [threading.Thread(target=requester, args=(i,), name=f"req{i}") for i in range(4)]
    dt = threading.Thread(target=daemon_loop, name="daemon")
    dt.start()
    for t in threads:
        t.start()
    try:
        _join(threads)
    finally:
        stop.set()
        _join([dt])
    assert not errors, errors
    s = daemon.stats
    assert s.applies > 0 and s.invariant_checks == s.applies and s.errors == 0
    res = tp.residency
    assert res.resident_bytes <= budget
    assert res.resident_bytes == len(res.resident_keys) * UNIT_BYTES == res.charged_bytes()
    for g, k in enumerate(KEYS):
        want = data[g * ROWS:(g + 1) * ROWS] if k in res.resident_keys else np.zeros((ROWS, COLS), np.float32)
        np.testing.assert_array_equal(_rows(tp, g), want)


def test_emit_hints_attributes_final_step_then_drops_chain(twin):
    """A request's last step is recorded before its chain state is dropped."""
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler as Sched

    _, (tp, _), _ = twin()
    tp.start_trace()
    req = types.SimpleNamespace(rid=7)
    fake = types.SimpleNamespace(server=types.SimpleNamespace(tiered=tp),
                                 engine=types.SimpleNamespace(prefetcher=None), _slots=[req])
    Sched._emit_hints(fake, [], by_request={7: [KEYS[0]]})
    fake._slots = [None]  # the request retired during this step
    Sched._emit_hints(fake, [], by_request={7: [KEYS[1]]})
    assert tp.trace.request_transitions[KEYS[0]] == {KEYS[1]: 1}
    assert tp.trace._last_by_request == {}


# ---------------------------------------------------------------------------
# end to end: reduced Mixtral from the reference's strict artifact
# ---------------------------------------------------------------------------

ARCH = "mixtral-8x22b"
PROMPT_LEN = 6
MAX_SEQ = 16


def _strict(cfg):
    return dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                vocab_row_group=max(64, cfg.vocab_size // 16))


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    ref_cfg = ref_get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)
    ref_model = ref_build_model(ref_cfg)
    ref_result = ref_analyze(ref_model, RefProfile(**_strict(ref_cfg)), trace_B=1, trace_S=32)
    outdir = str(tmp_path_factory.mktemp("retierd"))
    ref_build_artifact(ref_model.init(jax.random.PRNGKey(0)), ref_result, outdir)
    cfg = get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)
    model = build_model(cfg)
    result = analyze(model, DeploymentProfile(**_strict(cfg)), trace_B=1, trace_S=32)
    return ref_model, ref_result, model, result, outdir


def _prompts(n):
    return [np.random.default_rng(70 + i).integers(0, 512, PROMPT_LEN).astype(np.int32) for i in range(n)]


def test_generate_tokens_daemon_on_equal_off_and_reference(app):
    """Strict, the daemon ticking after the prefill and every decode step:
    tokens equal the daemon-off run and the reference's; the daemon's stats,
    the loads and the resident set equal the reference's."""
    ref_model, ref_result, model, result, outdir = app
    tokens = np.stack(_prompts(2))
    kw = dict(residency="strict", retier_online=True, retier_interval=1)
    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", compile_warm_set=False, **kw)
    ref_out, _ = RefEngine(ref_server, max_seq=MAX_SEQ).generate(jnp.asarray(tokens), 6)
    ref_server.close()
    with cold_start(model, outdir, result, residency="strict", compile_warm_set=False, device="cpu") as off:
        out_off, _ = GenerationEngine(off, max_seq=MAX_SEQ).generate(torch.from_numpy(tokens).long(), 6)
    with cold_start(model, outdir, result, compile_warm_set=False, device="cpu", **kw) as on:
        out_on, _ = GenerationEngine(on, max_seq=MAX_SEQ).generate(torch.from_numpy(tokens).long(), 6)
        daemon = on.retier_daemon
        np.testing.assert_array_equal(out_on, out_off)
        np.testing.assert_array_equal(out_on, np.asarray(ref_out))
        assert daemon.stats.ticks == 6 and daemon.stats.applies >= 1 and daemon.stats.errors == 0
        assert _stats(daemon) == _stats(ref_server.retier_daemon)
        assert _loads(on.tiered) == _loads(ref_server.tiered)
        assert on.tiered.resident_keys == ref_server.tiered.resident_keys
        assert on.tiered.resident_bytes <= on.tiered.residency.budget_bytes


@pytest.mark.parametrize("how", ["strict", "prefetch"])
def test_scheduler_tokens_daemon_on_equal_off_and_reference(app, how):
    """Five requests through three slots. Strict: tokens, daemon stats and
    loads equal the reference scheduler's. With the prefetcher under half of
    tier-1 and compaction after every apply: tokens equal the daemon-off run
    and the reference's, and the compacted artifact is published."""
    ref_model, ref_result, model, result, outdir = app
    prompts, steps = _prompts(5), [4, 3, 5, 4, 3]
    if how == "strict":
        kw = dict(residency="strict", retier_online=True, retier_interval=2)
    else:
        kw = dict(device_budget_bytes=result.plan.tier1_bytes // 2, prefetch=True, retier_online=True,
                  retier_interval=2, retier_compact_every=1)

    def drive(sched):
        reqs = [sched.submit(p, n) for p, n in zip(prompts, steps)]
        sched.run()
        assert all(r.done and r.error is None for r in reqs)
        return [r.output for r in reqs]

    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", compile_warm_set=False,
                                warm_shapes=((1, PROMPT_LEN),), **kw)
    ref_outs = drive(RefScheduler(RefEngine(ref_server, max_seq=MAX_SEQ), max_batch=3))
    ref_server.close()
    off_kw = {k: v for k, v in kw.items() if not k.startswith("retier")}
    with cold_start(model, outdir, result, compile_warm_set=False, device="cpu", **off_kw) as off:
        outs_off = drive(ContinuousBatchingScheduler(GenerationEngine(off, max_seq=MAX_SEQ), max_batch=3))
    with cold_start(model, outdir, result, compile_warm_set=False, device="cpu", **kw) as on:
        outs_on = drive(ContinuousBatchingScheduler(GenerationEngine(on, max_seq=MAX_SEQ), max_batch=3))
        daemon = on.retier_daemon
        assert daemon.join_compaction(60.0)
    for got, off_, ref in zip(outs_on, outs_off, ref_outs):
        np.testing.assert_array_equal(got, off_)
        np.testing.assert_array_equal(got, np.asarray(ref))
    s = daemon.stats
    assert s.applies > 0 and s.invariant_checks == s.applies and s.errors == 0
    assert daemon.merged_trace is not None and daemon.merged_trace.request_transitions  # per-request tags fed it
    if how == "strict":
        assert _stats(daemon) == _stats(ref_server.retier_daemon)
        assert _loads(on.tiered) == _loads(ref_server.tiered)
        return
    assert s.compact_errors == 0 and s.compactions >= 1
    compact = outdir.rstrip("/") + "-compact"
    assert os.path.isdir(compact) and not os.path.exists(compact + ".partial")
    with open(os.path.join(compact, "artifact.json")) as f:
        art = json.load(f)
    assert {p: d["tier"] for p, d in art["decisions"].items()} == {
        p: d.tier for p, d in daemon.tiered.plan.decisions.items()}
    assert any(d["resident_units"] for d in art["decisions"].values())

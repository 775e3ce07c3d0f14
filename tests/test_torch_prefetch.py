"""The port's prefetcher and the prefetch half of its residency state machine
(``repro_torch.core.prefetch``, ``core.on_demand``) against the reference's
contract (tests/test_prefetch.py), each on an optional store that the
reference wrote: a prefetched unit lands byte-identical to a faulted one and
its first demand touch is a prefetch hit; resident and duplicate hints are
dropped; a demand ensure waits out an in-flight prefetch and takes the load
over after an abort; the budget holds under a threaded ensure/evict/hint
stress; ``stop()`` leaves no thread. ``merge_hints`` and
``TransitionPredictor`` agree with the reference's on the same trace tables,
and so do the engine's top-k row hints on the same logits.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.on_demand import AccessTrace as RefAccessTrace
from repro.core.optional_store import write_store as ref_write_store
from repro.core.prefetch import TransitionPredictor as RefPredictor
from repro.core.prefetch import merge_hints as ref_merge_hints
from repro_torch.core import DeploymentProfile
from repro_torch.core.on_demand import COLD, AccessTrace, TieredParams
from repro_torch.core.optional_store import OptionalStore
from repro_torch.core.partition import TierDecision, TierPlan, Unit
from repro_torch.core.prefetch import Prefetcher, TransitionPredictor, merge_hints

ROWS, COLS, N_UNITS = 16, 32, 8
UNIT_BYTES = ROWS * COLS * 4


@pytest.fixture
def mini(tmp_path):
    """Makes one-leaf tiered trees of N_UNITS row-group units, each over a
    store the reference wrote; closes the stores at teardown."""
    stores = []

    def make(budget=None, name="mini"):
        data = np.random.default_rng(0).standard_normal((N_UNITS * ROWS, COLS)).astype(np.float32)
        units = tuple(Unit(f"emb#rg{g}", "emb", rows=(g * ROWS, (g + 1) * ROWS), nbytes=UNIT_BYTES)
                      for g in range(N_UNITS))
        plan = TierPlan({"emb": TierDecision("emb", 1, "rows", "test", data.nbytes, units=units)},
                        DeploymentProfile(), [])
        path = str(tmp_path / f"{name}.blob")
        ref_write_store(path, [(u.key, data[u.rows[0]:u.rows[1]]) for u in units])
        stores.append(OptionalStore(path))
        tp = TieredParams({"emb": torch.zeros(data.shape)}, plan, stores[-1], device_budget_bytes=budget)
        return tp, data, units

    yield make
    for st in stores:
        st.close()


def _rows(tp, unit):
    return tp.leaf("emb")[unit.rows[0]:unit.rows[1]].numpy()


def _prefetch_threads():
    return {t for t in threading.enumerate() if t.name.startswith("prefetch-")}


def test_prefetch_hit_matches_fault_in(mini):
    tp_fault, data, units = mini(name="fault")
    tp_pf, _, _ = mini(name="pf")
    key = units[2].key
    assert tp_fault.ensure([key]) == UNIT_BYTES
    pf = Prefetcher(tp_pf, batch_units=2)
    try:
        assert pf.hint([key]) == 1
        assert pf.drain(10.0)
        assert tp_pf.ensure([key]) == 0  # demand touch: a prefetch hit
    finally:
        pf.stop()
    assert (tp_pf.stats.prefetch_hits, tp_pf.stats.misses) == (1, 0)
    assert tp_pf.stats.prefetch_hit_rate == 1.0
    (ev_fault,), (ev_pf,) = tp_fault.stats.events, tp_pf.stats.events
    assert ev_fault.nbytes == ev_pf.nbytes == UNIT_BYTES
    assert (ev_pf.source, ev_fault.source) == ("prefetch", "fault")
    assert pf.stats.loaded_units == 1 and pf.stats.loaded_bytes == UNIT_BYTES
    assert pf.stats.preads_issued == pf.stats.frames_fetched == 1
    np.testing.assert_array_equal(_rows(tp_pf, units[2]), data[32:48])
    np.testing.assert_array_equal(_rows(tp_fault, units[2]), _rows(tp_pf, units[2]))


def test_hint_drops_resident_and_duplicate_keys(mini):
    tp, _, units = mini()
    tp.ensure([units[0].key])
    pf = Prefetcher(tp, batch_units=4)
    try:
        assert pf.hint([units[0].key, units[1].key, units[1].key]) == 1
        assert pf.drain(10.0)
    finally:
        pf.stop()
    assert tp.is_resident(units[1].key)
    assert pf.stats.skipped_resident == 2 and pf.stats.enqueued == 1


def test_ensure_waits_for_inflight_prefetch(mini):
    tp, data, units = mini()
    key = units[4].key
    assert tp.claim_for_prefetch(key)

    def finish():
        time.sleep(0.15)
        tp.install_prefetched(key, tp.store.fetch(key))

    t = threading.Thread(target=finish)
    t.start()
    moved = tp.ensure([key])  # blocks on the in-flight load instead of reading it again
    t.join(10.0)
    assert not t.is_alive()
    assert moved == 0
    assert (tp.stats.prefetch_waits, tp.stats.misses) == (1, 0)
    np.testing.assert_array_equal(_rows(tp, units[4]), data[4 * ROWS:5 * ROWS])


def test_ensure_takes_over_aborted_prefetch(mini):
    tp, data, units = mini()
    key = units[5].key
    assert tp.claim_for_prefetch(key)

    def bail():
        time.sleep(0.1)
        tp.abort_prefetch(key)

    t = threading.Thread(target=bail)
    t.start()
    moved = tp.ensure([key])  # the waiter loads it itself after the abort
    t.join(10.0)
    assert not t.is_alive()
    assert moved == UNIT_BYTES and tp.is_resident(key)
    assert tp.stats.misses == 1 and tp.stats.prefetch_waits == 0
    np.testing.assert_array_equal(_rows(tp, units[5]), data[5 * ROWS:6 * ROWS])


def test_threaded_ensure_evict_stress(mini):
    """More threads than cores hammer ensure, evict and hint with a short
    switch interval; no pins are taken, so the budget is never exceeded, the
    charged bytes stay exact and every slice holds its bytes or zeros."""
    budget = 4 * UNIT_BYTES
    tp, data, units = mini(budget=budget)
    keys = [u.key for u in units]
    errors = []
    stop = threading.Event()

    def hammer(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(40):
                tp.ensure(list(rng.choice(keys, size=rng.integers(1, 4), replace=False)))
        except Exception as e:  # reported below
            errors.append(e)

    def evictor():
        rng = np.random.default_rng(99)
        try:
            while not stop.is_set():
                tp.evict([rng.choice(keys)])
                time.sleep(0.001)
        except Exception as e:  # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    pf = Prefetcher(tp, batch_units=3)
    try:
        hammers = [threading.Thread(target=hammer, args=(i,)) for i in range(12)]
        ev = threading.Thread(target=evictor)
        ev.start()
        for t in hammers:
            t.start()
        for i in range(20):
            pf.hint([keys[i % len(keys)]])
        for t in hammers:
            t.join(60.0)
        stop.set()
        ev.join(60.0)
        assert not any(t.is_alive() for t in hammers + [ev])
        assert pf.drain(10.0)
    finally:
        stop.set()
        pf.stop()
        sys.setswitchinterval(switch)
    assert not errors, errors
    res = tp.residency
    assert res.max_resident_bytes <= budget and res.overshoot_events == 0
    resident = res.resident_keys
    assert res.resident_bytes == len(resident) * UNIT_BYTES
    assert not any(res.state_of(k) not in (COLD, "resident") for k in keys)
    for u in units:
        want = data[u.rows[0]:u.rows[1]] if u.key in resident else np.zeros((ROWS, COLS), np.float32)
        np.testing.assert_array_equal(_rows(tp, u), want)


def test_stop_leaves_no_thread_and_aborts_claims(mini):
    tp, _, units = mini()
    before = _prefetch_threads()
    pf = Prefetcher(tp, batch_units=1)
    mine = _prefetch_threads() - before
    assert {t.name for t in mine} == {"prefetch-read", "prefetch-upload"}
    pf.hint([u.key for u in units])
    pf.stop()
    assert not mine & set(threading.enumerate())
    assert pf.hint([units[0].key]) == 0  # a stopped prefetcher takes no hints
    # every claim the reader made is installed or rolled back, never stuck
    assert all(tp.residency.state_of(u.key) in (COLD, "resident") for u in units)
    assert tp.ensure([u.key for u in units]) >= 0
    assert all(tp.is_resident(u.key) for u in units)


# ---------------------------------------------------------------------------
# hint merging and the transition predictor, against the reference's
# ---------------------------------------------------------------------------

BATCHES = [  # (keys, phase) demand batches of a profiling run
    (["a", "b"], "prefill"), (["c"], "decode"), (["a", "d"], "decode"), (["b", "c", "e"], "decode"),
    (["a", "b"], "prefill"), (["c", "d"], "decode"), (["e"], "decode"), (["a", "c"], "decode"),
    (["b"], "decode"), (["c", "e"], "decode"), (["a", "b", "d"], "decode"),
]


def test_merge_hints_matches_reference():
    lists = [["x", "y", "z"], ["y", "q"], [], ["r", "x", "s", "t"]]
    assert merge_hints(*lists) == ref_merge_hints(*lists)
    assert merge_hints() == ref_merge_hints() == []


@pytest.mark.parametrize("prefer_request", [False, True])
def test_transition_predictor_matches_reference(prefer_request):
    """On the reference's trace (every table, second-order and per-phase
    included) both predictors rank alike, and so does the port's predictor
    built from the port's own trace of the same batches."""
    ref_trace, trace = RefAccessTrace(), AccessTrace()
    for keys, phase in BATCHES:
        ref_trace.record(keys, keys[:1], phase)
        trace.record(keys, keys[:1], phase)
    queries = [(["a"], "", ()), (["c"], "decode", ["a", "b"]), (["a", "b"], "prefill", ["e"]),
               (["e", "d"], "decode", ["c"]), (["zz"], "decode", ())]
    for kw in (dict(), dict(top_k=2, cluster_size=1, cluster_min_count=1)):
        ref = RefPredictor.from_trace(ref_trace, prefer_request=prefer_request, **kw)
        port = TransitionPredictor.from_trace(ref_trace, prefer_request=prefer_request, **kw)
        assert port.to_dict() == ref.to_dict()
        assert TransitionPredictor.from_dict(port.to_dict()).to_dict() == ref.to_dict()
        for keys, phase, prev in queries:
            assert port.follow(keys, phase=phase, prev=prev) == ref.follow(keys, phase=phase, prev=prev)
        # the port's own trace holds every table the reference's does
        assert trace.to_dict() == ref_trace.to_dict()
        assert trace.transitions2 and trace.phase_transitions
        mine = TransitionPredictor.from_trace(trace, prefer_request=prefer_request, **kw)
        assert mine.to_dict() == ref.to_dict()
        for keys, phase, prev in queries:
            assert mine.follow(keys, phase=phase, prev=prev) == ref.follow(keys, phase=phase, prev=prev)


def test_topk_row_hints_match_reference(tmp_path):
    from repro.configs import get_reduced as ref_get_reduced
    from repro.core import DeploymentProfile as RefProfile
    from repro.core import analyze as ref_analyze
    from repro.core import build_artifact as ref_build_artifact
    from repro.models.zoo import build_model as ref_build_model
    from repro.serving import GenerationEngine as RefEngine
    from repro.serving import cold_start as ref_cold_start
    from repro_torch.configs import get_reduced
    from repro_torch.core import analyze
    from repro_torch.models import build_model
    from repro_torch.serving import GenerationEngine, cold_start

    prof = dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1024, vocab_row_group=32)
    ref_model = ref_build_model(ref_get_reduced("yi-34b").replace(dtype="float32"))
    ref_result = ref_analyze(ref_model, RefProfile(**prof), trace_B=1, trace_S=8)
    ref_build_artifact(ref_model.init(jax.random.PRNGKey(0)), ref_result, str(tmp_path))
    model = build_model(get_reduced("yi-34b").replace(dtype="float32"))
    result = analyze(model, DeploymentProfile(**prof), trace_B=1, trace_S=8)
    logits = np.random.default_rng(5).standard_normal((3, model.cfg.vocab_size)).astype(np.float32)
    ref_server = ref_cold_start(ref_model, str(tmp_path), ref_result, compile_warm_set=False)
    try:
        with cold_start(model, str(tmp_path), result, compile_warm_set=False, device="cpu") as server:
            for k in (1, 8, 40):
                ref_eng = RefEngine(ref_server, hint_topk=k)
                eng = GenerationEngine(server, hint_topk=k)
                for rows in (logits, logits[0]):
                    want = ref_eng.topk_row_hints(jnp.asarray(rows))
                    assert want and eng.topk_row_hints(torch.from_numpy(rows)) == want
    finally:
        ref_server.close()

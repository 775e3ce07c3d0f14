"""The port's host arbiter (``repro_torch.core.arbiter``) against the
reference's (tests/test_arbiter.py), each package's tenants over optional
stores the reference wrote:

  * registration turns the tenant's private budget off (restored at
    unregister); invalid registrations fail with the reference's messages;
  * the victim rule: cross-tenant eviction picks the reference's victims in
    the reference's order, pinned keys of every tenant are never evicted,
    floors hold, overshoots are counted when pins and floors block, trace
    heat protects a profiled tenant's units;
  * ``audit`` catches books that were tampered with; ``observe_tick`` gives
    the reference's shares (within 1e-12); a daemon tick feeds the arbiter;
    the prefetcher's headroom gate drops speculative loads only;
  * deterministic interleavings of register / ensure / pin / evict /
    unregister give the reference's victims and books after every step, and
    a small hypothesis search holds the same invariants;
  * a three-tenant threaded stress of pinned ``ensure`` against
    ``rebalance`` and ``audit`` (threads joined with a timeout)."""

import os
import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AccessTrace as RefTrace
from repro.core import HostArbiter as RefArbiter
from repro.core import RetierDaemon as RefDaemon
from repro.core import TieredParams as RefTiered
from repro.core.entrypoints import SERVING_PROFILE as REF_SERVING_PROFILE
from repro.core.optional_store import OptionalStore as RefStore
from repro.core.optional_store import write_store as ref_write_store
from repro.core.param_graph import ReachabilityReport as RefReach
from repro.core.partition import TierDecision as RefDecision
from repro.core.partition import TierPlan as RefPlan
from repro.core.partition import Unit as RefUnit
from repro_torch.core import AccessTrace, DeploymentProfile, HostArbiter, Prefetcher, RetierDaemon, TieredParams
from repro_torch.core.optional_store import OptionalStore
from repro_torch.core.param_graph import ReachabilityReport
from repro_torch.core.partition import TierDecision, TierPlan, Unit

ROWS, COLS, N_UNITS = 16, 32, 8
UNIT_BYTES = ROWS * COLS * 4
KEYS = [f"emb#rg{g}" for g in range(N_UNITS)]
PKGS = ("ref", "port")
JOIN_S = 60.0


def _write(path: str, seed: int) -> np.ndarray:
    data = np.random.default_rng(seed).standard_normal((N_UNITS * ROWS, COLS)).astype(np.float32)
    ref_write_store(path, [(k, data[g * ROWS:(g + 1) * ROWS]) for g, k in enumerate(KEYS)])
    return data


def _tiered(pkg: str, path: str, budget=None):
    """One package's one-leaf tiered tree of N_UNITS row-group units over the
    store at ``path``."""
    if pkg == "ref":
        units = tuple(RefUnit(k, "emb", rows=(g * ROWS, (g + 1) * ROWS), nbytes=UNIT_BYTES) for g, k in enumerate(KEYS))
        plan = RefPlan({"emb": RefDecision("emb", 1, "rows", "test", N_UNITS * UNIT_BYTES, units=units)},
                       REF_SERVING_PROFILE, [])
        return RefTiered({"emb": jnp.zeros((N_UNITS * ROWS, COLS), jnp.float32)}, plan, RefStore(path),
                         device_budget_bytes=budget)
    units = tuple(Unit(k, "emb", rows=(g * ROWS, (g + 1) * ROWS), nbytes=UNIT_BYTES) for g, k in enumerate(KEYS))
    plan = TierPlan({"emb": TierDecision("emb", 1, "rows", "test", N_UNITS * UNIT_BYTES, units=units)},
                    DeploymentProfile(name="serving"), [])
    return TieredParams({"emb": torch.zeros((N_UNITS * ROWS, COLS))}, plan, OptionalStore(path),
                        device_budget_bytes=budget)


@pytest.fixture
def mini(tmp_path):
    """``mini(pkg, name, seed, budget)`` → (tiered, data); stores closed at teardown."""
    made = []

    def make(pkg="port", name="mini", seed=0, budget=None):
        path = str(tmp_path / f"{name}.blob")
        data = _write(path, seed) if not os.path.exists(path) else np.random.default_rng(seed).standard_normal(
            (N_UNITS * ROWS, COLS)).astype(np.float32)
        tp = _tiered(pkg, path, budget)
        made.append(tp)
        return tp, data

    yield make
    for tp in made:
        tp.store.close()


def _rows(tp, g):
    return np.asarray(tp.leaf("emb"))[g * ROWS:(g + 1) * ROWS]


def _arbiter(pkg, budget, **kw):
    return (RefArbiter if pkg == "ref" else HostArbiter)(budget, **kw)


def _record_victims(tp, log: list, name: str) -> None:
    """Wrap ``tp.evict`` (the arbiter's only way to evict) to log ``(tenant, key)``."""
    inner = tp.evict

    def evict(keys):
        keys = list(keys)
        got = inner(keys)
        if got:
            log.extend((name, k) for k in keys)
        return got

    tp.evict = evict


def _exact_rows(tp, data):
    for g, k in enumerate(KEYS):
        want = data[g * ROWS:(g + 1) * ROWS] if tp.is_resident(k) else np.zeros((ROWS, COLS), np.float32)
        np.testing.assert_array_equal(_rows(tp, g), want)


def _join(threads, timeout=JOIN_S):
    for t in threads:
        t.join(timeout)
    alive = [t.name for t in threads if t.is_alive()]
    assert not alive, f"threads still running after {timeout} s (a deadlock?): {alive}"


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def test_register_disables_private_budget_unregister_restores(mini):
    tp, _ = mini(budget=3 * UNIT_BYTES)
    arb = HostArbiter(budget_bytes=6 * UNIT_BYTES)
    arb.register("a", tp, share=1.0)
    assert tp.arbiter is arb and tp.tenant_name == "a" and tp.residency.budget_bytes is None
    tp.ensure(KEYS[:5])  # the private budget would have evicted here
    assert tp.resident_bytes == 5 * UNIT_BYTES
    arb.unregister("a")
    assert tp.arbiter is None and tp.tenant_name == "" and tp.residency.budget_bytes == 3 * UNIT_BYTES
    tp.release([])  # back under its own budget: the next release reclaims the excess
    assert tp.resident_bytes <= 3 * UNIT_BYTES
    assert arb.stats.registered == arb.stats.unregistered == 1


def test_register_validation_messages_match_reference(mini):
    msgs = {}
    for pkg in PKGS:
        tp1, _ = mini(pkg, name="a")
        tp2, _ = mini(pkg, name="b")
        arb = _arbiter(pkg, 4 * UNIT_BYTES)
        arb.register("a", tp1, floor_bytes=3 * UNIT_BYTES)
        got = []
        for call in (lambda: arb.register("a", tp2),
                     lambda: _arbiter(pkg, UNIT_BYTES).register("x", tp1),
                     lambda: arb.register("b", tp2, floor_bytes=2 * UNIT_BYTES),
                     lambda: arb.register("b", tp2, share=0.0),
                     lambda: arb.register("b", tp2, floor_bytes=-1),
                     lambda: arb.unregister("never-registered"),
                     lambda: _arbiter(pkg, 0),
                     lambda: _arbiter(pkg, 1, feedback_gain=1.5),
                     lambda: _arbiter(pkg, 1, feedback_decay=-0.1)):
            with pytest.raises((ValueError, KeyError)) as e:
                call()
            got.append((e.type.__name__, str(e.value)))
        msgs[pkg] = got
    assert msgs["port"] == msgs["ref"]
    kinds = [m for _, m in msgs["port"]]
    assert "already registered" in kinds[0] and "already governed" in kinds[1] and "floors" in kinds[2]


# ---------------------------------------------------------------------------
# the victim rule, against the reference
# ---------------------------------------------------------------------------

def _two(mini, pkg, budget=4 * UNIT_BYTES, **reg):
    tp1, d1 = mini(pkg, name="a", seed=1)
    tp2, d2 = mini(pkg, name="b", seed=2)
    arb = _arbiter(pkg, budget)
    arb.register("a", tp1, **reg.get("a", {}))
    arb.register("b", tp2, **reg.get("b", {}))
    log: list = []
    _record_victims(tp1, log, "a")
    _record_victims(tp2, log, "b")
    return arb, (tp1, d1), (tp2, d2), log


def test_cross_tenant_eviction_same_victims_as_reference(mini):
    runs = {}
    for pkg in PKGS:
        arb, (tp1, d1), (tp2, d2), log = _two(mini, pkg)
        tp1.ensure(KEYS[:4])   # fills the host budget
        tp2.ensure(KEYS[:2])   # must displace a's units
        tp2.ensure(KEYS[5:7])
        tp1.ensure([KEYS[0]])
        assert arb.total_resident_bytes() <= 4 * UNIT_BYTES
        for tp, data in ((tp1, d1), (tp2, d2)):
            _exact_rows(tp, data)
        runs[pkg] = (log, arb.stats.to_dict(), arb.audit(), tp1.resident_keys, tp2.resident_keys)
    assert runs["port"] == runs["ref"]
    assert runs["port"][1]["cross_evictions"] >= 2


def test_pinned_keys_of_any_tenant_never_evicted(mini):
    arb, (tp1, d1), (tp2, _), _ = _two(mini, "port")
    tp1.ensure(KEYS[:3], pin=True)
    tp2.ensure(KEYS[:4])  # pressure against a's pins
    assert all(tp1.is_resident(k) for k in KEYS[:3])
    for g in range(3):
        np.testing.assert_array_equal(_rows(tp1, g), d1[g * ROWS:(g + 1) * ROWS])
    tp1.release(KEYS[:3])
    assert arb.total_resident_bytes() <= 4 * UNIT_BYTES  # rebalance reclaimed


def test_floor_blocks_starvation_and_overshoots_match_reference(mini):
    runs = {}
    for pkg in PKGS:
        arb, (tp1, _), (tp2, _), log = _two(mini, pkg, a={"floor_bytes": 2 * UNIT_BYTES})
        tp1.ensure(KEYS[:3])
        tp2.ensure(KEYS[:6])  # a hot neighbour wants it all
        assert tp1.resident_bytes >= 2 * UNIT_BYTES and arb.stats.floor_skips > 0
        assert arb.total_resident_bytes() <= 4 * UNIT_BYTES
        floor_run = (list(log), arb.stats.to_dict())
        arb2, (tq1, _), (tq2, _), log2 = _two(mini, pkg)
        tq1.ensure(KEYS[:4], pin=True)  # budget fully pinned
        tq2.ensure(KEYS[:2], pin=True)  # nothing evictable: overshoot
        assert tq2.resident_bytes == 2 * UNIT_BYTES and arb2.total_resident_bytes() == 6 * UNIT_BYTES
        assert arb2.stats.overshoots >= 2 and arb2.tenants["b"].overshoots >= 2
        tq1.release(KEYS[:4])
        tq2.release(KEYS[:2])
        assert arb2.total_resident_bytes() <= 4 * UNIT_BYTES
        runs[pkg] = (floor_run, list(log2), arb2.stats.to_dict(), arb2.tenants["b"].overshoots)
    assert runs["port"] == runs["ref"]


def test_heat_weighted_victims_prefer_cold_tenant(mini):
    runs = {}
    for pkg in PKGS:
        arb, (tp1, _), (tp2, _), log = _two(mini, pkg)
        tp1.start_trace((RefTrace if pkg == "ref" else AccessTrace)())
        tp2.ensure(KEYS[:2])  # b: resident, no heat
        tp1.ensure(KEYS[:2])  # a: resident and traced
        tp1.ensure(KEYS[:2])
        tp1.ensure([KEYS[2]])  # need one unit: it must come from b
        assert (tp1.resident_bytes, tp2.resident_bytes) == (3 * UNIT_BYTES, UNIT_BYTES)
        assert not tp2.is_resident(KEYS[0]) and tp2.is_resident(KEYS[1])  # stamp tie broken by key
        runs[pkg] = list(log)
    assert runs["port"] == runs["ref"] == [("b", KEYS[0])]


def test_audit_detects_tampered_books(mini):
    tp, _ = mini()
    arb = HostArbiter(budget_bytes=4 * UNIT_BYTES)
    arb.register("a", tp)
    tp.ensure(KEYS[:2], pin=True)
    audit = arb.audit()
    assert audit["resident_bytes"] == 2 * UNIT_BYTES == audit["pinned_bytes"]
    assert audit["tenants"]["a"] == {"resident_bytes": 2 * UNIT_BYTES, "pinned_bytes": 2 * UNIT_BYTES,
                                     "floor_bytes": 0, "share": 1.0}
    tp.residency.resident_bytes += 1  # cook the running counter
    with pytest.raises(AssertionError, match="charged"):
        arb.audit()
    tp.residency.resident_bytes -= 1
    tp.release(KEYS[:2])
    assert arb.audit()["over_budget"] == 0


# ---------------------------------------------------------------------------
# share feedback, the daemon, the prefetch gate
# ---------------------------------------------------------------------------

def test_observe_tick_shares_match_reference(mini):
    """The same refault script through both arbiters: the shares after every
    ``observe_tick`` agree within 1e-12, move toward the thrashing tenant,
    keep their sum and relax back once the pressure decays."""
    history = {}
    for pkg in PKGS:
        tps = [mini(pkg, name=n, seed=i)[0] for i, n in enumerate("abc")]
        arb = _arbiter(pkg, 6 * UNIT_BYTES)
        for n, tp, share in zip("abc", tps, (1.0, 2.0, 0.5)):
            arb.register(n, tp, share=share)
        seq = []
        for tick in range(24):
            if tick < 6:
                tps[0].stats.refaults += 10 - tick
                tps[2].stats.refaults += tick % 3
            for tp in tps:
                arb.observe_tick(tp)
                seq.append(tuple(sorted(arb.shares().items())))
        history[pkg] = (seq, arb.stats.share_updates)
    (ref_seq, ref_n), (seq, n) = history["ref"], history["port"]
    assert n == ref_n > 0 and len(seq) == len(ref_seq)
    for got, want in zip(seq, ref_seq):
        assert [k for k, _ in got] == [k for k, _ in want]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=0, atol=1e-12)
        assert sum(v for _, v in got) == pytest.approx(3.5)
    peak = max(s[0][1] for s in seq)
    assert peak > 1.0 and seq[-1][0][1] < peak  # rose under pressure, relaxed after


def test_daemon_tick_feeds_arbiter(mini):
    tp, _ = mini()
    reach = ReachabilityReport(entry_names=["prefill", "decode_step"], reachable={"emb": {"prefill"}})
    arb = HostArbiter(budget_bytes=6 * UNIT_BYTES)
    arb.register("a", tp)
    daemon = RetierDaemon(tp, reach, interval_steps=1, decay=0.5)
    tp.ensure(KEYS[:3])
    assert daemon.tick() is not None
    tenant = arb.tenant_of(tp)
    assert tenant.history is not None and tenant.history.touches
    assert tenant.history is daemon.merged_trace
    assert tenant.last_refaults == tp.stats.refaults
    assert daemon.stats.errors == 0


def test_prefetch_headroom_gates_speculative_loads_only(mini):
    tp, _ = mini()
    arb = HostArbiter(budget_bytes=3 * UNIT_BYTES)
    arb.register("a", tp)
    tp.ensure(KEYS[:3])  # at budget and at share
    with Prefetcher(tp, batch_units=2) as pf:
        assert pf.hint([KEYS[4]]) == 0  # would force an eviction
        assert pf.stats.skipped_headroom == 1 and arb.stats.headroom_denials == 1
        tp.evict([KEYS[0]])
        assert pf.hint([KEYS[4]]) == 1
        assert pf.drain(10.0)
    assert tp.is_resident(KEYS[4])
    tp.ensure([KEYS[5]])  # a demand load is never gated: it displaces
    assert tp.is_resident(KEYS[5]) and arb.total_resident_bytes() <= 3 * UNIT_BYTES


# ---------------------------------------------------------------------------
# interleavings: victims and books after every step, against the reference
# ---------------------------------------------------------------------------

HOST_BUDGET = 6 * UNIT_BYTES
_SHARED: dict = {}


def _shared_paths():
    """Three read-only stores written once per process (hypothesis examples
    must not use function-scoped directories)."""
    if not _SHARED:
        root = tempfile.mkdtemp(prefix="torch_arbiter_")
        for i in range(3):
            path = os.path.join(root, f"t{i}.blob")
            _SHARED[i] = (path, _write(path, 100 + i))
    return _SHARED


def _run_ops(pkg: str, ops) -> list:
    """One interleaving against 3 fresh tenants of one package; checks the
    reference test's invariants after every op and returns, per op, the
    victims it evicted and the audit."""
    stores = _shared_paths()
    arb = _arbiter(pkg, HOST_BUDGET)
    tps = [_tiered(pkg, stores[i][0]) for i in range(3)]
    log: list = []
    for i, tp in enumerate(tps):
        _record_victims(tp, log, f"t{i}")
    registered, pinned = [False] * 3, [[], [], []]
    trail = []
    try:
        for op in ops:
            kind, i = op[0], op[1]
            tp = tps[i]
            before = [t.resident_bytes for t in tps]
            n0 = len(log)
            if kind == "register":
                if registered[i]:
                    continue
                arb.register(f"t{i}", tp, share=op[2], floor_bytes=op[3] * UNIT_BYTES)
                registered[i] = True
            elif kind == "unregister":
                if not registered[i] or pinned[i]:
                    continue
                arb.unregister(f"t{i}")
                registered[i] = False
            elif kind == "ensure":
                if not registered[i]:
                    continue
                ks = [KEYS[g] for g in op[2]]
                tp.ensure(ks, pin=op[3])
                if op[3]:
                    pinned[i].append(ks)
            elif kind == "release":
                if not pinned[i]:
                    continue
                tp.release(pinned[i].pop())
            elif kind == "evict":
                tp.evict([KEYS[g] for g in op[2]])
            for j in range(3):
                for batch in pinned[j]:
                    assert all(tps[j].is_resident(k) for k in batch), (kind, i, j)
            audit = arb.audit()
            for j in range(3):
                if registered[j] and not (kind == "evict" and j == i):
                    floor = arb.tenants[f"t{j}"].floor_bytes
                    assert tps[j].resident_bytes >= min(before[j], floor), (kind, i, j)
            if kind in ("ensure", "release", "evict") and not any(pinned):
                assert sum(t.resident_bytes for j, t in enumerate(tps) if registered[j]) <= HOST_BUDGET
            trail.append((op, log[n0:] if kind != "evict" else [], audit))
        trail.append(("stats", arb.stats.to_dict()))
        return trail
    finally:
        for tp in tps:
            tp.store.close()


SEQUENCES = [
    [("register", 0, 1.0, 1), ("register", 1, 2.0, 1), ("ensure", 0, [0, 1, 2, 3], False),
     ("ensure", 1, [0, 1, 2, 3], True), ("ensure", 0, [4, 5], True), ("release", 1), ("evict", 0, [0, 1]),
     ("release", 0), ("register", 2, 0.5, 0), ("ensure", 2, [6, 7], False), ("unregister", 1),
     ("ensure", 2, [0, 1, 2], True), ("release", 2), ("unregister", 2), ("unregister", 0)],
    [("register", 0, 1.0, 0), ("register", 1, 1.0, 0), ("ensure", 0, [0, 1, 2], True),
     ("ensure", 1, [0, 1, 2], True), ("register", 2, 4.0, 2), ("ensure", 2, [0, 1, 2, 3], False),
     ("ensure", 2, [4, 5, 6, 7], False), ("release", 0), ("release", 1), ("evict", 2, [4, 5, 6, 7])],
    [("register", 0, 0.5, 0), ("register", 1, 2.0, 1), ("register", 2, 1.0, 0),
     ("ensure", 0, [0, 1], False), ("ensure", 1, [2, 3, 4], False), ("ensure", 2, [5, 6, 7], False),
     ("ensure", 0, [2, 3, 4, 5], False), ("ensure", 1, [0], True), ("ensure", 2, [1, 2], False),
     ("release", 1), ("unregister", 2), ("ensure", 0, [6, 7], False)],
]


@pytest.mark.parametrize("seq", range(len(SEQUENCES)))
def test_interleavings_deterministic_match_reference(seq):
    port = _run_ops("port", SEQUENCES[seq])
    ref = _run_ops("ref", SEQUENCES[seq])
    assert port == ref
    assert any(victims for _, victims, _ in port[:-1])  # the budget did bite


def test_property_interleavings_match_reference():
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    unit_idxs = st.lists(st.integers(0, N_UNITS - 1), min_size=1, max_size=4, unique=True)
    op = st.one_of(
        st.tuples(st.just("register"), st.integers(0, 2), st.sampled_from([0.5, 1.0, 2.0]), st.integers(0, 1)),
        st.tuples(st.just("unregister"), st.integers(0, 2)),
        st.tuples(st.just("ensure"), st.integers(0, 2), unit_idxs, st.booleans()),
        st.tuples(st.just("release"), st.integers(0, 2)),
        st.tuples(st.just("evict"), st.integers(0, 2), unit_idxs),
    )

    @settings(max_examples=8, deadline=None, derandomize=True, database=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(st.lists(op, min_size=1, max_size=20))
    def check(ops):
        assert _run_ops("port", ops) == _run_ops("ref", ops)

    check()


# ---------------------------------------------------------------------------
# threaded stress
# ---------------------------------------------------------------------------

def test_stress_three_tenants_pinned_ensure_vs_rebalance(mini):
    """3 tenants x 2 pinned-ensure threads against a rebalance/audit loop
    under a budget half the combined working set: mid-step a pinned unit
    stays resident with exact bytes whichever tenant is making room; at rest
    the books are exact, the budget holds and the floors held."""
    budget = 6 * UNIT_BYTES
    arb = HostArbiter(budget_bytes=budget)
    tenants = []
    for i in range(3):
        tp, data = mini(name=f"t{i}", seed=10 + i)
        arb.register(f"t{i}", tp, floor_bytes=UNIT_BYTES)
        tenants.append((tp, data))
    errors: list = []
    stop = threading.Event()

    def requester(tid, seed):
        tp, data = tenants[tid]
        rng = np.random.default_rng(seed)
        try:
            for _ in range(25):
                step = [str(k) for k in rng.choice(KEYS, size=2, replace=False)]
                tp.ensure(step, pin=True)
                try:
                    for k in step:
                        assert tp.is_resident(k), f"pinned {k} not resident"
                        g = KEYS.index(k)
                        np.testing.assert_array_equal(_rows(tp, g), data[g * ROWS:(g + 1) * ROWS],
                                                      err_msg=f"pinned t{tid}/{k} zeroed mid-step")
                finally:
                    tp.release(step)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    def rebalancer():
        try:
            while not stop.is_set():
                arb.rebalance()
                arb.audit()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=requester, args=(tid, 31 * tid + r), name=f"t{tid}r{r}")
               for tid in range(3) for r in range(2)]
    rt = threading.Thread(target=rebalancer, name="rebalancer")
    rt.start()
    for t in threads:
        t.start()
    try:
        _join(threads)
    finally:
        stop.set()
        _join([rt])
    assert not errors, errors
    assert arb.stats.evictions > 0 and arb.stats.cross_evictions > 0
    audit = arb.audit()
    assert audit["pinned_bytes"] == 0 and audit["resident_bytes"] <= budget
    for tp, data in tenants:
        res = tp.residency
        assert res.resident_bytes == len(res.resident_keys) * UNIT_BYTES
        _exact_rows(tp, data)
        assert tp.resident_bytes >= UNIT_BYTES  # floors held

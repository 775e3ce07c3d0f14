"""The port's fleet controller (``repro_torch.core.fleet``) and
``cold_start(fleet=, replica_name=)`` against the reference's
(tests/test_fleet.py), each package's replicas over optional stores the
reference wrote:

  * scripted ``sync()`` cycles over three replicas (one without a budget,
    two with, so the overlay is trimmed to the tightest) give the
    reference's summaries, ``FleetStats``, overlay, history, residency and
    loads cycle for cycle, and a ``snapshot()`` whose JSON is the same bytes;
  * ``restore`` round-trips the state and bootstraps a late joiner resident
    before it serves;
  * a failing push is isolated to its replica; a plan that breaks the
    tier-0 invariant is refused before anything changes; a duplicate name
    is refused;
  * the overlay and history of a sync do not depend on the order the
    replicas are polled in (every order of three);
  * the predictor breaks ties by key;
  * end to end on reduced Mixtral (fp32, the reference's strict artifact):
    two replicas, one sync, and a late joiner give the reference's tokens,
    ``FleetStats`` and faults."""

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.core import AccessTrace as RefTrace
from repro.core import DeploymentProfile as RefProfile
from repro.core import FleetController as RefFleet
from repro.core import RetierDaemon as RefDaemon
from repro.core import TransitionPredictor as RefPredictor
from repro.core import analyze as ref_analyze
from repro.core import build_artifact as ref_build_artifact
from repro.models.zoo import build_model as ref_build_model
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro_torch.configs import get_reduced
from repro_torch.core import (
    AccessTrace,
    DeploymentProfile,
    FleetController,
    FleetStats,
    RetierDaemon,
    TransitionPredictor,
    analyze,
)
from repro_torch.core.partition import TierPlan, Unit
from repro_torch.models import build_model
from repro_torch.serving import GenerationEngine, cold_start

from test_torch_retier_daemon import KEYS, ROWS, UNIT_BYTES, _loads, _rows, _stats, twin  # noqa: F401

ARCH = "mixtral-8x22b"
PROMPT_LEN, NEW_TOKENS, MAX_SEQ = 8, 4, 24
# each cycle: (replica, unit groups it faults or touches) before the sync
SCRIPT = [
    [(0, [4, 5])],
    [(1, [1, 2, 4]), (2, [6])],
    [(0, [4]), (2, [6, 7, 0])],
    [],  # nothing new: every window empty
    [(1, [3])],
]
BUDGETS = (None, 4, 3)  # per replica, in units


def _fleets(twin, budgets=BUDGETS, **fleet_kw):
    """A (reference, port) pair of fleets, each with one real daemon a replica
    over the replica's own store; returns ([ref, port] fleets, per-package
    lists of (tiered, daemon))."""
    fleets, reps = [RefFleet(**fleet_kw), FleetController(**fleet_kw)], [[], []]
    for i, b in enumerate(budgets):
        pair = twin(budget=None if b is None else b * UNIT_BYTES, name=f"r{i}")
        for pkg, (cls, (tp, reach)) in enumerate(zip((RefDaemon, RetierDaemon), pair[:2])):
            d = cls(tp, reach, interval_steps=10_000)
            fleets[pkg].register(f"r{i}", d)
            reps[pkg].append((tp, d))
    return fleets, reps


def _view(fleet, reps, summary) -> dict:
    h = fleet.history
    return dict(summary=summary, stats=fleet.stats.to_dict(), overlay=fleet.overlay,
                history=None if h is None else h.to_json(), replicas=fleet.replicas,
                resident=[sorted(tp.resident_keys) for tp, _ in reps], loads=[_loads(tp) for tp, _ in reps],
                daemons=[_stats(d) for _, d in reps], errors=dict(fleet.last_errors))


@pytest.mark.parametrize("decay,sync_preload", [(0.5, False), (0.25, True)])
def test_scripted_syncs_match_reference(twin, decay, sync_preload):
    fleets, reps = _fleets(twin, decay=decay, sync_preload=sync_preload)
    for cycle in SCRIPT:
        views = []
        for fleet, rep in zip(fleets, reps):
            for i, groups in cycle:
                rep[i][0].ensure([KEYS[g] for g in groups])
            views.append(_view(fleet, rep, fleet.sync()))
        assert views[1] == views[0]
    v = views[1]
    assert v["stats"]["syncs"] == len(SCRIPT) and v["stats"]["push_failures"] == 0
    assert v["stats"]["empty_windows"] >= 3 and v["stats"]["replans"] >= 4
    # the overlay fits the tightest budget (3 units)
    assert sum(len(ks) for ks in v["overlay"].values()) <= min(b for b in BUDGETS if b)
    wire = [json.dumps(f.snapshot(), sort_keys=True) for f in fleets]
    assert wire[1] == wire[0]
    assert json.loads(wire[1])["history"]["version"] == 3


def test_sync_federates_one_replicas_faults_to_all(twin):
    """Replica 0 explores, replica 1 is idle; one sync: both hold the two
    units, replica 1's rows are the store's bytes, loaded by the push."""
    fleets, reps = _fleets(twin, budgets=(None, None))
    tp0, _ = reps[1][0]
    tp1, d1 = reps[1][1]
    reps[0][0][0].ensure([KEYS[4], KEYS[5]])
    tp0.ensure([KEYS[4], KEYS[5]])
    want, got = fleets[0].sync(), fleets[1].sync()
    assert got == want and got["replanned"] and sorted(got["pushed"]) == ["r0", "r1"]
    assert set(fleets[1].overlay["emb"]) == {KEYS[4], KEYS[5]}
    data = twin(name="bytes")[2]
    for g in (4, 5):
        assert tp1.is_resident(KEYS[g])
        np.testing.assert_array_equal(_rows(tp1, g), data[g * ROWS:(g + 1) * ROWS])
    fs = fleets[1].stats
    assert (fs.syncs, fs.replans, fs.pushes, fs.pulls, fs.empty_windows) == (1, 1, 2, 2, 1)
    assert d1.stats.remote_applies == 1 and d1.stats.pulls == 1
    assert isinstance(fs, FleetStats)


def test_restore_roundtrips_and_bootstraps_a_late_joiner(twin):
    fleets, reps = _fleets(twin, budgets=(None,), decay=0.25, sync_preload=True)
    for fleet, rep in zip(fleets, reps):
        rep[0][0].ensure([KEYS[2], KEYS[7]])
        fleet.sync()
    wires = [json.dumps(f.snapshot(), sort_keys=True) for f in fleets]
    assert wires[1] == wires[0]
    restored = [RefFleet.restore(json.loads(wires[0])), FleetController.restore(json.loads(wires[1]))]
    assert json.dumps(restored[1].snapshot(), sort_keys=True) == wires[1]
    assert restored[1].decay == 0.25 and restored[1].sync_preload is True
    late = twin(name="late")
    views = []
    for pkg, (fc, cls) in enumerate(zip(restored, (RefDaemon, RetierDaemon))):
        tp, reach = late[pkg]
        d = cls(tp, reach, interval_steps=10_000)
        assert fc.register("late", d) is True
        views.append((fc.stats.to_dict(), sorted(tp.resident_keys), _loads(tp), _stats(d)))
    assert views[1] == views[0]
    assert views[1][0]["bootstraps"] == 1 and views[1][1] == [KEYS[2], KEYS[7]]
    for g in (2, 7):
        np.testing.assert_array_equal(_rows(late[1][0], g), late[2][g * ROWS:(g + 1) * ROWS])
    for cls in (RefFleet, FleetController):
        with pytest.raises(ValueError, match="version"):
            cls.restore({"version": 99})


def test_failing_push_is_isolated(twin):
    fleets, reps = _fleets(twin, budgets=(None, None, None))

    def boom(plan, **kw):
        raise RuntimeError("replica wedged")

    views = []
    for fleet, rep in zip(fleets, reps):
        rep[1][1].apply_plan = boom
        rep[0][0].ensure([KEYS[4]])
        first = fleet.sync()
        rep[0][0].ensure([KEYS[6]])
        views.append((first, _view(fleet, rep, fleet.sync())))
    assert views[1] == views[0]
    first, v = views[1]
    assert "replica wedged" in first["failed"]["r1"] and "replica wedged" in v["errors"]["r1"]
    assert v["stats"]["push_failures"] == 2 and v["stats"]["pushes"] == 4
    tp1, tp2 = reps[1][1][0], reps[1][2][0]
    assert tp2.is_resident(KEYS[4]) and tp2.is_resident(KEYS[6])
    assert tp1.resident_keys == set() and tp1.plan.decisions["emb"].resident_units == ()


def test_plan_breaking_the_invariant_is_refused_before_any_change(twin):
    fleets, reps = _fleets(twin, budgets=(None,))
    for fleet, rep in zip(fleets, reps):
        rep[0][0].ensure([KEYS[1]])
        fleet.sync()
    tp, d = reps[1][0]
    before = (tp.plan, sorted(tp.resident_keys), _loads(tp), _stats(d))
    bad = TierPlan({**tp.plan.decisions,
                    "w": dataclasses.replace(tp.plan.decisions["w"], tier=1, units=(Unit("w", "w", nbytes=128),))},
                   tp.plan.profile, [])
    with pytest.raises(ValueError, match="invariant"):
        d.apply_plan(bad)
    assert (tp.plan, sorted(tp.resident_keys), _loads(tp), _stats(d)) == before


def test_duplicate_name_refused(twin):
    fleets, reps = _fleets(twin, budgets=(None,))
    for fleet, rep in zip(fleets, reps):
        with pytest.raises(ValueError, match="already registered"):
            fleet.register("r0", rep[0][1])
        fleet.unregister("r0")
        assert fleet.replicas == []
        fleet.register("r0", rep[0][1])  # the name is free again
        assert fleet.replicas == ["r0"]
    with pytest.raises(ValueError, match="decay"):
        FleetController(decay=1.5)


class _StubDaemon:
    """The controller-facing daemon surface with a canned window and a
    recording apply."""

    def __init__(self, tp, reach, window):
        self.tiered, self.reach, self._window, self.applied = tp, reach, window, []

    def pull_window(self):
        w, self._window = self._window, None
        return w

    def apply_plan(self, plan, *, trace=None, sync_preload=False):
        self.applied.append(plan)
        return {"promoted": 0, "demoted": 0}


def _windows(cls) -> list:
    rng = np.random.default_rng(11)
    out = []
    for _ in range(3):
        w = cls()
        for _ in range(3):
            ks = list(rng.choice(KEYS, size=int(rng.integers(1, 4)), replace=False))
            cold = [k for k in ks if rng.random() < 0.5]
            w.record(ks, cold, ["prefill", "decode", ""][int(rng.integers(0, 3))])
        out.append(w)
    return out


@pytest.mark.parametrize("order", list(itertools.permutations(range(3))), ids=lambda o: "".join(map(str, o)))
def test_sync_independent_of_poll_order(twin, order):
    """Three replicas' windows registered (so polled) in every order give the
    overlay and history of order 012, and the reference's."""
    (ref_tp, ref_reach), (tp, reach), _ = twin(budget=4 * UNIT_BYTES)

    def one(fleet_cls, trace_cls, tp, reach, idx):
        windows = _windows(trace_cls)
        fleet = fleet_cls()
        for i in idx:
            fleet.register(f"r{i}", _StubDaemon(tp, reach, windows[i]))
        fleet.sync()
        return fleet.overlay, fleet.history.to_json()

    got = one(FleetController, AccessTrace, tp, reach, order)
    assert got == one(FleetController, AccessTrace, tp, reach, (0, 1, 2))
    assert got == one(RefFleet, RefTrace, ref_tp, ref_reach, order)
    assert got[0]["emb"]  # the windows' faults made an overlay


def test_predictor_ties_break_by_key():
    fwd = {"a": {"x": 2, "y": 2, "z": 3}}
    rev = {"a": {"z": 3, "y": 2, "x": 2}}
    for cls in (TransitionPredictor, RefPredictor):
        assert cls(fwd, top_k=3).successors("a") == cls(rev, top_k=3).successors("a") == ["z", "x", "y"]
        assert cls(rev, top_k=2).successors("a") == ["z", "x"]


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    ref_cfg = ref_get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)
    ref_model = ref_build_model(ref_cfg)
    strict = dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                  vocab_row_group=max(64, ref_cfg.vocab_size // 16))
    ref_result = ref_analyze(ref_model, RefProfile(**strict), trace_B=1, trace_S=32)
    outdir = str(tmp_path_factory.mktemp("fleet_artifact"))
    ref_build_artifact(ref_model.init(jax.random.PRNGKey(0)), ref_result, outdir)
    model = build_model(get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True))
    result = analyze(model, DeploymentProfile(**strict), trace_B=1, trace_S=32)
    return ref_model, ref_result, model, result, outdir


def test_cold_start_fleet_late_joiner_matches_reference(app):
    """Strict replicas with daemons registered through ``cold_start(fleet=)``:
    replica-0 serves, the fleet syncs, replica-1 cold-starts (named by
    default), is bootstrapped from the overlay inside ``register`` and serves
    the same request. Tokens, ``FleetStats``, faults and residency equal the
    reference's; each replica's ``ColdStartReport`` equals the reference's
    (modes and bytes; the bootstrap is not upload) and the bootstrap's bytes
    are ``server.fleet_bootstrap``'s; both replicas' tokens equal a solo
    run's; ``fleet=`` without ``retier_online`` is refused."""
    ref_model, ref_result, model, result, outdir = app
    tokens = np.random.default_rng(9).integers(0, 512, (2, PROMPT_LEN)).astype(np.int32)
    kw = dict(residency="strict", retier_online=True, retier_interval=10_000, compile_warm_set=False)

    def drive(start, engine_cls, fleet, prompt):
        views, reports = [], []
        for name in ("replica-0", None):
            server = start(fleet, name)
            faults_at_start = len(server.tiered.stats.events)
            reports.append((server.report.to_dict(), getattr(server, "fleet_bootstrap", None)))
            out, st = engine_cls(server, max_seq=MAX_SEQ).generate(prompt, NEW_TOKENS)
            views.append(dict(tokens=np.asarray(out).tolist(), faulted_units=st.faulted_units,
                              preloaded=faults_at_start, resident=sorted(server.tiered.resident_keys),
                              daemon=_stats(server.retier_daemon), loads=_loads(server.tiered)))
            if name:
                views.append(fleet.sync())
            server.close()
        return (views, fleet.stats.to_dict(), fleet.replicas), reports

    ref_fleet = RefFleet()
    want, ref_reports = drive(lambda fc, name: ref_cold_start(ref_model, outdir, ref_result, mode="after2", fleet=fc,
                                                           replica_name=name, **kw),
                              RefEngine, ref_fleet, jnp.asarray(tokens))
    fleet = FleetController()
    got, reports = drive(lambda fc, name: cold_start(model, outdir, result, fleet=fc, replica_name=name, device="cpu", **kw),
                         GenerationEngine, fleet, torch.from_numpy(tokens).long())
    assert got == want
    (r0, summary, r1), stats, names = got
    assert names == ["replica-0", "replica-1"] and summary["replanned"]
    assert stats["bootstraps"] == 1 and stats["bootstrap_failures"] == 0 and not fleet.last_errors
    assert r1["preloaded"] > 0 and r1["faulted_units"] < r0["faulted_units"]
    # each replica's report equals the reference's field for field (seconds
    # aside): the late joiner's bootstrap is not in its upload
    for (mine, _), (ref, _) in zip(reports, ref_reports):
        assert list(mine) == list(ref)
        assert {k: mine[k] for k in ("mode", "bytes_read", "bytes_uploaded")} == \
            {k: ref[k] for k in ("mode", "bytes_read", "bytes_uploaded")}
        assert mine["bytes_uploaded"] == mine["bytes_read"]  # strict has no hot set
    # strict has no hot set: what replica-1 preloaded at cold start is its bootstrap
    boot = [b for _, b in reports]
    assert [b["bytes"] for b in boot] == [0, sum(nb for _, nb, src in r1["loads"][:r1["preloaded"]])]
    assert boot[1]["bytes"] > 0 and all(b["seconds"] >= 0 for b in boot)
    with cold_start(model, outdir, result, residency="strict", compile_warm_set=False, device="cpu") as solo:
        out, _ = GenerationEngine(solo, max_seq=MAX_SEQ).generate(torch.from_numpy(tokens).long(), NEW_TOKENS)
    assert r0["tokens"] == r1["tokens"] == out.tolist()
    with pytest.raises(ValueError, match="retier_online"):
        cold_start(model, outdir, result, residency="strict", fleet=FleetController(), device="cpu")

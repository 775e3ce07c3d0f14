"""The port's warm server snapshots (``repro_torch.core.snapshot``,
``ColdStartServer.snapshot``, ``cold_start(restore_from=)``) against the
reference's (tests/test_snapshot.py), each package over an optional store
the reference wrote:

  * ``artifact_fingerprint`` gives the reference's hex on a reference-written
    artifact;
  * the same ``ensure`` sequence captures an equal dict, and ``save`` writes
    the same bytes;
  * a reference snapshot restored by the port gives the reference's report,
    resident keys, stamps, clock and load events, under a tighter budget (the
    hottest suffix stays) and with a foreign key (skipped);
  * the compatibility rule: a fingerprint mismatch raises under ``strict``
    and is a cold join under ``strict=False``, with the reference's report;
    a bad version raises;
  * the predictor's tables round-trip and arm the port's ``Prefetcher``;
  * a restore under a ``HostArbiter`` charges the books as the reference's
    does, and ``audit()`` passes;
  * ``FleetController.register`` bootstraps from an offered snapshot;
  * end to end on reduced Mixtral (fp32, the reference's strict artifact):
    ``cold_start(restore_from=)`` in both packages from one snapshot gives
    the same restore report and resident set, and the tokens of a run
    without the restore and of the reference."""

import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.core import AccessTrace as RefTrace
from repro.core import DeploymentProfile as RefProfile
from repro.core import FleetController as RefFleet
from repro.core import HostArbiter as RefArbiter
from repro.core import Prefetcher as RefPrefetcher
from repro.core import RetierDaemon as RefDaemon
from repro.core import TransitionPredictor as RefPredictor
from repro.core import analyze as ref_analyze
from repro.core import build_artifact as ref_build_artifact
from repro.core import snapshot as ref_snap
from repro.models.zoo import build_model as ref_build_model
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro_torch.configs import get_reduced
from repro_torch.core import (
    SNAPSHOT_VERSION,
    AccessTrace,
    DeploymentProfile,
    FleetController,
    HostArbiter,
    Prefetcher,
    RetierDaemon,
    TransitionPredictor,
    analyze,
    artifact_fingerprint,
    capture_server_snapshot,
    restore_server_snapshot,
)
from repro_torch.core import snapshot as snap_mod
from repro_torch.models import build_model
from repro_torch.serving import GenerationEngine, cold_start
from repro_torch.serving.cold_start import ColdStartReport, ColdStartServer

from test_torch_retier_daemon import KEYS, UNIT_BYTES, _loads, _rows, twin  # noqa: F401 (twin is a fixture)

ARCH = "mixtral-8x22b"
PROMPT_LEN, NEW_TOKENS, MAX_SEQ = 8, 4, 24


def _warm(tp, order):
    for g in order:  # one ensure a unit: one stamp each
        tp.ensure([KEYS[g]])


def _stamps(tp) -> dict:
    res = tp.residency
    return {k: res._stamp[k] for k in res._lru}


def _state(tp) -> dict:
    """What a restore leaves behind: resident keys in LRU order, their stamps,
    the clock and the load events."""
    return dict(lru=list(tp.residency._lru), stamps=_stamps(tp), clock=tp.residency._clock, loads=_loads(tp))


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    """The reference's strict artifact of reduced Mixtral (fp32) and both
    packages' models and plans for it."""
    ref_cfg = ref_get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)
    ref_model = ref_build_model(ref_cfg)
    strict = dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                  vocab_row_group=max(64, ref_cfg.vocab_size // 16))
    ref_result = ref_analyze(ref_model, RefProfile(**strict), trace_B=1, trace_S=32)
    outdir = str(tmp_path_factory.mktemp("snap_artifact") / "art")
    ref_build_artifact(ref_model.init(jax.random.PRNGKey(0)), ref_result, outdir)
    model = build_model(get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True))
    result = analyze(model, DeploymentProfile(**strict), trace_B=1, trace_S=32)
    return ref_model, ref_result, model, result, outdir


def test_public_names_match_reference():
    import repro.core as ref_core
    import repro_torch.core as core

    names = ("FleetController", "FleetStats", "SNAPSHOT_VERSION", "artifact_fingerprint",
             "capture_server_snapshot", "restore_server_snapshot")
    assert all(n in ref_core.__all__ and n in core.__all__ for n in names)
    assert SNAPSHOT_VERSION == ref_snap.SNAPSHOT_VERSION == 1
    assert capture_server_snapshot is snap_mod.capture and restore_server_snapshot is snap_mod.restore


def test_artifact_fingerprint_matches_reference(app, tmp_path):
    outdir = app[-1]
    fp = artifact_fingerprint(outdir)
    assert fp == ref_snap.artifact_fingerprint(outdir) and len(fp) == 64
    # a copy with one more file, and one with a manifest's bytes changed
    # (same size), both disagree with the original as the reference's do
    extra = tmp_path / "extra"
    shutil.copytree(outdir, extra)
    (extra / "sub").mkdir()
    (extra / "sub" / "x.bin").write_bytes(b"abc")
    edited = tmp_path / "edited"
    shutil.copytree(outdir, edited)
    manifest = edited / "artifact.json"
    text = manifest.read_text()
    manifest.write_text(text.replace("serving", "servinG", 1))
    for d in (extra, edited):
        got = artifact_fingerprint(str(d))
        assert got == ref_snap.artifact_fingerprint(str(d)) and got != fp


def test_capture_and_save_match_reference(twin, tmp_path):
    (ref, _), (port, _), _ = twin(budget=5 * UNIT_BYTES)
    art = tmp_path / "art"
    art.mkdir()
    (art / "optional.blob.manifest.json").write_text('{"a": 1}')
    for tp in (ref, port):
        _warm(tp, (3, 1, 5, 1, 0, 6, 7, 2))  # past the budget: LRU evictions
    want = ref_snap.capture(ref, artifact_dir=str(art))
    got = capture_server_snapshot(port, artifact_dir=str(art))
    assert got == want and got["predictor"] is None
    assert [k for k, _ in got["resident"]] == [KEYS[g] for g in (1, 0, 6, 7, 2)]  # oldest stamp first
    ref_snap.save(want, str(tmp_path / "ref.json"))
    snap_mod.save(got, str(tmp_path / "port.json"))
    assert (tmp_path / "ref.json").read_bytes() == (tmp_path / "port.json").read_bytes()
    assert not os.path.exists(str(tmp_path / "port.json") + ".partial")
    assert snap_mod.load(str(tmp_path / "port.json")) == json.loads(json.dumps(want))


@pytest.mark.parametrize("budget_units,foreign", [(None, False), (3, True), (None, True)])
def test_reference_snapshot_restores_in_the_port(twin, budget_units, foreign):
    """A donor warmed by the reference, captured by the reference, restored
    onto a fresh loader of each package: the same report, LRU order, stamps,
    clock and loads; under a tighter budget the donor's hottest suffix stays,
    and a foreign key is skipped; the rows are the store's bytes."""
    (donor, _), _, data = twin(name="donor")
    order = [5, 0, 2, 7, 4, 1]
    _warm(donor, order)
    snap = ref_snap.capture(donor)
    if foreign:
        snap["resident"].insert(0, ["not-a-real-unit", 0])
    budget = budget_units * UNIT_BYTES if budget_units else None
    (ref, _), (port, _), _ = twin(budget=budget, name="fresh")
    want = ref_snap.restore(ref, snap)
    got = restore_server_snapshot(port, snap)
    assert got == want
    assert got["skipped_foreign"] == int(foreign) and got["restored"] == (budget_units or len(order))
    assert _state(port) == _state(ref)
    keep = order[-budget_units:] if budget_units else order
    assert port.resident_keys == {KEYS[g] for g in keep}
    assert _stamps(port) == {k: s for k, s in _stamps(donor).items() if k in port.resident_keys}
    for g in keep:
        np.testing.assert_array_equal(_rows(port, g), data[g * 16:(g + 1) * 16])
    # a second restore gives the same report in both; with room for the whole
    # set it moves nothing, everything being resident
    again = (ref_snap.restore(ref, snap), restore_server_snapshot(port, snap))
    assert again[0] == again[1] and _state(port) == _state(ref)
    assert (again[1]["moved_bytes"] == 0) == (budget_units is None)


def test_fingerprint_mismatch_and_version(twin, tmp_path):
    arts = {}
    for name, payload in (("a", b"aa"), ("b", b"bbbb")):
        d = tmp_path / f"art-{name}"
        d.mkdir()
        (d / "optional.blob").write_bytes(payload)
        arts[name] = str(d)
    (donor, _), _, _ = twin(name="donor")
    _warm(donor, (0, 3))
    snap = ref_snap.capture(donor, artifact_dir=arts["a"])
    (ref, _), (port, _), _ = twin(name="fresh")
    for fn, tp in ((ref_snap.restore, ref), (restore_server_snapshot, port)):
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            fn(tp, snap, artifact_dir=arts["b"])
    cold = [fn(tp, snap, artifact_dir=arts["b"], strict=False)
            for fn, tp in ((ref_snap.restore, ref), (restore_server_snapshot, port))]
    assert cold[0] == cold[1] and cold[1]["fingerprint_ok"] is False and cold[1]["restored"] == 0
    assert port.resident_keys == set() and port.stats.events == []
    warm = [fn(tp, snap, artifact_dir=arts["a"])
            for fn, tp in ((ref_snap.restore, ref), (restore_server_snapshot, port))]
    assert warm[0] == warm[1] and warm[1]["fingerprint_ok"] is True and warm[1]["restored"] == 2
    for bad in ({"version": 99}, {}):
        with pytest.raises(ValueError, match="snapshot version") as ref_err:
            ref_snap.restore(ref, bad)
        with pytest.raises(ValueError, match="snapshot version") as port_err:
            restore_server_snapshot(port, bad)
        assert str(port_err.value) == str(ref_err.value)


def _trace(cls):
    t = cls()
    for keys, cold, phase in ((["a", "b"], ["a", "b"], "prefill"), (["b", "c"], ["c"], "decode"),
                              (["c", "a"], ["a"], "decode"), (["d"], ["d"], "")):
        t.record(keys, cold, phase)
    return t


def test_predictor_roundtrips_and_arms_the_port_prefetcher(twin):
    ref_pred = RefPredictor.from_trace(_trace(RefTrace))
    pred = TransitionPredictor.from_trace(_trace(AccessTrace))
    assert pred.to_dict() == ref_pred.to_dict()
    (donor, _), _, _ = twin(name="donor")
    _warm(donor, (1,))
    pf_donor = RefPrefetcher(donor, predictor=ref_pred)
    try:
        snap = ref_snap.capture(donor, prefetcher=pf_donor)
    finally:
        pf_donor.stop()
    assert snap["predictor"] == ref_pred.to_dict()
    _, (port, _), _ = twin(name="fresh")
    pf = Prefetcher(port)
    try:
        rep = restore_server_snapshot(port, snap, prefetcher=pf)
        assert rep["predictor_armed"] and rep["restored"] == 1
        assert pf.predictor.to_dict() == ref_pred.to_dict()
        for keys, phase in ((["a"], "prefill"), (["b"], "decode"), (["c"], "decode")):
            assert pf.predictor.follow(keys, phase=phase, prev=[]) == ref_pred.follow(keys, phase=phase, prev=[])
        # the port's own capture carries the armed predictor, as the reference's does
        assert capture_server_snapshot(port, prefetcher=pf)["predictor"] == snap["predictor"]
    finally:
        pf.stop()


def test_restore_under_host_arbiter_charges_books_as_reference(twin):
    """A warmed tenant's snapshot restored onto a fresh tenant that shares an
    arbiter with a co-tenant: each restored byte charged once, ``audit()``
    passes, and the books, stats and resident sets equal the reference's."""
    (donor, _), _, _ = twin(name="donor")
    _warm(donor, (2, 6, 1, 4))
    snap = ref_snap.capture(donor)
    (ref, _), (port, _), _ = twin(name="fresh")
    (ref_o, _), (port_o, _), _ = twin(name="other")
    books = []
    for arb_cls, fn, fresh, other in ((RefArbiter, ref_snap.restore, ref, ref_o),
                                      (HostArbiter, restore_server_snapshot, port, port_o)):
        arb = arb_cls(5 * UNIT_BYTES)
        arb.register("restored", fresh, share=0.5)
        arb.register("other", other, share=0.5)
        other.ensure([KEYS[0], KEYS[7]])
        rep = fn(fresh, snap)
        audit = arb.audit()
        books.append((rep, audit, arb.stats.to_dict(), sorted(fresh.resident_keys), sorted(other.resident_keys),
                      fresh.residency.charged_bytes()))
    assert books[1] == books[0]
    rep, audit, _, keys, _, charged = books[1]
    assert rep["moved_bytes"] == 4 * UNIT_BYTES and charged == audit["tenants"]["restored"]["resident_bytes"]
    assert audit["resident_bytes"] <= 5 * UNIT_BYTES and keys


def test_fleet_register_bootstraps_from_an_offered_snapshot(twin):
    (donor, _), _, _ = twin(name="donor")
    _warm(donor, (0, 3))
    snap = ref_snap.capture(donor)
    results = []
    for fleet_cls, daemon_cls, pkg in ((RefFleet, RefDaemon, 0), (FleetController, RetierDaemon, 1)):
        fleet = fleet_cls()
        with pytest.raises(ValueError, match="snapshot version"):
            fleet.offer_server_snapshot({"version": 99})
        fleet.offer_server_snapshot(snap)
        tp, reach = twin(name=f"joiner{pkg}")[pkg]
        warmed = fleet.register("replica-0", daemon_cls(tp, reach, interval_steps=10_000))
        # the snapshot rides the fleet's own snapshot/restore round trip
        fc2 = fleet_cls.restore(json.loads(json.dumps(fleet.snapshot())))
        tp2, reach2 = twin(name=f"late{pkg}")[pkg]
        warmed2 = fc2.register("replica-1", daemon_cls(tp2, reach2, interval_steps=10_000))
        results.append((warmed, warmed2, sorted(tp.resident_keys), sorted(tp2.resident_keys), _stamps(tp2),
                        fleet.stats.to_dict(), fc2.stats.to_dict(), json.dumps(fleet.snapshot(), sort_keys=True)))
    assert results[1] == results[0]
    assert results[1][0] is True and results[1][2] == sorted(donor.resident_keys)
    assert results[1][5]["bootstraps"] == 1 and results[1][5]["bootstrap_failures"] == 0


def test_cold_start_restore_from_matches_reference(app, tmp_path):
    """A strict reference server warmed by one request writes its snapshot;
    each package cold-starts strict with ``restore_from=`` (the path, and in
    the port the dict too): equal restore reports and resident sets with the
    donor's stamps, upload counts the replayed bytes, and the next request's
    tokens equal a run without the restore and the reference's."""
    ref_model, ref_result, model, result, outdir = app
    tokens = np.random.default_rng(5).integers(0, 512, (2, PROMPT_LEN)).astype(np.int32)
    donor = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="strict", compile_warm_set=False)
    RefEngine(donor, max_seq=MAX_SEQ).generate(jnp.asarray(tokens), NEW_TOKENS)
    snap = donor.snapshot()
    donor_stamps = _stamps(donor.tiered)
    donor.close()
    path = str(tmp_path / "snap.json")  # outside the artifact: the fingerprint covers every file there
    ref_snap.save(snap, path)
    assert snap["resident"] and snap["artifact"]["fingerprint"] == artifact_fingerprint(outdir)

    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="strict",
                                compile_warm_set=False, restore_from=path)
    ref_report, ref_restored = ref_server.restore_report, _state(ref_server.tiered)
    ref_out, ref_stats = RefEngine(ref_server, max_seq=MAX_SEQ).generate(jnp.asarray(tokens), NEW_TOKENS)
    ref_server.close()
    prompt = torch.from_numpy(tokens).long()
    with cold_start(model, outdir, result, residency="strict", compile_warm_set=False, device="cpu") as plain:
        out_plain, _ = GenerationEngine(plain, max_seq=MAX_SEQ).generate(prompt, NEW_TOKENS)
    for source in (path, snap):
        with cold_start(model, outdir, result, residency="strict", compile_warm_set=False, device="cpu",
                        restore_from=source) as server:
            rr = server.restore_report
            assert rr == ref_report and rr["fingerprint_ok"] is True and rr["restored"] == len(snap["resident"])
            assert _state(server.tiered) == ref_restored and _stamps(server.tiered) == donor_stamps
            assert list(server.tiered.residency._lru) == [k for k, _ in snap["resident"]]
            assert server.report.bytes_uploaded == server.report.bytes_read + rr["moved_bytes"]
            assert capture_server_snapshot(server.tiered)["resident"] == snap["resident"]
            out, stats = GenerationEngine(server, max_seq=MAX_SEQ).generate(prompt, NEW_TOKENS)
            np.testing.assert_array_equal(out, out_plain)
            np.testing.assert_array_equal(out, np.asarray(ref_out))
            assert stats.faulted_units == ref_stats.faulted_units


def test_cold_start_refuses_restore_outside_after2_and_snapshot_untiered(app, tmp_path):
    _, _, model, result, outdir = app
    with pytest.raises(ValueError, match="after2-only"):
        cold_start(model, outdir, result, mode="before", restore_from={"version": 1}, device="cpu")
    with cold_start(model, outdir, result, residency="strict", compile_warm_set=False, device="cpu") as server:
        assert server.restore_report is None
    with pytest.raises(ValueError, match="tiered"):
        ColdStartServer(model, {}, ColdStartReport("before"), device="cpu").snapshot()
    # a restore against another artifact raises, and the half-built server is closed
    other = tmp_path / "other.json"
    snap = {"version": 1, "artifact": {"dir": "x", "fingerprint": "0" * 64}, "clock": 0, "resident": [],
            "predictor": None}
    snap_mod.save(snap, str(other))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        cold_start(model, outdir, result, residency="stats", compile_warm_set=False, device="cpu",
                   restore_from=str(other))
    assert not [t for t in threading.enumerate() if t.name.startswith("prefetch-")]

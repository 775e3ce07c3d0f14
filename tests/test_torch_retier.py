"""Profile-guided re-tiering in the port (``repro_torch.core.retier``,
``checkpoint.manager``, ``OptionalStoreWriter.add_raw``) against the
reference, on reduced Mixtral at float32 with the launcher's stats profile
(one resident expert a layer, a quarter of the row groups hot) and on a
hand-made plan whose leaves change tier.

Both packages serve the reference's artifact under strict with a trace on:
the traces are equal. From the same trace both replan to the same plan and
report, and the port's ``retier_artifact`` of the reference's artifact is
byte-identical to the reference's own (tier-0 bundle, blob, manifest,
artifact.json), for an unchanged plan (no recompression) and for plans that
promote and demote. An adversarial trace cannot demote a reachable dense
leaf. A crash between the staging write and the rename leaves the source
artifact intact, and ``clean_partials`` removes the staging directory."""

import hashlib
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_manager
from repro.configs import get_reduced as ref_get_reduced
from repro.core import AccessTrace as RefTrace
from repro.core import DeploymentProfile as RefProfile
from repro.core import analyze as ref_analyze
from repro.core import build_artifact as ref_build_artifact
from repro.core import retier as ref_retier
from repro.core.entrypoints import SERVING_PROFILE as REF_SERVING_PROFILE
from repro.core.param_graph import ReachabilityReport as RefReach
from repro.core.partition import TierDecision as RefDecision
from repro.core.partition import TierPlan as RefPlan
from repro.core.partition import Unit as RefUnit
from repro.data import DataConfig, SyntheticTokenPipeline
from repro.models.zoo import build_model as ref_build_model
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro_torch.checkpoint import tensorstore_lite as tsl
from repro_torch.checkpoint.manager import clean_partials, commit_dir, orphaned_partials
from repro_torch.configs import get_reduced
from repro_torch.core import (
    AccessTrace,
    DeploymentProfile,
    analyze,
    apply_overlay,
    check_tier0_superset,
    coaccess_order,
    replan_from_trace,
    required_tier0,
    residency_overlay,
    retier_artifact,
)
from repro_torch.core import retier as retier_mod
from repro_torch.core.optional_store import OptionalStore, OptionalStoreWriter, StoreEntry, TornFrameError
from repro_torch.core.param_graph import ReachabilityReport
from repro_torch.core.partition import TierDecision, TierPlan, Unit
from repro_torch.models import build_model
from repro_torch.serving import GenerationEngine, cold_start

ARCH = "mixtral-8x22b"
SERVING_PROFILE = DeploymentProfile(name="serving")
FILES = ("tier0.bin", "tier0.index.json", "optional.blob", "optional.blob.manifest.json", "artifact.json")


def _stats_profile(cfg) -> dict:
    return dict(resident_experts=1, hot_vocab_fraction=0.25, min_tier1_bytes=1 << 14,
                vocab_row_group=max(64, cfg.vocab_size // 16))


def _decisions(plan) -> dict:
    """A plan's decisions in a form both packages compare equal in."""
    return {p: (d.tier, d.granularity, d.reason, d.nbytes, [(u.key, u.path, tuple(u.sel), u.rows, u.nbytes)
                                                           for u in d.units], list(d.resident_units))
            for p, d in plan.decisions.items()}


def _report(rep) -> dict:
    return {k: getattr(rep, k) for k in ("promoted_resident", "demoted_resident", "promoted_leaves",
                                         "demoted_leaves", "promoted_bytes", "demoted_bytes", "budget_skipped")}


def _digest(d) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def _same_files(a, b):
    assert sorted(os.listdir(a)) == sorted(FILES) == sorted(os.listdir(b))
    for name in FILES:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reference's stats-profile artifact of reduced Mixtral, both
    packages' plans of it, and the traces each package records serving it
    under strict (no prefetcher, a quarter of tier-1 on the device)."""
    ref_cfg = ref_get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)
    ref_model = ref_build_model(ref_cfg)
    prof = _stats_profile(ref_cfg)
    hot = SyntheticTokenPipeline(DataConfig(ref_cfg.vocab_size, 128, 8)).vocab_row_stats(
        row_group=prof["vocab_row_group"])
    ref_result = ref_analyze(ref_model, RefProfile(**prof), hot_units_stats=hot, trace_B=1, trace_S=32)
    outdir = str(tmp_path_factory.mktemp("ref_artifact"))
    ref_build_artifact(ref_model.init(jax.random.PRNGKey(0)), ref_result, outdir)

    model = build_model(get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True))
    result = analyze(model, DeploymentProfile(**prof), hot_units_stats=hot, trace_B=1, trace_S=32)
    assert _decisions(result.plan) == _decisions(ref_result.plan)

    tokens = np.random.default_rng(11).integers(0, ref_cfg.vocab_size, (2, 8))
    ref_server = ref_cold_start(ref_model, outdir, ref_result, residency="strict", trace=True,
                                compile_warm_set=False)
    try:
        ref_out, _ = RefEngine(ref_server, max_seq=20).generate(jnp.asarray(tokens, jnp.int32), 5)
        ref_trace = ref_server.tiered.trace
    finally:
        ref_server.close()
    with cold_start(model, outdir, result, residency="strict", trace=True, compile_warm_set=False,
                    device="cpu") as server:
        out, _ = GenerationEngine(server, max_seq=20).generate(torch.from_numpy(tokens), 5)
        trace = server.tiered.trace
    np.testing.assert_array_equal(out, ref_out)
    return dict(ref_model=ref_model, ref_result=ref_result, model=model, result=result, outdir=outdir,
                ref_trace=ref_trace, trace=trace, tokens=tokens, ref_out=ref_out)


def test_served_traces_are_equal(served):
    """A live trace of the port is the reference's: every v3 table, the
    second-order and per-phase ones included."""
    doc = served["trace"].to_dict()
    assert doc == served["ref_trace"].to_dict()
    assert doc["faults"] and doc["transitions"] and doc["phase_transitions"]


def _traces(served):
    """(name, reference trace, port trace) cases for the replanner."""
    out = [("empty", RefTrace(), AccessTrace()), ("served", served["ref_trace"], served["trace"])]
    keys = sorted(u.key for u in served["result"].plan.all_tier1_units())
    ref_t, port_t = RefTrace(), AccessTrace()
    rng = np.random.default_rng(4)
    for step in range(12):
        pick = [keys[i] for i in rng.choice(len(keys), size=3, replace=False)]
        for t in (ref_t, port_t):
            t.record(pick, pick[:2], "decode")
            t.record_request(step % 2, pick[1:])
    out.append(("synthetic", ref_t, port_t))
    return out


@pytest.mark.parametrize("kw", [{}, {"max_promote_bytes": 300_000}, {"promote_min_faults": 2},
                                {"demote_untouched_residents": False}],
                         ids=["default", "budget", "min-faults-2", "keep-residents"])
def test_replan_matches_reference(served, kw):
    for name, ref_t, port_t in _traces(served):
        ref_plan, ref_rep = ref_retier.replan_from_trace(served["ref_result"].plan, ref_t,
                                                         served["ref_result"].reach, **kw)
        plan, rep = replan_from_trace(served["result"].plan, port_t, served["result"].reach, **kw)
        assert _decisions(plan) == _decisions(ref_plan), name
        assert _report(rep) == _report(ref_rep) and rep.summary() == ref_rep.summary(), name
        assert residency_overlay(plan) == ref_retier.residency_overlay(ref_plan)
        if name != "empty" and kw.get("promote_min_faults", 1) == 1:
            assert rep.promoted_resident
        if name == "synthetic" and kw.get("demote_untouched_residents", True):
            assert rep.demoted_resident  # it touches few of the hot units
        if name == "empty":
            assert _decisions(plan) == _decisions(served["result"].plan)


def test_overlay_and_coaccess_order_match_reference(served):
    plan, ref_plan = served["result"].plan, served["ref_result"].plan
    overlay = {p: list(reversed([u.key for u in d.units])) + ["foreign#key"]
               for p, d in plan.decisions.items() if d.tier == 1}
    overlay["not-a-path"] = ["x"]
    assert _decisions(apply_overlay(plan, overlay)) == _decisions(ref_retier.apply_overlay(ref_plan, overlay))
    keys = sorted(u.key for u in plan.all_tier1_units())
    for t in (served["trace"], _traces(served)[2][2]):
        for pairs in (t.pairs, t.request_pairs):
            assert coaccess_order(keys, pairs) == ref_retier.coaccess_order(keys, pairs)


@pytest.mark.parametrize("case", ["unchanged", "unchanged-coaccess", "served-trace", "synthetic-trace"])
def test_retiered_artifact_is_byte_identical(served, tmp_path, case):
    """The port rewrites the reference's artifact into the same bytes as the
    reference's own ``retier_artifact``; an unchanged plan copies every
    tier-1 frame raw and recompresses none."""
    names = {"served-trace": 1, "synthetic-trace": 2, "unchanged-coaccess": 2}
    _, ref_t, port_t = _traces(served)[names.get(case, 0)]
    ref_plan, ref_rep = served["ref_result"].plan, None
    plan, rep = served["result"].plan, None
    if case in ("served-trace", "synthetic-trace"):
        ref_plan, ref_rep = ref_retier.replan_from_trace(ref_plan, ref_t, served["ref_result"].reach)
        plan, rep = replan_from_trace(plan, port_t, served["result"].reach)
    with_trace = case != "unchanged"
    src = served["outdir"]
    before = _digest(src)
    ref_meta = ref_retier.retier_artifact(src, ref_plan, out_dir=str(tmp_path / "ref"), report=ref_rep,
                                          trace=ref_t if with_trace else None)
    meta = retier_artifact(src, plan, out_dir=str(tmp_path / "port"), report=rep,
                           trace=port_t if with_trace else None)
    assert meta == ref_meta
    _same_files(tmp_path / "ref", tmp_path / "port")
    assert _digest(src) == before  # the source artifact is never touched
    n_units = len(plan.all_tier1_units())
    assert meta["compaction"]["raw_copied"] == n_units and meta["compaction"]["recompressed"] == 0
    if case == "unchanged":
        assert meta["compaction"]["layout"] == {"source": "source-order"}
        with open(os.path.join(src, "optional.blob"), "rb") as f1, open(tmp_path / "port" / "optional.blob",
                                                                        "rb") as f2:
            assert f1.read() == f2.read()  # the same frames in the same order
    elif with_trace:
        assert meta["compaction"]["layout"]["source"] == "coaccess"
    assert not os.path.exists(str(tmp_path / "port") + ".partial")


def _hand_made(tmp_path):
    """A reference-written artifact of four leaves: "a" tier-0 and reached,
    "dead" tier-0 and reached by no entry (demotable), "emb" four tier-1 row
    groups with rg0 hot, "mod" a tier-1 leaf. Returns both packages' plans
    and reachability, the artifact directory and the weights."""
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((8, 8)).astype(np.float32),
              "dead": rng.standard_normal((4, 8)).astype(np.float32),
              "emb": rng.standard_normal((64, 4)).astype(np.float32),
              "mod": rng.standard_normal((16, 4)).astype(np.float32)}

    def plan_of(D, U, P, profile):
        rows = tuple(U(f"emb#rg{g}", "emb", rows=(g * 16, (g + 1) * 16), nbytes=16 * 4 * 4) for g in range(4))
        return P({"a": D("a", 0, "leaf", "dense", params["a"].nbytes),
                  "dead": D("dead", 0, "leaf", "dense", params["dead"].nbytes),
                  "emb": D("emb", 1, "rows", "rows", params["emb"].nbytes, units=rows,
                           resident_units=(rows[0].key,)),
                  "mod": D("mod", 1, "leaf", "modal", params["mod"].nbytes,
                           units=(U("mod", "mod", nbytes=params["mod"].nbytes),))},
                 profile, ["prefill"])

    reach = {"a": {"prefill"}, "emb": {"prefill"}, "mod": set(), "dead": set()}
    ref_plan = plan_of(RefDecision, RefUnit, RefPlan, REF_SERVING_PROFILE)
    ref_reach = RefReach(entry_names=["prefill", "decode_step"], reachable={p: set(s) for p, s in reach.items()})
    outdir = str(tmp_path / "artifact")
    ref_build_artifact(params, types.SimpleNamespace(plan=ref_plan, reach=ref_reach, profile=REF_SERVING_PROFILE),
                       outdir)
    plan = plan_of(TierDecision, Unit, TierPlan, SERVING_PROFILE)
    port_reach = ReachabilityReport(entry_names=["prefill", "decode_step"],
                                    reachable={p: set(s) for p, s in reach.items()})
    return (ref_plan, ref_reach), (plan, port_reach), outdir, params


def test_leaves_change_tier_byte_identically(tmp_path):
    """A faulted tier-1 leaf moves into the tier-0 bundle, an unreachable
    tier-0 leaf into the store (the one recompressed frame), the untouched
    hot row group leaves the hot set; both packages write the same bytes,
    and the moved leaves keep their values."""
    (ref_plan, ref_reach), (plan, reach), outdir, params = _hand_made(tmp_path)
    ops = [(["mod", "emb#rg2"], ["mod", "emb#rg2"], "prefill"), (["emb#rg3"], ["emb#rg3"], "decode")]
    ref_t, port_t = RefTrace(), AccessTrace()
    for keys, cold, phase in ops:
        ref_t.record(keys, cold, phase)
        port_t.record(keys, cold, phase)
    ref_new, ref_rep = ref_retier.replan_from_trace(ref_plan, ref_t, ref_reach)
    new, rep = replan_from_trace(plan, port_t, reach)
    assert _decisions(new) == _decisions(ref_new) and _report(rep) == _report(ref_rep)
    assert rep.promoted_leaves == ["mod"] and rep.demoted_leaves == ["dead"]
    assert rep.demoted_resident == ["emb#rg0"] and new.decisions["emb"].resident_units == ("emb#rg2", "emb#rg3")
    for trace in (None, port_t):
        ref_dir, port_dir = tmp_path / f"ref-{trace is None}", tmp_path / f"port-{trace is None}"
        ref_meta = ref_retier.retier_artifact(outdir, ref_new, out_dir=str(ref_dir), report=ref_rep,
                                              trace=None if trace is None else ref_t)
        meta = retier_artifact(outdir, new, out_dir=str(port_dir), report=rep, trace=trace)
        assert meta == ref_meta
        assert meta["compaction"]["raw_copied"] == 4 and meta["compaction"]["recompressed"] == 1
        _same_files(ref_dir, port_dir)
    tier0 = tsl.read_bundle(str(port_dir / "tier0"))
    assert sorted(tier0) == ["a", "mod"]
    np.testing.assert_array_equal(tier0["mod"].numpy(), params["mod"])
    store = OptionalStore(str(port_dir / "optional.blob"))
    try:
        np.testing.assert_array_equal(store.fetch("dead").numpy(), params["dead"])
        for g in range(4):
            np.testing.assert_array_equal(store.fetch(f"emb#rg{g}").numpy(), params["emb"][g * 16:(g + 1) * 16])
    finally:
        store.close()
    with pytest.raises(ValueError, match="out_dir"):
        retier_artifact(outdir, new, out_dir=outdir)


def test_adversarial_trace_cannot_demote_a_reachable_dense_leaf(served):
    plan, reach = served["result"].plan, served["result"].reach
    required = required_tier0(plan, reach)
    assert required and required == ref_retier.required_tier0(served["ref_result"].plan, served["ref_result"].reach)
    tier0 = [p for p, d in plan.decisions.items() if d.tier == 0]
    keys = [u.key for u in plan.all_tier1_units()]
    traces = []
    t = AccessTrace()  # tier-0 leaves claimed faulted, fabricated keys, huge counts
    t.record(tier0 + [f"ghost#{i}" for i in range(4)], tier0 + ["ghost#0"], "decode")
    t.faults = {k: 10**9 for k in t.faults}
    traces.append(t)
    rng = np.random.default_rng(3)
    t = AccessTrace()
    for _ in range(20):
        pick = list(rng.choice(keys + tier0, size=4, replace=False))
        t.record(pick, pick, str(rng.choice(["prefill", "decode", ""])))
    traces.append(t)
    for trace in traces:
        new, _ = replan_from_trace(plan, trace, reach, max_promote_bytes=1)
        check_tier0_superset(new, required)
        assert all(new.decisions[p].tier == 0 for p in required)
    broken = dict(plan.decisions)
    victim = sorted(required)[0]
    broken[victim] = TierDecision(victim, 1, "leaf", "broken", broken[victim].nbytes,
                                  units=(Unit(victim, victim, nbytes=broken[victim].nbytes),))
    with pytest.raises(ValueError, match="invariant"):
        check_tier0_superset(TierPlan(broken, plan.profile, plan.entry_names), required)


def test_crash_before_the_rename_leaves_the_source_intact(served, tmp_path, monkeypatch):
    """A crash after the staging directory is written and before
    ``commit_dir`` renames it: the source artifact is byte-identical, no
    re-tiered artifact appears, the ``.partial`` is an orphan that
    ``clean_partials`` removes (and only it), and a re-run commits."""
    src = served["outdir"]
    before = _digest(src)
    out = tmp_path / "art-retier"

    def crash(tmp, final):
        raise OSError("crash before the rename")

    monkeypatch.setattr(retier_mod, "commit_dir", crash)
    with pytest.raises(OSError, match="crash"):
        retier_artifact(src, served["result"].plan, out_dir=str(out))
    assert _digest(src) == before and not out.exists()
    staged = str(out) + ".partial"
    assert sorted(os.listdir(staged)) == sorted(FILES)
    (tmp_path / "trace.json.partial").write_text("{}")  # a file with the suffix is no staging dir
    assert orphaned_partials(str(tmp_path)) == [staged] == ref_manager.orphaned_partials(str(tmp_path))
    assert clean_partials(str(tmp_path)) == [staged]
    assert not os.path.exists(staged) and (tmp_path / "trace.json.partial").exists()
    monkeypatch.undo()
    retier_artifact(src, served["result"].plan, out_dir=str(out))
    assert sorted(os.listdir(out)) == sorted(FILES) and _digest(src) == before
    # commit_dir replaces a committed directory whole
    (tmp_path / "new.partial").mkdir()
    (tmp_path / "new.partial" / "x").write_text("2")
    commit_dir(str(tmp_path / "new.partial"), str(out))
    assert os.listdir(out) == ["x"] and orphaned_partials(str(tmp_path / "missing")) == []


def test_add_raw_layout_and_mapped_bundle(served, tmp_path):
    src = served["outdir"]
    store = OptionalStore(os.path.join(src, "optional.blob"))
    try:
        key = next(iter(store.entries))
        entry = store.entries[key]
        with OptionalStoreWriter(str(tmp_path / "o.blob"), layout={"source": "coaccess", "pairs": "batch"}) as w:
            w.add_raw(key, store.read_raw(key), entry)
            with pytest.raises(TornFrameError):
                w.add_raw("short", store.read_raw(key)[:-1], entry)
        copy = OptionalStore(str(tmp_path / "o.blob"))
        assert torch.equal(copy.fetch(key), store.fetch(key))
        assert StoreEntry(**{**vars(copy.entries[key]), "offset": entry.offset}) == entry
        copy.close()
    finally:
        store.close()
    with open(str(tmp_path / "o.blob.manifest.json")) as f:
        assert json.load(f)["layout"] == {"source": "coaccess", "pairs": "batch"}
    mapped = tsl.read_bundle(os.path.join(src, "tier0"), mmap=True)
    read = tsl.read_bundle(os.path.join(src, "tier0"))
    assert list(mapped) == list(read) and all(torch.equal(mapped[k], read[k]) for k in read)


def test_retiered_artifact_serves_the_same_tokens(served, tmp_path):
    """The cycle the launcher runs: the port's artifact re-tiered from its
    own served trace cold-starts under stats with the trace's predictor
    armed and generates the reference's tokens, faulting fewer bytes."""
    from repro_torch.core import TransitionPredictor

    plan, rep = replan_from_trace(served["result"].plan, served["trace"], served["result"].reach)
    out = str(tmp_path / "retier")
    retier_artifact(served["outdir"], plan, out_dir=out, report=rep)
    result = types.SimpleNamespace(plan=plan, reach=served["result"].reach, profile=served["result"].profile)
    faulted = {}
    for name, d, r, pred in (("before", served["outdir"], served["result"], None),
                             ("after", out, result, TransitionPredictor.from_trace(served["trace"]))):
        with cold_start(served["model"], d, r, residency="stats", predictor=pred, prefetch=False,
                        compile_warm_set=False, device="cpu") as server:
            got, stats = GenerationEngine(server, max_seq=20).generate(torch.from_numpy(served["tokens"]), 5)
            faulted[name] = stats.faulted_bytes
        np.testing.assert_array_equal(got, served["ref_out"])
    assert faulted["after"] < faulted["before"]

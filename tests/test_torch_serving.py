"""The PyTorch port's serving slice end to end against the JAX reference, on
reduced Mixtral, Yi and RecurrentGemma at float32: under the strict and full
residency policies the port cold-starts an artifact the reference wrote and
produces the same greedy tokens, the same LoadEvent key/byte/source sequence
and the same faulted units (none for RecurrentGemma, whose tier-1 is empty);
under stats (prefetcher on) the same tokens, budget and budget invariant;
under full with part of tier-1 left cold (Yi), the same loaded units once
the prefetcher drains. The before/after1 modes read the reference's
monolithic bundles with its byte counts and tokens. An artifact or bundle
the port writes from the same weights equals the reference's byte for byte.
A prefetch commit attempted inside a forward run waits for the run's miss
check, so the run is retried and the tokens stay right."""

import json
import os
import shutil
import threading
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
from repro.core import write_monolithic as ref_write_monolithic
from repro.models.zoo import build_model as ref_build_model
from repro.optim import init_adamw as ref_init_adamw
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import DeploymentProfile, analyze, build_artifact, write_monolithic
from repro_torch.core.on_demand import COLD
from repro_torch.core.optional_store import CorruptFrameError, OptionalStore
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.models import build_model
from repro_torch.optim import init_adamw
from repro_torch.serving import MAX_FAULT_RETRIES, ColdStartReport, ColdStartServer, GenerationEngine, cold_start
from repro_torch.serving.engine import _usage_masks

ARCH = "mixtral-8x22b"


def _strict(cfg):
    return dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                vocab_row_group=max(64, cfg.vocab_size // 16))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's strict artifact of reduced Mixtral, its plan, and its
    before/after1 bundles (params and AdamW moments) of the same weights."""
    cfg = ref_get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)
    model = ref_build_model(cfg)
    result = ref_analyze(model, RefProfile(**_strict(cfg)), trace_B=1, trace_S=32)
    params = model.init(jax.random.PRNGKey(0))
    outdir = str(tmp_path_factory.mktemp("ref_artifact"))
    ref_build_artifact(params, result, outdir)
    opt = ref_init_adamw(params)
    for pruned in (False, True):
        ref_write_monolithic({"params": params, "opt_state": {"m": opt.m, "v": opt.v}}, outdir, pruned=pruned)
    return model, result, params, outdir


def _port_model():
    cfg = get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)
    model = build_model(cfg)
    return model, analyze(model, DeploymentProfile(**_strict(cfg)), trace_B=1, trace_S=32)


def _events(stats):
    return [(e.key, e.nbytes, e.source, e.phase) for e in stats.events]


def _loads(stats):
    return [(e.key, e.nbytes, e.source) for e in stats.events]


@pytest.mark.parametrize("policy", ["strict", "stats", "full"])
@pytest.mark.parametrize("B,S,steps,seed", [(2, 8, 6, 7), (1, 24, 12, 3)])
def test_port_serves_reference_artifact_identically(reference, B, S, steps, seed, policy):
    """The reference runs each policy as it ships, prefetcher included
    (stats and full turn it on). Under strict and full the port loads the
    same units from the same sources in the same order: on this fixture the
    first prefill faults every tier-1 unit, so full's prefetcher finds
    nothing left to load. Under stats the prefetcher's loads race the
    request thread, so load order and source are not compared; the tokens
    are held to the reference's strict run, because the reference's own
    stats run can commit a prefetched expert between a run and its miss
    check and then keep a run computed on placeholder zeros."""
    ref_model, ref_result, _, outdir = reference
    tokens = np.random.default_rng(seed).integers(0, ref_model.cfg.vocab_size, (B, S))

    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2",
                                residency="strict" if policy == "stats" else policy,
                                compile_warm_set=False)
    ref_out, ref_stats = RefEngine(ref_server, max_seq=S + steps + 4).generate(
        jnp.asarray(tokens, jnp.int32), steps)
    ref_server.close()
    if policy == "stats":
        ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="stats",
                                    compile_warm_set=False)
        ref_server.close()

    model, result = _port_model()
    launches = fa_ops.flash_attention.launches
    with cold_start(model, outdir, result, residency=policy, warm_shapes=((B, S),),
                    device="cpu") as server:
        assert server.report.bytes_read == ref_server.report.bytes_read
        assert (server.prefetcher is not None) == (policy != "strict")
        out, stats = GenerationEngine(server, max_seq=S + steps + 4).generate(torch.from_numpy(tokens), steps)
        tiered, ref_tiered = server.tiered, ref_server.tiered
        np.testing.assert_array_equal(out, ref_out)
        assert tiered.residency.budget_bytes == ref_tiered.residency.budget_bytes
        assert stats.prefill_runs == 1 + stats.prefill_retries <= 1 + MAX_FAULT_RETRIES
        if policy == "stats":
            budget = tiered.residency.budget_bytes
            assert budget < result.plan.tier1_bytes
            # over budget only where an install found nothing evictable
            assert tiered.residency.max_resident_bytes <= budget or tiered.residency.overshoot_events > 0
            assert server.prefetcher.drain(30.0)
            assert tiered.resident_bytes <= budget  # released steps leave no overshoot behind
            assert stats.faulted_units > 0
        else:
            assert Counter(_loads(tiered.stats)) == Counter(_loads(ref_tiered.stats))
            assert _events(tiered.stats) == _events(ref_tiered.stats)
            assert tiered.resident_keys == ref_tiered.resident_keys
            assert stats.faulted_units == ref_stats.faulted_units > 0
            assert stats.faulted_bytes == ref_stats.faulted_bytes
            assert (stats.prefill_retries, stats.decode_retries) == \
                (ref_stats.prefill_retries, ref_stats.decode_retries)
            assert tiered.stats.evictions == ref_tiered.stats.evictions
            assert tiered.residency.overshoot_events == ref_tiered.residency.overshoot_events
        threads = {pf._reader, pf._uploader} if (pf := server.prefetcher) else set()
    assert fa_ops.flash_attention.launches == launches  # CPU tensors: plain version only
    assert server.prefetcher is None and not threads & set(threading.enumerate())  # close() joined them


def test_port_artifact_equals_reference(reference, tmp_path):
    _, ref_result, ref_params, ref_dir = reference
    model, result = _port_model()
    params = params_from_numpy({p: np.asarray(v) for p, v in ref_flatten(ref_params)}, "cpu")
    meta = build_artifact(params, result, str(tmp_path))
    with open(os.path.join(ref_dir, "artifact.json")) as f:
        assert json.load(f) == meta
    for name in ("artifact.json", "tier0.bin", "tier0.index.json", "optional.blob",
                 "optional.blob.manifest.json"):
        with open(os.path.join(ref_dir, name), "rb") as f1, open(tmp_path / name, "rb") as f2:
            assert f1.read() == f2.read(), name


def test_cold_start_report_and_trace(reference):
    _, _, _, outdir = reference
    model, result = _port_model()
    with cold_start(model, outdir, result, residency="strict", trace=True, device="cpu",
                    warm_shapes=((1, 8),)) as server:
        r = server.report
        assert r.mode == "after2" and r.bytes_read == result.plan.tier0_bytes
        assert r.read_s > 0 and r.upload_s > 0 and r.compile_s > 0
        assert server.tiered.resident_fraction() == 0.0  # strict: nothing preloaded
        eng = GenerationEngine(server, max_seq=16)
        eng.generate(torch.zeros((1, 8), dtype=torch.int64), 2)
        trace = server.tiered.trace.to_dict()
        assert trace["batches"] > 0 and trace["faults"]
        # in-place installs: the live tree is the one allocated at cold start
        before = {p: t.data_ptr() for p, t in server.tiered._flat.items()}
        eng.generate(torch.ones((1, 8), dtype=torch.int64), 2)
        assert {p: t.data_ptr() for p, t in server.tiered._flat.items()} == before


def test_prefill_entries_are_bounded_least_recently_used_out(reference):
    """Prompt lengths past ``max_prefill_entries`` evict the least recently
    used prefill entry (never the warm set's, never a decode entry); the
    dict never holds more than N of them beyond the warm set, and a length
    served again after its eviction gives the same tokens as a fresh server."""
    _, _, _, outdir = reference
    model, result = _port_model()
    N, lengths = 3, [5, 6, 7, 5, 8, 6, 5]
    prompts = {S: torch.from_numpy(np.random.default_rng(S).integers(0, model.cfg.vocab_size, (1, S)))
               for S in set(lengths)}
    with cold_start(model, outdir, result, residency="full", device="cpu", warm_shapes=((1, 4, 16),)) as fresh:
        eng = GenerationEngine(fresh, max_seq=16)
        want = {S: eng.generate(p, 3)[0] for S, p in prompts.items()}
    with cold_start(model, outdir, result, residency="full", device="cpu", warm_shapes=((1, 4, 16),)) as server:
        server.max_prefill_entries = N
        warm = set(server._compiled)
        eng = GenerationEngine(server, max_seq=16)
        for S in lengths:
            out, _ = eng.generate(prompts[S], 3)
            np.testing.assert_array_equal(out, want[S])
            held = server.prefill_entries()
            assert held[-1] == ("prefill", 1, S) and warm <= set(server._compiled)
            assert len([k for k in held if k not in warm]) <= N
        # 5, 6, 7 fill it; 5 is reused; 8 evicts 6; 6 (again) evicts 7; 5 is reused
        assert server.evicted_prefill_entries == 2
        assert server.prefill_entries() == [("prefill", 1, 4), ("prefill", 1, 8), ("prefill", 1, 6),
                                            ("prefill", 1, 5)]
        assert ("decode", 1, 16) in server._compiled
    with pytest.raises(ValueError, match="max_prefill_entries"):
        ColdStartServer(model, {}, ColdStartReport(mode="before"), device="cpu", max_prefill_entries=0)


def test_cold_start_rejects_unported_modes(reference):
    """Every mode and policy of the reference is served now; an unknown mode
    or policy still raises, and so does after2 without its plan."""
    _, _, _, outdir = reference
    model, result = _port_model()
    with pytest.raises(ValueError, match="unknown mode 'after3'"):
        cold_start(model, outdir, result, mode="after3", device="cpu")
    with pytest.raises(ValueError, match="unknown residency"):
        cold_start(model, outdir, result, residency="bogus", device="cpu")
    with pytest.raises(ValueError, match="needs the AnalysisResult"):
        cold_start(model, outdir, None, device="cpu")


def test_port_serves_reference_monolithic_bundles(reference):
    """before/after1 on the reference's bundles: the reference's byte counts
    and tokens, and the tokens of the port's after2 on the same weights."""
    ref_model, ref_result, _, outdir = reference
    B, S, steps = 2, 8, 5
    tokens = np.random.default_rng(19).integers(0, ref_model.cfg.vocab_size, (B, S))
    model, result = _port_model()
    with cold_start(model, outdir, result, residency="strict", device="cpu", compile_warm_set=False) as server:
        after2, _ = GenerationEngine(server, max_seq=S + steps + 4).generate(torch.from_numpy(tokens), steps)
    reads = {}
    for mode in ("before", "after1"):
        ref_server = ref_cold_start(ref_model, outdir, None, mode=mode, warm_shapes=((B, S),))
        ref_out, _ = RefEngine(ref_server, max_seq=S + steps + 4).generate(jnp.asarray(tokens, jnp.int32), steps)
        with cold_start(model, outdir, mode=mode, warm_shapes=((B, S),), device="cpu") as server:
            assert server.tiered is None and server.prefetcher is None
            r, ref_r = server.report, ref_server.report
            assert (r.mode, r.bytes_read, r.bytes_uploaded) == (mode, ref_r.bytes_read, ref_r.bytes_uploaded)
            assert r.read_s > 0 and r.upload_s > 0 and r.compile_s > 0
            out, stats = GenerationEngine(server, max_seq=S + steps + 4).generate(torch.from_numpy(tokens), steps)
        np.testing.assert_array_equal(out, ref_out)
        np.testing.assert_array_equal(out, after2)
        assert (stats.faulted_units, stats.prefill_runs, stats.prefetch_hits) == (0, 1, 0)
        reads[mode] = r.bytes_read
    # params, then params and the fp32 moments: the pruned bundle is a third
    assert reads["before"] == 3 * reads["after1"] == 3 * r.bytes_uploaded
    assert reads["after1"] == result.plan.tier0_bytes + result.plan.tier1_bytes


def test_port_monolithic_bundles_equal_reference(reference, tmp_path):
    _, _, ref_params, ref_dir = reference
    params = params_from_numpy({p: np.asarray(v) for p, v in ref_flatten(ref_params)}, "cpu")
    opt = init_adamw(params)
    assert opt.step.dtype == torch.int32 and int(opt.step) == 0
    for pruned, name in ((False, "before"), (True, "after1")):
        path = write_monolithic({"params": params, "opt_state": {"m": opt.m, "v": opt.v}},
                                str(tmp_path), pruned=pruned)
        assert path == str(tmp_path / f"{name}.bin")
        for suffix in (".bin", ".index.json"):
            with open(os.path.join(ref_dir, name + suffix), "rb") as f1, open(tmp_path / (name + suffix), "rb") as f2:
                assert f1.read() == f2.read(), name + suffix


def test_prefetch_commit_inside_a_run_waits_for_its_miss_check(reference, monkeypatch):
    """A test hook commits, from another thread, every expert the first
    prefill run routed to while they were cold, after the run computed and
    before its miss check. The commit waits on the gate, so the check still
    sees those experts cold, the step is retried on their real weights and
    the tokens equal those of a run without the hook. (Without the gate the
    commit lands in that window, the run computed on placeholder zeros looks
    complete, and nothing retries it.)"""
    ref_model, _, _, outdir = reference
    B, S, steps = 2, 8, 4
    tokens = torch.from_numpy(np.random.default_rng(23).integers(0, ref_model.cfg.vocab_size, (B, S)))
    model, result = _port_model()
    with cold_start(model, outdir, result, device="cpu", compile_warm_set=False) as server:
        want, _ = GenerationEngine(server, max_seq=S + steps + 4).generate(tokens, steps)

    with cold_start(model, outdir, result, device="cpu", compile_warm_set=False) as server:
        tiered = server.tiered
        engine = GenerationEngine(server, max_seq=S + steps + 4)
        real_prefill = model.prefill
        commits = []

        def commit(keys):  # the prefetcher's two halves: claim, then install
            assert all(tiered.claim_for_prefetch(k) for k in keys)
            for k in keys:
                assert tiered.install_prefetched(k, tiered.store.fetch(k)) > 0

        def hooked_prefill(params, batch):
            logits, caches = real_prefill(params, batch)
            if not commits:
                cold = [k for k in engine._expert_keys_from_usage(_usage_masks(caches))
                        if not tiered.is_resident(k)]
                t = threading.Thread(target=commit, args=(cold,))
                t.start()
                t.join(0.5)
                commits.append((t, cold, t.is_alive()))
            return logits, caches

        monkeypatch.setattr(model, "prefill", hooked_prefill)
        out, stats = engine.generate(tokens, steps)
        (t, cold, blocked), = commits
        t.join(10.0)
        assert not t.is_alive()
    assert cold and blocked  # the commit waited for the run's miss check
    assert stats.prefill_retries >= 1
    assert tiered.stats.prefetch_waits >= 1  # the retry's ensure waited on those commits
    assert {e.key for e in tiered.stats.events if e.source == "prefetch"} == set(cold)
    np.testing.assert_array_equal(out, want)


def test_failed_fault_rolls_back_to_cold(reference, tmp_path):
    """A frame that does not decode raises a typed error naming the unit and
    leaves every claimed unit COLD (never stuck LOADING), so a retry works."""
    _, _, _, outdir = reference
    broken = tmp_path / "artifact"
    shutil.copytree(outdir, broken)
    model, result = _port_model()
    with cold_start(model, str(broken), result, device="cpu", compile_warm_set=False) as server:
        tiered = server.tiered
        keys = [u.key for u in result.plan.decisions["groups.u0.moe.w_up"].units[:3]]
        victim = tiered.store.entries[keys[1]]
        with open(broken / "optional.blob", "r+b") as f:
            f.seek(victim.offset)
            f.write(b"\xff" * 16)
        with pytest.raises(CorruptFrameError, match=keys[1]):
            tiered.ensure(keys)
        assert all(tiered.residency.state_of(k) == COLD for k in keys)
        assert not tiered.leaf("groups.u0.moe.w_up").any()
        tiered.ensure(keys[:1])
        assert tiered.is_resident(keys[0])


# RecurrentGemma at 5 layers: one (rec, rec, attn) group and a (rec, rec) tail
RG_ARCH, RG_LAYERS = "recurrentgemma-9b", 5


@pytest.fixture(scope="module")
def rg_reference(tmp_path_factory):
    """The reference's strict artifact of reduced RecurrentGemma (tier-1 empty)."""
    cfg = ref_get_reduced(RG_ARCH).replace(dtype="float32", num_layers=RG_LAYERS)
    model = ref_build_model(cfg)
    result = ref_analyze(model, RefProfile(**_strict(cfg)), trace_B=1, trace_S=32)
    params = model.init(jax.random.PRNGKey(1))
    outdir = str(tmp_path_factory.mktemp("ref_rg_artifact"))
    ref_build_artifact(params, result, outdir)
    return model, result, params, outdir


def _rg_port_model():
    cfg = get_reduced(RG_ARCH).replace(dtype="float32", num_layers=RG_LAYERS)
    model = build_model(cfg)
    return model, analyze(model, DeploymentProfile(**_strict(cfg)), trace_B=1, trace_S=32)


def test_port_serves_reference_recurrentgemma_artifact_identically(rg_reference):
    ref_model, ref_result, _, outdir = rg_reference
    B, S, steps = 2, 12, 6  # the prompt stays inside the 32-token local window
    tokens = np.random.default_rng(11).integers(0, ref_model.cfg.vocab_size, (B, S))
    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="strict",
                                compile_warm_set=False)
    ref_out, ref_stats = RefEngine(ref_server, max_seq=S + steps + 4).generate(
        jnp.asarray(tokens, jnp.int32), steps)
    ref_server.close()

    model, result = _rg_port_model()
    assert result.plan.summary() == ref_result.plan.summary()
    assert result.plan.summary()["units"] == 0
    launches = (fa_ops.flash_attention.launches, lru_ops.rglru_scan.launches)
    with cold_start(model, outdir, result, residency="strict", warm_shapes=((B, S),),
                    device="cpu") as server:
        assert server.report.bytes_read == ref_server.report.bytes_read == result.plan.tier0_bytes
        assert server.tiered.residency.budget_bytes == ref_server.tiered.residency.budget_bytes
        out, stats = GenerationEngine(server, max_seq=S + steps + 4).generate(torch.from_numpy(tokens), steps)
        np.testing.assert_array_equal(out, ref_out)
        assert _events(server.tiered.stats) == _events(ref_server.tiered.stats) == []
        assert stats.faulted_units == ref_stats.faulted_units == 0
        assert stats.faulted_bytes == ref_stats.faulted_bytes == 0
        assert (stats.prefill_retries, stats.decode_retries) == (0, 0)
        assert stats.prefill_runs == 1
    assert (fa_ops.flash_attention.launches, lru_ops.rglru_scan.launches) == launches  # CPU: plain only


def test_port_recurrentgemma_artifact_equals_reference(rg_reference, tmp_path):
    _, ref_result, ref_params, ref_dir = rg_reference
    model, result = _rg_port_model()
    params = params_from_numpy({p: np.asarray(v) for p, v in ref_flatten(ref_params)}, "cpu")
    meta = build_artifact(params, result, str(tmp_path))
    with open(os.path.join(ref_dir, "artifact.json")) as f:
        assert json.load(f) == meta
    assert meta["tier1_raw_bytes"] == meta["tier1_compressed_bytes"] == 0
    for name in ("artifact.json", "tier0.bin", "tier0.index.json", "optional.blob",
                 "optional.blob.manifest.json"):
        with open(os.path.join(ref_dir, name), "rb") as f1, open(tmp_path / name, "rb") as f2:
            assert f1.read() == f2.read(), name
    store = OptionalStore(str(tmp_path / "optional.blob"))
    try:
        assert store.entries == {} and store.raw_bytes == 0  # a store with no frames
    finally:
        store.close()


YI = "yi-34b"
# fine row groups, a 10% hot set: the first prefill leaves most of tier-1 cold
YI_PROFILE = dict(hot_vocab_fraction=0.1, min_tier1_bytes=1024, vocab_row_group=32)


@pytest.mark.parametrize("B,S,steps,seed", [(1, 4, 6, 3), (1, 6, 3, 8)])
def test_full_policy_with_cold_tier1_loads_the_reference_units(tmp_path, B, S, steps, seed):
    """Under full the prefetcher loads what the engine hints (the row
    groups of each step's top-k tokens) while the request thread faults the
    rows it embeds; once both drain, every unit either side touched is
    loaded once, so the multiset of loaded (key, bytes) is the reference's.
    Who loaded a unit (fault or prefetch) is a race and is not compared."""
    ref_model = ref_build_model(ref_get_reduced(YI).replace(dtype="float32"))
    ref_result = ref_analyze(ref_model, RefProfile(**YI_PROFILE), trace_B=1, trace_S=8)
    ref_build_artifact(ref_model.init(jax.random.PRNGKey(0)), ref_result, str(tmp_path))
    tokens = np.random.default_rng(seed).integers(0, ref_model.cfg.vocab_size, (B, S))
    ref_server = ref_cold_start(ref_model, str(tmp_path), ref_result, residency="full", compile_warm_set=False)
    try:
        ref_out, _ = RefEngine(ref_server, max_seq=S + steps + 4).generate(jnp.asarray(tokens, jnp.int32), steps)
        assert ref_server.prefetcher.drain(30.0)
        ref_loads = Counter((e.key, e.nbytes) for e in ref_server.tiered.stats.events)
    finally:
        ref_server.close()

    model = build_model(get_reduced(YI).replace(dtype="float32"))
    result = analyze(model, DeploymentProfile(**YI_PROFILE), trace_B=1, trace_S=8)
    with cold_start(model, str(tmp_path), result, residency="full", device="cpu",
                    warm_shapes=((B, S),)) as server:
        tiered = server.tiered
        out, stats = GenerationEngine(server, max_seq=S + steps + 4).generate(torch.from_numpy(tokens), steps)
        assert server.prefetcher.drain(30.0)
        np.testing.assert_array_equal(out, ref_out)
        assert Counter((e.key, e.nbytes) for e in tiered.stats.events) == ref_loads
        assert tiered.stats.evictions == 0 and tiered.residency.budget_bytes is None
        assert 0 < tiered.resident_fraction() < 1  # part of tier-1 is still cold
        assert server.prefetcher.stats.hints > 0 and stats.faulted_units > 0

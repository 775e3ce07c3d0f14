"""The PyTorch port's serving slice end to end against the JAX reference, on
reduced Mixtral and reduced RecurrentGemma at float32: under the strict and
full residency policies the port cold-starts an artifact the reference wrote
and produces the same greedy tokens, the same LoadEvent key/byte/source
sequence and the same faulted units (none for RecurrentGemma, whose tier-1
is empty); the stats policy, which needs the reference's prefetcher, is
refused; an artifact the port builds from the same weights equals the
reference's byte for byte."""

import json
import os
import shutil
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
from repro.models.zoo import build_model as ref_build_model
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import DeploymentProfile, analyze, build_artifact
from repro_torch.core.on_demand import COLD
from repro_torch.core.optional_store import CorruptFrameError, OptionalStore
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.models import build_model
from repro_torch.serving import MAX_FAULT_RETRIES, GenerationEngine, cold_start

ARCH = "mixtral-8x22b"


def _strict(cfg):
    return dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                vocab_row_group=max(64, cfg.vocab_size // 16))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's strict artifact of reduced Mixtral and its plan."""
    cfg = ref_get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)
    model = ref_build_model(cfg)
    result = ref_analyze(model, RefProfile(**_strict(cfg)), trace_B=1, trace_S=32)
    params = model.init(jax.random.PRNGKey(0))
    outdir = str(tmp_path_factory.mktemp("ref_artifact"))
    ref_build_artifact(params, result, outdir)
    return model, result, params, outdir


def _port_model():
    cfg = get_reduced(ARCH).replace(dtype="float32", collect_moe_usage=True)
    model = build_model(cfg)
    return model, analyze(model, DeploymentProfile(**_strict(cfg)), trace_B=1, trace_S=32)


def _events(stats):
    return [(e.key, e.nbytes, e.source, e.phase) for e in stats.events]


def _loads(stats):
    return [(e.key, e.nbytes, e.source) for e in stats.events]


@pytest.mark.parametrize("policy", ["strict", "full"])
@pytest.mark.parametrize("B,S,steps,seed", [(2, 8, 6, 7), (1, 24, 12, 3)])
def test_port_serves_reference_artifact_identically(reference, B, S, steps, seed, policy):
    """The reference runs each policy as it ships, prefetcher included
    (full turns it on); the port, which has none, must load the same units
    from the same sources."""
    ref_model, ref_result, _, outdir = reference
    tokens = np.random.default_rng(seed).integers(0, ref_model.cfg.vocab_size, (B, S))

    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency=policy,
                                compile_warm_set=False)
    ref_out, ref_stats = RefEngine(ref_server, max_seq=S + steps + 4).generate(
        jnp.asarray(tokens, jnp.int32), steps)
    ref_server.close()

    model, result = _port_model()
    launches = fa_ops.flash_attention.launches
    with cold_start(model, outdir, result, residency=policy, warm_shapes=((B, S),),
                    device="cpu") as server:
        assert server.report.bytes_read == ref_server.report.bytes_read
        out, stats = GenerationEngine(server, max_seq=S + steps + 4).generate(torch.from_numpy(tokens), steps)
        tiered, ref_tiered = server.tiered, ref_server.tiered

        np.testing.assert_array_equal(out, ref_out)
        assert Counter(_loads(tiered.stats)) == Counter(_loads(ref_tiered.stats))
        assert _events(tiered.stats) == _events(ref_tiered.stats)
        assert tiered.resident_keys == ref_tiered.resident_keys
        assert stats.faulted_units == ref_stats.faulted_units > 0
        assert stats.faulted_bytes == ref_stats.faulted_bytes
        assert (stats.prefill_retries, stats.decode_retries) == \
            (ref_stats.prefill_retries, ref_stats.decode_retries)
        assert stats.prefill_runs == 1 + stats.prefill_retries <= 1 + MAX_FAULT_RETRIES
        assert tiered.stats.evictions == ref_tiered.stats.evictions
        assert tiered.residency.overshoot_events == ref_tiered.residency.overshoot_events
        assert tiered.residency.budget_bytes == ref_tiered.residency.budget_bytes
    assert fa_ops.flash_attention.launches == launches  # CPU tensors: plain version only


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


def test_cold_start_rejects_unported_modes(reference):
    _, _, _, outdir = reference
    model, result = _port_model()
    with pytest.raises(ValueError, match="not ported"):
        cold_start(model, outdir, result, mode="before", device="cpu")
    with pytest.raises(ValueError, match="'stats' needs the prefetcher, which is not ported"):
        cold_start(model, outdir, result, residency="stats", device="cpu")
    with pytest.raises(ValueError, match="unknown residency"):
        cold_start(model, outdir, result, residency="bogus", device="cpu")


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

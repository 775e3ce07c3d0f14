"""Gemma-3's 5:1 local/global stack in the port against the JAX reference, on
the CPU at float32 with the reduced config (one unit of five local layers
with a 16-token window and one global layer, GQA 4/2 at head_dim 16, tied
embeddings) and reference weights:

  * the reference's strict artifact served with the same tokens, bytes read
    and no fault (tier-1 is empty), the decode crossing position 16 so the
    local layers' rolling caches wrap while the global layer's stays
    linear; an artifact the port writes from the same weights equals the
    reference's byte for byte;
  * a prompt longer than the rolling window: both packages refuse it, in
    the engine's prefill graft and in the scheduler's slot graft, and both
    serve a prompt exactly as long as the window (``ROADMAP.md`` Queue 3
    item 9: the reference's limit, kept by the port)."""

import json
import os

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
from repro.serving.scheduler import _graft_slot_cache as ref_graft_slots
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import DeploymentProfile, analyze, build_artifact
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import build_model
from repro_torch.serving import GenerationEngine, cold_start
from repro_torch.serving.engine import _strip_usage
from repro_torch.serving.scheduler import _graft_slot_cache
from repro_torch.utils.tree import flatten_with_paths

ARCH = "gemma3-27b"
WINDOW = 16  # reduced Gemma-3's local window


def _strict(cfg):
    return dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                vocab_row_group=max(64, cfg.vocab_size // 16))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's strict artifact of reduced Gemma-3, its plan and
    weights, and the port's model and plan."""
    model = ref_build_model(ref_get_reduced(ARCH).replace(dtype="float32"))
    result = ref_analyze(model, RefProfile(**_strict(model.cfg)), trace_B=1, trace_S=32)
    params = model.init(jax.random.PRNGKey(2))
    outdir = str(tmp_path_factory.mktemp("ref_gemma3"))
    ref_build_artifact(params, result, outdir)
    port = build_model(get_reduced(ARCH).replace(dtype="float32"))
    port_result = analyze(port, DeploymentProfile(**_strict(port.cfg)), trace_B=1, trace_S=32)
    return model, result, params, outdir, port, port_result


def _ref_generate(reference, tokens, steps):
    """(tokens, server) of the reference's strict server on its artifact."""
    ref_model, ref_result, _, outdir, _, _ = reference
    server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="strict",
                            compile_warm_set=False)
    try:
        out, _ = RefEngine(server, max_seq=tokens.shape[1] + steps + 4).generate(
            jnp.asarray(tokens, jnp.int32), steps)
    finally:
        server.close()
    return out, server


def _port_generate(reference, tokens, steps):
    """(tokens, server, RequestStats) of the port's strict server on the
    reference's artifact."""
    _, _, _, outdir, model, result = reference
    B, S = tokens.shape
    with cold_start(model, outdir, result, residency="strict", warm_shapes=((B, S),), device="cpu") as server:
        out, stats = GenerationEngine(server, max_seq=S + steps + 4).generate(torch.from_numpy(tokens), steps)
    return out, server, stats


@pytest.mark.parametrize("B,S,steps,seed", [(2, 12, 8, 11), (1, 5, 14, 4)])
def test_port_serves_reference_gemma3_artifact_identically(reference, B, S, steps, seed):
    _, ref_result, _, _, _, result = reference
    assert result.plan.summary() == ref_result.plan.summary()
    assert result.plan.summary()["units"] == 0  # tied embeddings, dense MLPs: nothing optional
    assert S + steps - 1 > WINDOW  # the decode writes past the window: the local caches wrap
    tokens = np.random.default_rng(seed).integers(0, 512, (B, S))
    launches = fa_ops.flash_attention.launches
    ref_out, ref_server = _ref_generate(reference, tokens, steps)
    out, server, stats = _port_generate(reference, tokens, steps)
    np.testing.assert_array_equal(out, ref_out)
    assert server.report.bytes_read == ref_server.report.bytes_read == result.plan.tier0_bytes
    assert stats.faulted_units == 0 and stats.prefill_runs == 1
    assert list(server.tiered.stats.events) == list(ref_server.tiered.stats.events) == []
    assert fa_ops.flash_attention.launches == launches  # CPU tensors: the plain version only


def test_port_gemma3_artifact_equals_reference(reference, tmp_path):
    _, _, ref_params, ref_dir, _, result = reference
    params = params_from_numpy({p: np.asarray(v) for p, v in ref_flatten(ref_params)}, "cpu")
    meta = build_artifact(params, result, str(tmp_path))
    with open(os.path.join(ref_dir, "artifact.json")) as f:
        assert json.load(f) == meta
    assert meta["tier1_raw_bytes"] == 0
    for name in ("artifact.json", "tier0.bin", "tier0.index.json", "optional.blob",
                 "optional.blob.manifest.json"):
        with open(os.path.join(ref_dir, name), "rb") as f1, open(tmp_path / name, "rb") as f2:
            assert f1.read() == f2.read(), name


def test_prompt_longer_than_the_window_is_refused_by_both(reference):
    """A prompt of exactly the window serves in both packages with the same
    tokens; one of 24 tokens raises ValueError in both engines' prefill
    graft, and in both schedulers' slot graft."""
    ref_model, _, ref_params, _, model, _ = reference
    tokens = np.random.default_rng(5).integers(0, 512, (2, WINDOW))
    np.testing.assert_array_equal(_port_generate(reference, tokens, 4)[0], _ref_generate(reference, tokens, 4)[0])

    long = np.random.default_rng(6).integers(0, 512, (2, 24))
    with pytest.raises(ValueError):
        _ref_generate(reference, long, 4)
    with pytest.raises(ValueError, match="longer than a rolling window"):
        _port_generate(reference, long, 4)

    # the scheduler's slot graft: a 24-token prefill into 32-token slot caches
    params = params_from_numpy({p: np.asarray(v) for p, v in ref_flatten(ref_params)}, "cpu")
    _, small = model.prefill(params, {"tokens": torch.from_numpy(long[:1])})
    small = _strip_usage(small)
    big = model.init_cache(3, 32, multimodal=False, device="cpu")
    assert dict(flatten_with_paths(big))["groups.u0.k"].shape[2] == WINDOW
    with pytest.raises(ValueError, match="longer than a rolling window"):
        _graft_slot_cache(big, small, [1])
    ref_small = jax.tree.map(lambda t: jnp.asarray(t.numpy()), small)
    ref_big = ref_model.init_cache(3, 32, multimodal=False)
    with pytest.raises(ValueError):
        ref_graft_slots(ref_big, ref_small, jnp.asarray([1], jnp.int32))

"""Whisper's encoder-decoder in the port against the JAX reference, on the CPU
at float32 with the reduced config (2 decoder and 2 encoder layers, d_model
64, 4 heads of 16, tied 512-row table) and reference weights:

  * the encoder alone (sinusoidal positions, non-causal self-attention with
    RoPE, SwiGLU; plain attention, no kernel launch), the multimodal prefill
    with audio frames (logits and caches, the decoder's cross ``xk`` / ``xv``
    included) and decode over those caches (the cross memory padded to
    1500 frames, as the reference's audio caches are), within 256 eps;
  * entry recognition under the text-only and the multimodal serving
    profiles, the reference's reachability assertions (decode never reaches
    the encoder, nor the cross-attention's K/V projections), and both
    profiles' plans (text-only: the encoder and the decoder's cross-attention
    tier-1, 460,544 B in 15 leaves);
  * text-only serving of the reference's strict artifact through
    ``cold_start`` + ``GenerationEngine`` and through the scheduler: the
    reference's tokens and loads (none: nothing a text request reads is
    tier-1); an artifact the port writes equals the reference's.
  * the port's launcher serves the reduced config (its text-only entries)
    in every cold-start mode and residency policy with the same tokens."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.core import SERVING_MULTIMODAL_PROFILE as REF_MULTIMODAL
from repro.core import SERVING_PROFILE as REF_SERVING
from repro.core import DeploymentProfile as RefProfile
from repro.core import analyze as ref_analyze
from repro.core import build_artifact as ref_build_artifact
from repro.core import build_reachability as ref_build_reachability
from repro.core import recognize_entries as ref_recognize
from repro.models import transformer as ref_tf
from repro.models.zoo import WHISPER_DECODE_ENC_LEN as REF_ENC_LEN
from repro.models.zoo import build_model as ref_build_model
from repro.serving import ContinuousBatchingScheduler as RefScheduler
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro.serving.engine import _graft_prefill_cache as ref_graft
from repro.serving.engine import _strip_usage as ref_strip
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import (
    SERVING_MULTIMODAL_PROFILE,
    SERVING_PROFILE,
    DeploymentProfile,
    analyze,
    build_artifact,
    recognize_entries,
)
from repro_torch.core.param_graph import build_reachability
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.models.zoo import WHISPER_DECODE_ENC_LEN
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine, cold_start
from repro_torch.serving.engine import _graft_prefill_cache, _strip_usage
from repro_torch.utils.tree import flatten_with_paths

ARCH = "whisper-base"
# fp32 tolerance of tests/test_torch_models.py: the two frameworks' reduction
# orders differ by O(10) ulps of O(1) values; 256 eps keeps a >10x margin
TOL = 256 * float(np.finfo(np.float32).eps)
MAX_SEQ = 16


def _strict(cfg):
    return dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                vocab_row_group=max(64, cfg.vocab_size // 16))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's reduced Whisper at fp32: its strict artifact and plan,
    its params, and the port's model, plan and params (the same leaves)."""
    model = ref_build_model(ref_get_reduced(ARCH).replace(dtype="float32"))
    params = model.init(jax.random.PRNGKey(1))
    result = ref_analyze(model, RefProfile(**_strict(model.cfg)), trace_B=1, trace_S=32)
    outdir = str(tmp_path_factory.mktemp("ref_whisper"))
    ref_build_artifact(params, result, outdir)
    port = build_model(get_reduced(ARCH).replace(dtype="float32"))
    port_result = analyze(port, DeploymentProfile(**_strict(port.cfg)), trace_B=1, trace_S=32)
    flat = {p: np.asarray(v) for p, v in ref_flatten(params)}
    return model, result, params, outdir, port, port_result, params_from_numpy(flat, "cpu")


def _batch(cfg, B, S, seed):
    rs = np.random.default_rng(seed)
    return {"tokens": rs.integers(0, cfg.vocab_size, (B, S)),
            "frames": rs.standard_normal((B, S, cfg.d_model), dtype=np.float32)}


def _assert_trees_match(ref_tree, port_tree):
    ref_flat, port_flat = dict(ref_flatten(ref_tree)), dict(flatten_with_paths(port_tree))
    assert list(ref_flat) == list(port_flat)
    for path, ref in ref_flat.items():
        np.testing.assert_allclose(port_flat[path].numpy(), np.asarray(ref), atol=TOL, rtol=TOL, err_msg=path)


def test_encoder_matches_reference(reference):
    ref_model, _, ref_params, _, port, _, params = reference
    frames = np.random.default_rng(4).standard_normal((2, 12, port.cfg.d_model), dtype=np.float32)
    want = ref_tf._encode(ref_model.cfg, ref_params, jnp.asarray(frames))
    launches = fa_ops.flash_attention.launches
    got = tf._encode(port.cfg, params, torch.from_numpy(frames))
    assert fa_ops.flash_attention.launches == launches  # plain on every device, as the reference's
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_multimodal_prefill_and_decode_match_reference(reference):
    """Prefill with audio frames: logits and every cache within 256 eps of the
    reference's; decode steps over the audio caches (cross memory padded to
    WHISPER_DECODE_ENC_LEN frames, as both packages' graft writes it), each
    within 256 eps, the cross caches read and left as they were."""
    ref_model, _, ref_params, _, port, _, params = reference
    assert WHISPER_DECODE_ENC_LEN == REF_ENC_LEN
    B, S, steps = 2, 10, 4
    batch = _batch(port.cfg, B, S, seed=12)
    ref_logits, ref_caches = jax.jit(ref_model.prefill)(
        ref_params, {"tokens": jnp.asarray(batch["tokens"], jnp.int32), "frames": jnp.asarray(batch["frames"])})
    logits, caches = port.prefill(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=TOL, rtol=TOL)
    _assert_trees_match(ref_caches, caches)
    assert set(caches["groups"]["u0"]) == {"k", "v", "xk", "xv"}

    ref_caches = ref_graft(ref_model.init_cache(B, MAX_SEQ, multimodal=True), ref_strip(ref_caches))
    caches = _graft_prefill_cache(port.init_cache(B, MAX_SEQ, multimodal=True, device="cpu"), _strip_usage(caches))
    assert caches["groups"]["u0"]["xk"].shape[2] == WHISPER_DECODE_ENC_LEN
    xv = caches["groups"]["u0"]["xv"].clone()
    ref_decode = jax.jit(ref_model.decode_step)
    tok = np.argmax(np.asarray(ref_logits), -1)
    for step in range(steps):
        ref_logits, ref_caches = ref_decode(ref_params, ref_caches, {
            "tokens": jnp.asarray(tok[:, None], jnp.int32), "pos": jnp.full((B,), S + step, jnp.int32)})
        logits, caches = port.decode_step(params, caches, {
            "tokens": torch.from_numpy(tok[:, None]), "pos": torch.full((B,), S + step)})
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=TOL, rtol=TOL)
        _assert_trees_match(ref_caches, caches)
        tok = np.argmax(np.asarray(ref_logits), -1)
    assert torch.equal(caches["groups"]["u0"]["xv"], xv)


def test_entries_and_reachability_match_reference(reference):
    """Entries in the reference's order under both profiles; the text-only
    prefill's batch has no frames; the reference's assertions: decode never
    reaches the encoder and the audio prefill does, decode never reaches the
    cross-attention's K/V projections (it reads the cached xk / xv), and no
    text-only entry reaches the encoder or the cross-attention; every leaf's
    reaching entries equal the reference's, its training entries included."""
    ref_model, _, _, _, port, _, _ = reference
    assert [e.name for e in port.entries(B=1, S=8)] == [e.name for e in ref_model.entries(B=1, S=8)]
    for mine, ref in ((SERVING_PROFILE, REF_SERVING), (SERVING_MULTIMODAL_PROFILE, REF_MULTIMODAL)):
        assert [e.name for e in recognize_entries(port, mine, B=1, S=8)] == \
            [e.name for e in ref_recognize(ref_model, ref, B=1, S=8)]
    by_name = {e.name: e for e in port.entries(B=1, S=8)}
    assert set(by_name["prefill"].args[0]) == {"tokens", "frames"}
    assert set(by_name["prefill_text_only"].args[0]) == {"tokens"}
    assert "xk" not in by_name["decode_step_text_only"].args[0]["groups"]["u0"]

    rep = build_reachability(port.entries(B=1, S=8), port.abstract())
    ref_rep = ref_build_reachability(ref_model.entries(B=1, S=8), ref_model.abstract())
    assert rep.reachable == ref_rep.reachable
    for p, entries in rep.reachable.items():
        if p.startswith("encoder"):
            assert "decode_step" not in entries and "prefill" in entries, p
        elif p == "embed":
            assert "decode_step" in entries
        if p.startswith("encoder") or ".cross." in p or ".norm_x" in p:
            assert not any(e.endswith("_text_only") for e in entries), (p, entries)
        if ".cross.wk" in p or ".cross.wv" in p:  # only the audio prefill and the audio train step
            assert entries == {"prefill", "train_step"}, p


@pytest.mark.parametrize("profile", ["text", "multimodal"])
def test_plan_matches_reference_under_both_profiles(reference, profile):
    """Strict sizing under the text-only profile (the encoder and the
    decoder's cross-attention tier-1: 460,544 B in 15 leaves) and the
    multimodal one (everything reached, all tier-0)."""
    ref_model, _, _, _, port, _, _ = reference
    kw = _strict(port.cfg)
    if profile == "multimodal":
        kw["modalities"] = ("text", "image", "audio")
    ref = ref_analyze(ref_model, RefProfile(**kw), trace_B=1, trace_S=32)
    mine = analyze(port, DeploymentProfile(**kw), trace_B=1, trace_S=32)
    assert mine.summary() == ref.summary()
    assert {p: (d.tier, d.reason, [u.key for u in d.units]) for p, d in mine.plan.decisions.items()} == \
        {p: (d.tier, d.reason, [u.key for u in d.units]) for p, d in ref.plan.decisions.items()}
    tier1 = {p for p, d in mine.plan.decisions.items() if d.tier == 1}
    if profile == "text":
        assert (mine.plan.tier1_bytes, len(tier1)) == (460_544, 15)
        assert tier1 == {p for p in mine.plan.decisions if p.startswith("encoder.") or ".cross." in p
                         or p.endswith(".norm_x")}
    else:
        assert tier1 == set()


@pytest.mark.parametrize("policy", ["strict", "full"])
@pytest.mark.parametrize("B,S,steps,seed", [(2, 8, 5, 7), (1, 11, 3, 3)])
def test_port_serves_reference_whisper_artifact_text_only(reference, B, S, steps, seed, policy):
    """The reference's strict artifact served text-only by both packages: the
    same tokens, bytes read and (no) loads; the server's entries take no
    frames and its caches no cross K/V."""
    ref_model, ref_result, _, outdir, model, result, _ = reference
    tokens = np.random.default_rng(seed).integers(0, model.cfg.vocab_size, (B, S))
    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency=policy,
                                compile_warm_set=False)
    ref_out, ref_stats = RefEngine(ref_server, max_seq=S + steps + 4).generate(jnp.asarray(tokens, jnp.int32), steps)
    ref_server.close()
    with cold_start(model, outdir, result, residency=policy, warm_shapes=((B, S, S + steps + 4),),
                    device="cpu") as server:
        assert server.report.bytes_read == ref_server.report.bytes_read
        out, stats = GenerationEngine(server, max_seq=S + steps + 4).generate(torch.from_numpy(tokens), steps)
        assert set(server.compiled_prefill(B, S)._batch) == {"tokens"}
        assert set(server.compiled_decode(B, S + steps + 4).caches["groups"]["u0"]) == {"k", "v"}
        np.testing.assert_array_equal(out, ref_out)
        assert (stats.faulted_units, stats.faulted_bytes) == (ref_stats.faulted_units, ref_stats.faulted_bytes) \
            == (0, 0)
        assert server.tiered.stats.events == [] and ref_server.tiered.stats.events == []


def test_port_whisper_artifact_equals_reference(reference, tmp_path):
    _, _, _, ref_dir, _, result, params = reference
    meta = build_artifact(params, result, str(tmp_path))
    with open(os.path.join(ref_dir, "artifact.json")) as f:
        assert json.load(f) == meta
    for name in ("artifact.json", "tier0.bin", "tier0.index.json", "optional.blob",
                 "optional.blob.manifest.json"):
        with open(os.path.join(ref_dir, name), "rb") as f1, open(tmp_path / name, "rb") as f2:
            assert f1.read() == f2.read(), name


def _drive(sched, vocab: int) -> list:
    """Four requests, then three more after two loop steps; (14, 4) is over-length."""
    script = [(6, 5), (9, 3), (6, 6), (14, 4), (4, 2), (9, 4), (12, 3)]
    prompts = [np.random.default_rng(30 + i).integers(0, vocab, S).astype(np.int32) for i, (S, _) in enumerate(script)]
    reqs = [sched.submit(p, n) for p, (_, n) in zip(prompts[:4], script[:4])]
    sched.run(max_steps=2)
    reqs += [sched.submit(p, n) for p, (_, n) in zip(prompts[4:], script[4:])]
    sched.run()
    return reqs


def test_whisper_scheduler_matches_reference(reference):
    """One arrival script through both schedulers under strict (3 slots):
    the same tokens, errors and scheduler counts, and no load."""
    ref_model, ref_result, _, outdir, model, result, _ = reference
    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="strict",
                                compile_warm_set=False)
    ref_sched = RefScheduler(RefEngine(ref_server, max_seq=MAX_SEQ), max_batch=3)
    ref_reqs = _drive(ref_sched, model.cfg.vocab_size)
    ref_server.close()
    with cold_start(model, outdir, result, residency="strict", compile_warm_set=False, device="cpu") as server:
        sched = ContinuousBatchingScheduler(GenerationEngine(server, max_seq=MAX_SEQ), max_batch=3)
        reqs = _drive(sched, model.cfg.vocab_size)
        assert server.tiered.stats.events == []
    assert sched.stats.rejected == 1 and sched.stats.completed == len(reqs) - 1
    for r, ref in zip(reqs, ref_reqs):
        assert r.done and r.error == ref.error
        np.testing.assert_array_equal(r.output, ref.output)
    fields = ("admitted", "completed", "rejected", "steps", "max_active", "kv_tokens_dense")
    assert [getattr(sched.stats, f) for f in fields] == [getattr(ref_sched.stats, f) for f in fields]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(tmp, *extra) -> list:
    """The port's launcher on the reduced config (B=2 × 8 + 4, the CPU);
    returns its tokens."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--reduced",
                          "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen-steps", "4",
                          "--artifact-dir", str(tmp), *extra], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    plan = json.loads(re.search(r"^\[serve\] plan: (.*)$", res.stdout, re.M).group(1))
    assert plan["entries"] == ["prefill_text_only", "decode_step_text_only"]
    return json.loads(re.search(r"^\[serve\] tokens: (.*)$", res.stdout, re.M).group(1))


@pytest.fixture(scope="module")
def launcher_tokens(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("launch_after2"))


@pytest.mark.parametrize("extra", [["--mode", "before"], ["--mode", "after1"], ["--policy", "strict"],
                                   ["--policy", "full"]])
def test_launcher_serves_every_mode_and_policy(tmp_path, launcher_tokens, extra):
    """The launcher serves the text-only entries in every cold-start mode and
    residency policy with the same tokens (same seeded weights and prompt)."""
    assert _launch(tmp_path, *extra) == launcher_tokens

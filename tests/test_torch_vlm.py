"""Llama-3.2-Vision's gated image cross-attention in the port against the JAX
reference, on the CPU at float32 with the reduced config (one unit of four
self layers and one gated cross layer, GQA 4/2 at head_dim 16, 16 image
tokens of width 48) and reference weights whose two gates are set nonzero
(they start at zero, which would make every multimodal comparison pass
whatever the cross path computes):

  * ``cross_attn_spec`` / ``cross_attn_memory`` / ``cross_attn_forward``
    alone, and the multimodal prefill (logits and caches, the cross block's
    ``xk`` / ``xv`` included) and decode over those caches, within 256 eps;
    the decode reads the cross caches and never writes them; with the gates
    at zero the text-only logits equal the multimodal ones;
  * entry recognition under the text-only and the multimodal serving
    profiles (the ``_text_only`` twins, in the reference's order), the
    reference's reachability assertions, and both profiles' plans;
  * text-only serving of the reference's strict artifact through
    ``cold_start`` + ``GenerationEngine``: the reference's tokens and
    LoadEvent sequence, and no unit of the cross block faulted; through the
    scheduler, the reference engine's tokens for every request (the
    reference's own scheduler fails on this config); an artifact the port
    writes equals the reference's.
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
from repro.models import attention as ref_attn
from repro.models.zoo import build_model as ref_build_model
from repro.serving import ContinuousBatchingScheduler as RefScheduler
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro.serving.engine import _graft_prefill_cache as ref_graft
from repro.serving.engine import _strip_usage as ref_strip
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro.utils.tree import tree_from_flat as ref_tree_from_flat
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
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine, cold_start
from repro_torch.serving.engine import _graft_prefill_cache, _strip_usage
from repro_torch.utils.tree import flatten_with_paths

ARCH = "llama-3.2-vision-90b"
# fp32 tolerance of tests/test_torch_models.py: the two frameworks' reduction
# orders differ by O(10) ulps of O(1) values; 256 eps keeps a >10x margin
TOL = 256 * float(np.finfo(np.float32).eps)
GATE, GATE_FFN = 0.8, -0.6  # tanh ≈ 0.66 and -0.54: the cross block's output counts
MAX_SEQ = 16


def _strict(cfg):
    return dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                vocab_row_group=max(64, cfg.vocab_size // 16))


def _with_gates(flat: dict, gate: float, gate_ffn: float) -> dict:
    out = dict(flat)
    for p in out:
        if p.endswith(".cross.gate"):
            out[p] = np.full_like(out[p], gate)
        elif p.endswith(".gate_ffn"):
            out[p] = np.full_like(out[p], gate_ffn)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's reduced VLM at fp32 with nonzero gates: its strict
    artifact and plan, its params and their numpy leaves, and the port's
    model, plan and params (the same leaves)."""
    model = ref_build_model(ref_get_reduced(ARCH).replace(dtype="float32"))
    flat = _with_gates({p: np.asarray(v) for p, v in ref_flatten(model.init(jax.random.PRNGKey(0)))},
                       GATE, GATE_FFN)
    params = ref_tree_from_flat({p: jnp.asarray(v) for p, v in flat.items()})
    result = ref_analyze(model, RefProfile(**_strict(model.cfg)), trace_B=1, trace_S=32)
    outdir = str(tmp_path_factory.mktemp("ref_vlm"))
    ref_build_artifact(params, result, outdir)
    port = build_model(get_reduced(ARCH).replace(dtype="float32"))
    port_result = analyze(port, DeploymentProfile(**_strict(port.cfg)), trace_B=1, trace_S=32)
    return model, result, params, flat, outdir, port, port_result, params_from_numpy(flat, "cpu")


def _batch(cfg, B, S, seed):
    rs = np.random.default_rng(seed)
    return {"tokens": rs.integers(0, cfg.vocab_size, (B, S)),
            "image_embeds": rs.standard_normal((B, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim), dtype=np.float32)}


def _ref_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32) for k, v in batch.items()}


def _assert_trees_match(ref_tree, port_tree):
    ref_flat, port_flat = dict(ref_flatten(ref_tree)), dict(flatten_with_paths(port_tree))
    assert list(ref_flat) == list(port_flat)
    for path, ref in ref_flat.items():
        np.testing.assert_allclose(port_flat[path].numpy(), np.asarray(ref), atol=TOL, rtol=TOL, err_msg=path)


def test_cross_attention_matches_reference(reference):
    """The gated cross-attention alone: spec (paths, shapes, access, init),
    the projected image memory and the gated output, with the plain
    attention on every device (no kernel launch)."""
    ref_model, _, ref_params, _, _, port, _, params = reference
    cfg, ref_cfg = port.cfg, ref_model.cfg
    args = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.vlm.vision_dim)
    mine, ref = attn.cross_attn_spec(*args), ref_attn.cross_attn_spec(*args)
    assert {k: (s.shape, s.axes, s.init, s.access) for k, s in mine.items()} == \
        {k: (s.shape, s.axes, s.init, s.access) for k, s in ref.items()}
    ref_p = {k: v[0] for k, v in ref_params["groups"]["u4"]["cross"].items()}
    p = {k: v[0] for k, v in params["groups"]["u4"]["cross"].items()}
    rs = np.random.default_rng(5)
    x = rs.standard_normal((2, 7, cfg.d_model), dtype=np.float32)
    mem = rs.standard_normal((2, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim), dtype=np.float32)
    ref_kv = ref_attn.cross_attn_memory(ref_p, jnp.asarray(mem), ref_cfg)
    launches = fa_ops.flash_attention.launches
    kv = attn.cross_attn_memory(p, torch.from_numpy(mem), cfg)
    for gated in (False, True):
        ref_out = ref_attn.cross_attn_forward(ref_p, jnp.asarray(x), ref_kv, ref_cfg, gated=gated)
        out = attn.cross_attn_forward(p, torch.from_numpy(x), kv, cfg, gated=gated)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=TOL, rtol=TOL)
    assert fa_ops.flash_attention.launches == launches
    for got, want in zip(kv, ref_kv):
        assert got.shape == (2, cfg.vlm.num_image_tokens, cfg.num_kv_heads, cfg.resolved_head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_multimodal_prefill_and_decode_match_reference(reference):
    """Prefill with image embeddings: logits and every cache (the cross
    block's ``xk`` / ``xv`` too) within 256 eps of the reference's; then
    decode steps over the multimodal caches, each within 256 eps, the cross
    caches read and left as they were."""
    ref_model, _, ref_params, _, _, port, _, params = reference
    B, S, steps = 2, 9, 4
    batch = _batch(port.cfg, B, S, seed=11)
    ref_logits, ref_caches = jax.jit(ref_model.prefill)(ref_params, _ref_batch(batch))
    logits, caches = port.prefill(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=TOL, rtol=TOL)
    _assert_trees_match(ref_caches, caches)
    assert set(caches["groups"]["u4"]) == {"xk", "xv"}

    ref_caches = ref_graft(ref_model.init_cache(B, MAX_SEQ, multimodal=True), ref_strip(ref_caches))
    caches = _graft_prefill_cache(port.init_cache(B, MAX_SEQ, multimodal=True, device="cpu"), _strip_usage(caches))
    xk = caches["groups"]["u4"]["xk"].clone()
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
    assert torch.equal(caches["groups"]["u4"]["xk"], xk)


@pytest.mark.parametrize("with_gates", [False, True], ids=["zero_gates", "nonzero_gates"])
def test_text_only_matches_zero_image(reference, with_gates):
    """The reference's ``test_vlm_text_only_matches_zero_image`` on the port:
    with both gates at zero (their init) the image changes no logit, so the
    text-only prefill equals the multimodal one exactly; with the gates set
    it differs (the image path counts)."""
    _, _, _, flat, _, port, _, _ = reference
    params = params_from_numpy(_with_gates(flat, GATE, GATE_FFN) if with_gates else _with_gates(flat, 0.0, 0.0),
                               "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(port.cfg, 2, 8, seed=3).items()}
    logits_mm, _ = port.prefill(params, batch)
    logits_txt, caches = port.prefill(params, {"tokens": batch["tokens"]})
    assert caches["groups"]["u4"] == {}
    if with_gates:
        assert (logits_mm - logits_txt).abs().max().item() > 1e-3
    else:
        torch.testing.assert_close(logits_mm, logits_txt, rtol=0, atol=0)


def test_entries_and_reachability_match_reference(reference):
    """Entries in the reference's order, both profiles; the reference's three
    reachability assertions (tests/test_core_analyzer.py) on the port's
    traced graphs, and every leaf's reaching entries equal to the
    reference's, its training entries included."""
    ref_model, _, _, _, _, port, _, _ = reference
    assert [e.name for e in port.entries(B=1, S=8)] == [e.name for e in ref_model.entries(B=1, S=8)]
    for mm in (True, False):  # the port registers both; split them by the twins' suffix
        assert [e.name for e in port.entries(B=1, S=8) if e.name.endswith("_text_only") != mm] == \
            [e.name for e in ref_model.entries(B=1, S=8, multimodal=mm)]
    for mine, ref in ((SERVING_PROFILE, REF_SERVING), (SERVING_MULTIMODAL_PROFILE, REF_MULTIMODAL)):
        assert [e.name for e in recognize_entries(port, mine, B=1, S=8)] == \
            [e.name for e in ref_recognize(ref_model, ref, B=1, S=8)]
    assert [e.name for e in recognize_entries(port, SERVING_PROFILE)] == ["prefill_text_only",
                                                                          "decode_step_text_only"]

    rep = build_reachability(port.entries(B=1, S=8), port.abstract())
    ref_rep = ref_build_reachability(ref_model.entries(B=1, S=8), ref_model.abstract())
    assert rep.reachable == ref_rep.reachable
    cross = [p for p in rep.reachable if ".cross." in p]
    assert cross
    for p in cross:  # text-only never reaches the image block
        assert not any(e.endswith("_text_only") for e in rep.reachable[p]), p
    wk = [p for p in rep.reachable if ".cross.wk" in p or ".cross.wv" in p]
    assert wk
    for p in wk:  # decode reads the cached xk / xv: wk and wv are dead even for multimodal decode
        assert "decode_step" not in rep.reachable[p] and "prefill" in rep.reachable[p]
    text_only = build_reachability([e for e in port.entries(B=1, S=8) if e.name == "prefill_text_only"],
                                   port.abstract())
    assert any(".cross." in p for p in text_only.statically_optional)


@pytest.mark.parametrize("profile", ["text", "multimodal"])
def test_plan_matches_reference_under_both_profiles(reference, profile):
    """Strict sizing under the text-only profile (the cross block and the
    vocab row groups tier-1: 274,952 B in 12 leaves) and the multimodal one
    (the image leaves served hot, tier-0)."""
    ref_model, _, _, _, _, port, _, _ = reference
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
        assert (mine.plan.tier1_bytes, len(tier1), mine.summary()["units"]) == (274_952, 12, 19)
        assert tier1 == {"embed"} | {p for p in mine.plan.decisions if p.startswith("groups.u4.")}
    else:
        assert tier1 == {"embed"}


def _events(stats):
    return [(e.key, e.nbytes, e.source, e.phase) for e in stats.events]


@pytest.mark.parametrize("B,S,steps,seed", [(2, 8, 5, 7), (1, 11, 3, 3)])
def test_port_serves_reference_vlm_artifact_text_only(reference, B, S, steps, seed):
    """The reference's strict artifact served text-only by both packages: the
    same tokens, faulted units and bytes, the same LoadEvent sequence; the
    caches the server built carry no cross K/V; no unit of the cross block
    (the ``groups.u4.*`` leaves) faults."""
    ref_model, ref_result, _, _, outdir, model, result, _ = reference
    tokens = np.random.default_rng(seed).integers(0, model.cfg.vocab_size, (B, S))
    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="strict",
                                compile_warm_set=False)
    ref_out, ref_stats = RefEngine(ref_server, max_seq=S + steps + 4).generate(jnp.asarray(tokens, jnp.int32), steps)
    ref_server.close()
    assert result.plan.summary() == ref_result.plan.summary()
    with cold_start(model, outdir, result, residency="strict", warm_shapes=((B, S, S + steps + 4),),
                    device="cpu") as server:
        out, stats = GenerationEngine(server, max_seq=S + steps + 4).generate(torch.from_numpy(tokens), steps)
        assert server.compiled_decode(B, S + steps + 4).caches["groups"]["u4"] == {}
        assert set(server.compiled_prefill(B, S)._batch) == {"tokens"}
        np.testing.assert_array_equal(out, ref_out)
        assert _events(server.tiered.stats) == _events(ref_server.tiered.stats)
        assert (stats.faulted_units, stats.faulted_bytes) == (ref_stats.faulted_units, ref_stats.faulted_bytes)
        assert stats.faulted_units > 0
        assert all(e.key.startswith("embed#") for e in server.tiered.stats.events)


def test_port_vlm_artifact_equals_reference(reference, tmp_path):
    _, _, _, _, ref_dir, _, result, params = reference
    meta = build_artifact(params, result, str(tmp_path))
    with open(os.path.join(ref_dir, "artifact.json")) as f:
        assert json.load(f) == meta
    for name in ("artifact.json", "tier0.bin", "tier0.index.json", "optional.blob",
                 "optional.blob.manifest.json"):
        with open(os.path.join(ref_dir, name), "rb") as f1, open(tmp_path / name, "rb") as f2:
            assert f1.read() == f2.read(), name


def _drive(sched, vocab: int) -> tuple[list, list]:
    """Four requests, then three more after two loop steps; (14, 4) is
    over-length. Returns the requests and their (prompt, steps)."""
    script = [(6, 5), (9, 3), (6, 6), (14, 4), (4, 2), (9, 4), (12, 3)]
    prompts = [np.random.default_rng(20 + i).integers(0, vocab, S).astype(np.int32) for i, (S, _) in enumerate(script)]
    reqs = [sched.submit(p, n) for p, (_, n) in zip(prompts[:4], script[:4])]
    sched.run(max_steps=2)
    reqs += [sched.submit(p, n) for p, (_, n) in zip(prompts[4:], script[4:])]
    sched.run()
    return reqs, [(p, n) for p, (_, n) in zip(prompts, script)]


def test_vlm_scheduler_serves_the_reference_engines_tokens(reference):
    """One arrival script through the port's scheduler under strict (3
    slots): every request but the over-length one gives the tokens of the
    reference engine's own ``generate()`` of it, and no unit of the cross
    block faults. The reference's scheduler cannot serve this config
    (ROADMAP.md Queue 3 item 11): its slot graft rebuilds the caches from
    their flat paths, which drops the cross block's empty cache, so each
    request fails at its first decode step with ``KeyError('u4')``."""
    ref_model, ref_result, _, _, outdir, model, result, _ = reference
    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="strict",
                                compile_warm_set=False)
    try:
        ref_reqs, script = _drive(RefScheduler(RefEngine(ref_server, max_seq=MAX_SEQ), max_batch=3),
                                  model.cfg.vocab_size)
        assert {r.error for r in ref_reqs} == {"decode step failed: KeyError('u4')",
                                              "rejected: prompt 14 + 4 steps exceeds max_seq=16 (or is empty)"}
        engine = RefEngine(ref_server, max_seq=MAX_SEQ)
        want = [np.asarray(engine.generate(jnp.asarray(p[None]), n)[0])[0] if S + n <= MAX_SEQ else None
                for p, n in script for S in (len(p),)]
    finally:
        ref_server.close()
    with cold_start(model, outdir, result, residency="strict", compile_warm_set=False, device="cpu") as server:
        reqs, _ = _drive(ContinuousBatchingScheduler(GenerationEngine(server, max_seq=MAX_SEQ), max_batch=3),
                         model.cfg.vocab_size)
        keys = {e.key for e in server.tiered.stats.events}
    assert keys and all(k.startswith("embed#") for k in keys)
    assert [r.error is None for r in reqs] == [w is not None for w in want]
    for r, w in zip(reqs, want):
        assert r.done
        if w is not None:
            np.testing.assert_array_equal(r.output, w)


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

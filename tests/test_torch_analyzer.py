"""Program Analyzer parity of the PyTorch port: the tier plan (tier,
granularity, reason, bytes, unit keys, resident units) equals the JAX
reference's for the serve launcher's strict / stats / full profiles (reduced
configs, and Gemma-3, DeepSeek-V2-Lite, Whisper and Llama-3.2-Vision at full
width, cut in depth where the card needs it), and the traced reachability
equals the jaxpr liveness leaf for leaf."""

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.core import DeploymentProfile as RefProfile
from repro.core import analyze as ref_analyze
from repro.data import DataConfig, SyntheticTokenPipeline
from repro.models.zoo import build_model as ref_build_model
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import DeploymentProfile, analyze
from repro_torch.core.param_graph import live_placeholders
from repro_torch.models import build_model


def _profiles(cfg):
    """(profile kwargs, hot-unit stats) per policy, as the serve launcher builds them."""
    row_group = max(64, cfg.vocab_size // 16)
    pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 128, 8))
    return {
        "strict": (dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                        vocab_row_group=row_group), None),
        "full": (dict(resident_experts=-1, hot_vocab_fraction=1.0), None),
        "stats": (dict(resident_experts=1, hot_vocab_fraction=0.25, min_tier1_bytes=1 << 14,
                       vocab_row_group=row_group), pipe.vocab_row_stats(row_group=row_group)),
    }


def _decisions(plan):
    return {
        p: (d.tier, d.granularity, d.reason, d.nbytes, [(u.key, u.sel, u.rows, u.nbytes) for u in d.units],
            list(d.resident_units))
        for p, d in plan.decisions.items()
    }


@pytest.mark.parametrize("policy", ["strict", "stats", "full"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "yi-34b", "recurrentgemma-9b", "gemma3-27b",
                                  "deepseek-v2-lite-16b", "whisper-base", "llama-3.2-vision-90b"])
def test_tier_plan_matches_reference(arch, policy):
    ref_cfg = ref_get_reduced(arch).replace(collect_moe_usage=True)
    cfg = get_reduced(arch).replace(collect_moe_usage=True)
    kwargs, stats = _profiles(cfg)[policy]
    ref = ref_analyze(ref_build_model(ref_cfg), RefProfile(**kwargs), hot_units_stats=stats,
                      trace_B=1, trace_S=32)
    mine = analyze(build_model(cfg), DeploymentProfile(**kwargs), hot_units_stats=stats,
                   trace_B=1, trace_S=32)
    assert mine.reach.entry_names == ref.reach.entry_names
    assert mine.reach.reachable == ref.reach.reachable
    assert _decisions(mine.plan) == _decisions(ref.plan)
    assert mine.summary() == ref.summary()


@pytest.mark.parametrize("arch,layers", [("gemma3-27b", 6), ("deepseek-v2-lite-16b", 3), ("whisper-base", 6),
                                         ("llama-3.2-vision-90b", 5)])
def test_full_width_plan_matches_reference(arch, layers):
    """At full width (Gemma-3: one 5:1 unit; DeepSeek-V2-Lite: its dense lead
    layer and two MoE groups; Whisper: all 6 decoder and 6 encoder layers;
    Llama-3.2-Vision: one 4-self:1-cross unit) the strict plan, its units and
    bytes are the reference's. Gemma-3's tier-1 is empty (tied embeddings,
    dense MLPs); DeepSeek's dense lead MLP and shared experts stay tier-0 and
    only its routed expert tables and vocab row groups are units. The text-
    only plans of the modal families put exactly the encoder (Whisper) or
    the cross block (Llama) in tier-1, whole leaves, beside the decoder's
    cross-attention (Whisper, tied table: no row groups) or the vocab row
    groups (Llama)."""
    ref_cfg = ref_get_config(arch).replace(num_layers=layers, collect_moe_usage=True)
    cfg = get_config(arch).replace(num_layers=layers, collect_moe_usage=True)
    kwargs, _ = _profiles(cfg)["strict"]
    ref = ref_analyze(ref_build_model(ref_cfg), RefProfile(**kwargs), trace_B=1, trace_S=32)
    mine = analyze(build_model(cfg), DeploymentProfile(**kwargs), trace_B=1, trace_S=32)
    assert mine.reach.reachable == ref.reach.reachable
    assert _decisions(mine.plan) == _decisions(ref.plan)
    assert mine.summary() == ref.summary()
    decisions = mine.plan.decisions
    tier1 = {p for p, d in decisions.items() if d.tier == 1}
    if cfg.encdec is not None:
        assert tier1 == {p for p in decisions if p.startswith("encoder.") or ".cross." in p or ".norm_x" in p}
        assert mine.reach.entry_names == ["prefill_text_only", "decode_step_text_only"]
        return
    if cfg.vlm is not None:
        assert tier1 == {"embed"} | {p for p in decisions if p.startswith("groups.u4.")}
        assert len(decisions["embed"].units) == 16 and all(len(decisions[p].units) == 1 for p in tier1 - {"embed"})
        return
    if cfg.moe is None:
        assert mine.plan.summary()["units"] == 0 and mine.plan.tier1_bytes == 0
        return
    assert all(d.tier == 0 for p, d in decisions.items() if p.startswith("lead.b0.dense.") or ".moe.shared." in p)
    assert {p for p, d in decisions.items() if d.tier == 1} == {
        "embed", "groups.u0.moe.w_gate", "groups.u0.moe.w_up", "groups.u0.moe.w_down"}
    keys = decisions["groups.u0.moe.w_gate"].units
    assert [u.key for u in keys] == [f"groups.u0.moe.w_gate#l{l}e{e}" for l in range(2) for e in range(64)]


def test_liveness_leaves_unused_inputs_dead():
    """A leaf the entry never reads is statically optional, as in the
    reference's whisper-decode case."""
    from torch.fx.experimental.proxy_tensor import make_fx

    def fn(a, b, c):
        return (a @ b).sum(), c.shape[0]

    gm = make_fx(fn)(torch.ones(2, 2), torch.ones(2, 2), torch.ones(3))
    assert live_placeholders(gm) == [True, True, False]


def test_analysis_allocates_nothing_at_full_width():
    """Full-width Mixtral (2 of 56 layers) analyzes on shape-only stand-ins."""
    full = get_config("mixtral-8x22b").replace(num_layers=2, collect_moe_usage=True)
    model = build_model(full, param_dtype=torch.bfloat16)
    res = analyze(model, DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0,
                                           min_tier1_bytes=1 << 14, vocab_row_group=2048),
                  trace_B=1, trace_S=32)
    plan = res.plan
    assert plan.total_bytes > 10 * 2**30  # ≈10.8 GB of bf16 weights, none allocated
    assert plan.decisions["groups.u0.moe.w_gate"].units[0].key == "groups.u0.moe.w_gate#l0e0"
    assert len(plan.decisions["embed"].units) == 16
    assert plan.decisions["head"].tier == 0


def test_tied_dense_hybrid_has_empty_tier1():
    """RecurrentGemma ties its embeddings (the table is consumed densely by
    the logits) and every other leaf is dense and reached by prefill: the
    strict plan puts everything in tier-0, as the reference's does."""
    cfg = get_reduced("recurrentgemma-9b")
    kwargs, _ = _profiles(cfg)["strict"]
    res = analyze(build_model(cfg), DeploymentProfile(**kwargs), trace_B=1, trace_S=32)
    summary = res.plan.summary()
    assert summary["units"] == 0 and summary["tier1_leaves"] == 0 and summary["tier1_bytes"] == 0
    assert summary["tier0_fraction"] == 1.0
    assert res.plan.decisions["embed"].tier == 0
    assert all(res.reach.reachable[p] for p in res.reach.reachable)

"""The port's cost counter, roofline terms, ``cfg.remat`` and dry run
(``repro_torch.utils.hlocost`` / ``hlo``, ``models.transformer._remat``,
``repro_torch.launch.dryrun``) against the reference's.

The reference's dry run forces 512 host devices when its module is
imported, so its side runs in a subprocess with four forced devices and a
hand-built ``Mesh``; cells are the reduced configs at B=4, S=64.
"""

import json
import math
import os
import subprocess
import sys
from dataclasses import fields, replace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.transformer import stack_layout
from repro_torch.models.zoo import WHISPER_DECODE_ENC_LEN, build_model
from repro_torch.sharding import param_shardings, resolve_pspec
from repro_torch.sharding.rules import ACT_RULES, spec_shard_divisor
from repro_torch.training.train_loop import value_and_grad
from repro_torch.utils import hlo
from repro_torch.utils.hlocost import analyze
from repro_torch.utils.tree import flatten_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("prefill", "decode", "train")
MESHES = ((1, 1), (2, 2))
# every cell, train included (Whisper's and the VLM's with their ``frames`` /
# ``image_embeds``)
TRAIN_ARCHS = ("mixtral-8x22b", "yi-34b", "gemma3-27b", "deepseek-v2-lite-16b", "recurrentgemma-9b", "whisper-base",
               "llama-3.2-vision-90b")
# their prefill and decode cells only (each compiles in a few seconds). xLSTM's
# train cells trace in 7-9 s each and differ from the reference's compiled
# dot FLOPs in its recurrences' backward (PERF.md §7), so they stay out
SERVE_ARCHS = ("xlstm-125m",)
PARITY_ARCHS = TRAIN_ARCHS + SERVE_ARCHS
TRAIN_REMATS = ("none", "full")


def _shape(kind: str) -> ShapeSpec:
    return ShapeSpec(f"{kind}_b4s64", 64, 4, kind)


def _kinds(arch: str) -> tuple:
    return KINDS if arch in TRAIN_ARCHS else ("prefill", "decode")


def _reduced_fields(arch: str) -> dict:
    cfg = get_reduced(arch)
    return {f.name: getattr(cfg, f.name) for f in fields(cfg)}


# ---------------------------------------------------------------------------
# hlocost: loop-aware by construction
# ---------------------------------------------------------------------------


def test_hlocost_counts_loop_trips():
    """``test_substrates.py::test_hlocost_counts_loop_trips`` for the port:
    10 × tanh(c @ w) at 128 is 10·2·128³ dot FLOPs, exactly."""
    def f(x, w):
        c = x
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c

    cost = analyze(f, torch.ones(128, 128), torch.ones(128, 128))
    assert cost.dot_flops == 10 * 2 * 128**3
    assert cost.flops == cost.dot_flops + 10 * 128 * 128  # one per tanh output element


def test_hlocost_nested_loops():
    def f(x, w):
        c = x
        for _ in range(4):
            for _ in range(5):
                c = c @ w
        return c

    assert analyze(f, torch.ones(64, 64), torch.ones(64, 64)).dot_flops == 20 * 2 * 64**3


def test_hlocost_counts_an_all_gather_on_a_fake_world():
    """One all-gather of a known block on a 4-rank fake world counts its
    result bytes under the reference's kind name."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard

    from repro_torch.sharding.rules import _from_local

    dryrun.fake_world(4)
    try:
        mesh = dryrun.make_mesh((4,), ("data",), "cpu")
        with FakeTensorMode():
            d = _from_local(torch.empty(8, 32), (32, 32), mesh, (Shard(0),))
            cost = analyze(lambda x: x.full_tensor(), d)
    finally:
        dist.destroy_process_group()
    assert cost.collective_by_kind == {"all-gather": 32 * 32 * 4}
    assert cost.collective_count == {"all-gather": 1.0}
    assert cost.collective_bytes == 32 * 32 * 4


def test_hlocost_kernelized_drops_only_the_score_matmuls():
    """``kernelized=True`` leaves out the batched matmuls of two activations
    (scores and probabilities × V), and keeps a matmul that reads a weight,
    also after the weight is cast and viewed."""
    def attend(w, x):
        q = (x @ w.to(torch.float32).t()).view(2, 8, 16)
        s = torch.bmm(q, q.transpose(1, 2))  # (2, 8, 8) scores
        return torch.bmm(torch.softmax(s, -1), q)

    w, x = torch.ones(16, 16, dtype=torch.bfloat16), torch.ones(16, 16)
    full, kern = analyze(attend, w, x), analyze(attend, w, x, kernelized=True)
    scores = 4 * (2 * (2 * 8 * 16) + 2 * 8 * 8) + 4 * (2 * 8 * 8 + 2 * (2 * 8 * 16))
    assert full.bytes - kern.bytes == scores
    assert full.dot_flops == kern.dot_flops


def test_roofline_terms_use_the_h100_datasheet():
    r = hlo.Roofline("a", "s", "1x1", 1, hlo_flops=989e12, hlo_bytes=3.35e12 * 2, collective_bytes=0.0,
                     model_flops=494.5e12)
    assert (r.compute_s, r.memory_s, r.dominant, r.bound_s) == (1.0, 2.0, "memory", 2.0)
    assert r.useful_flops_ratio == 0.5 and r.roofline_fraction == 0.5
    assert hlo.Roofline("a", "s", "2", 2, 0.0, 0.0, 450e9, 0.0).collective_s == 1.0
    assert hlo.dense_model_flops(10, 3) == 180.0


# ---------------------------------------------------------------------------
# cfg.remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "recurrentgemma-9b"])
def test_remat_policies_keep_the_gradients(arch):
    """Under "full" and "dots_saveable" the loss's gradients equal those
    under "none" within 1e-6 (fp32), and the recompute really runs: "full"
    counts more dot FLOPs than "none"."""
    cfg = replace(get_reduced(arch), dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    rs = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 16))) for k in ("tokens", "labels")}
    grads, dots = {}, {}
    for mode in ("none", "full", "dots_saveable"):
        model = build_model(replace(cfg, remat=mode))
        loss, g = value_and_grad(model.loss_fn, params, batch)
        grads[mode] = dict(flatten_with_paths(g))
        dots[mode] = analyze(lambda p, b: value_and_grad(model.loss_fn, p, b), params, batch).dot_flops
    for mode in ("full", "dots_saveable"):
        for path, g in grads["none"].items():
            torch.testing.assert_close(grads[mode][path], g, rtol=0, atol=1e-6, msg=f"{mode} {path}")
    assert dots["full"] > dots["none"] == dots["dots_saveable"]


def test_remat_leaves_serving_untouched():
    """Without autograd recording, "full" runs the body as it is: prefill
    dispatches the same operators as under "none"."""
    cfg = replace(get_reduced("mixtral-8x22b"), dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.int64)}
    costs = [analyze(build_model(replace(cfg, remat=m)).prefill, params, batch) for m in ("none", "full")]
    assert costs[0] == costs[1]


# ---------------------------------------------------------------------------
# dry run against the reference's
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import json, os, sys
import numpy as np
import jax
from dataclasses import fields
from jax.sharding import Mesh
import repro.launch.dryrun as rd
from repro.configs import SHAPES, get_reduced
from repro.configs.base import ShapeSpec
from repro.sharding import use_mesh
from repro.utils import hlocost

archs, meshes, kinds, remats = json.loads(sys.argv[1])
out = []
for arch in archs:
    cfg = get_reduced(arch)
    extra = {f.name: getattr(cfg, f.name) for f in fields(cfg)}
    for dm in meshes:
        mesh = Mesh(np.array(jax.devices()[:dm[0] * dm[1]]).reshape(*dm), ("data", "model"))
        for kind in kinds:
            shape = ShapeSpec(f"{kind}_b4s64", 64, 4, kind)
            rd.SHAPES[shape.name] = shape
            for remat in (remats if kind == "train" and dm == [1, 1] else ["full"]):
                model, fn, args, in_sh, out_sh = rd.build_cell(arch, shape.name, mesh, extra_cfg=dict(extra, remat=remat))
                with use_mesh(mesh):
                    c = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile()
                out.append({"arch": arch, "mesh": dm, "kind": kind, "remat": remat, "params": model.num_params(),
                            "active_params": model.active_params(), "model_flops": rd._model_flops(model, shape),
                            "argument_size_in_bytes": c.memory_analysis().argument_size_in_bytes,
                            "dot_flops": hlocost.analyze(c.as_text()).dot_flops})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_cells():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE,
                               json.dumps([[arch], MESHES, _kinds(arch), TRAIN_REMATS])],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for arch in PARITY_ARCHS]  # one process per arch, side by side
    cells = {}
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
        cells.update({(r["arch"], tuple(r["mesh"]), r["kind"], r["remat"]): r for r in json.loads(out.splitlines()[-1])})
    return cells


def _port_cell(arch, mesh, kind, remat="full"):
    return dryrun.run_cell(arch, _shape(kind), mesh_shape=mesh, device="cpu", out_dir=None, verbose=False,
                           extra_cfg=dict(_reduced_fields(arch), remat=remat))


def _train_micro_batches(mesh: tuple) -> int:
    """The dry run's micro-batches for a B=4 train cell of a reduced config:
    4, at most one batch row per data rank each (``dryrun.build_cell``)."""
    return max(1, min(4, 4 // mesh[0]))


def _router_gap(arch: str, mesh: tuple, kind: str) -> int:
    """Per-device dot FLOPs the reference counts and the port does not, at
    2×2. One op: a MoE layer's router. The reference's GSPMD runs it on
    each data rank's tokens whole over ``model`` (a (T_d, 64) × (64, E) dot
    per MoE layer), the port splits its contraction over ``model`` and
    all-reduces the partial logits (a (T_d, 32) × (32, E) dot), as both do
    in decode.

      * prefill: T_d = 128 tokens. Reduced Mixtral's 2 layers × 32,768 =
        65,536 FLOPs, 0.21% of the reference's 30,605,312; reduced
        DeepSeek-V2-Lite's 2 MoE layers (its dense lead layer has no
        router) × 65,536 = 131,072, 0.45% of its 28,835,840;
      * train: 2 micro-batches of T_d = 64 tokens. The reference runs three
        of the router's four dots whole (its compiled HLO: the forward, the
        recompute under remat "full" and the input gradient, each a (64,
        64) × (64, 4) or (64, 4) × (4, 64) dot of 32,768 FLOPs) and splits
        the weight gradient over ``model`` as the port splits all four:
        2 layers × 2 micro-batches × 3 dots × 16,384 = 196,608 on reduced
        Mixtral, 0.20% of the reference's 96,927,744; on reduced
        DeepSeek-V2-Lite, whose router has E = 8 columns, each dot is
        (64, 64) × (64, 8), 65,536 FLOPs whole and 32,768 split: 2 MoE
        layers × 2 micro-batches × 3 dots × 32,768 = 393,216, 0.45% of its
        88,145,920.

    Every other dot of the cells is the reference's quarter, but for the
    train cell's experts (``_capacity_gap``), DeepSeek-V2-Lite's latent
    projections (``_latent_gap``) and RecurrentGemma's attention scores
    (``_score_gap``)."""
    cfg = get_reduced(arch)
    if cfg.moe is None or kind == "decode" or mesh == (1, 1):
        return 0
    D, M = mesh
    moe_layers = cfg.num_layers - cfg.moe.first_dense_layers
    if kind == "prefill":
        return moe_layers * (4 * 64 // D) * cfg.d_model * cfg.moe.num_experts * 2 * (M - 1) // M
    n = _train_micro_batches(mesh)
    return moe_layers * n * 3 * (4 // n * 64 // D) * cfg.d_model * cfg.moe.num_experts * 2 * (M - 1) // M


def _capacity_gap(arch: str, mesh: tuple, kind: str) -> int:
    """Per-device dot FLOPs the port counts and the reference does not (a
    negative gap), in a MoE train cell: the experts' capacity slots. Both
    take training's capacity over the global tokens of a micro-batch, C =
    ceil(k · T · capacity_factor / E) (2 · 128 · 1.25 / 4 = 80 on reduced
    Mixtral at 2×2). The reference's GSPMD splits the capacity dim over
    ``data`` (C / D = 40 slots an expert a device). The port keeps each
    rank's tokens on the rank, and a rank may route all of its T_loc = 64
    tokens of a micro-batch to one expert, so its buffers hold min(C,
    T_loc) = 64 slots an expert. Each of the three expert matmuls (gate,
    up, down: 2 · E_loc · slots · d · f_loc FLOPs, E_loc = 2 experts of the
    rank's EP share, f_loc = 128) runs four times a micro-batch (forward,
    recompute under remat "full", and the two gradient dots): 2 layers × 2
    micro-batches × 4 × 3 × 2 · 2 · (64 − 40) · 64 · 128 = 37,748,736
    FLOPs, 38.9% of the reference's 96,927,744. Reduced DeepSeek-V2-Lite:
    C = ceil(2 · 128 · 1.25 / 8) = 40, under T_loc = 64, so a rank's
    buffers hold C = 40 slots an expert against the reference's C / D = 20,
    E_loc = 4 experts of f = 32 (its shared expert is not routed and takes
    no slot): 2 MoE layers × 2 micro-batches × 4 × 3 × 2 · 4 · (40 − 20) ·
    64 · 32 = 15,728,640 FLOPs, 17.8% of the reference's 88,145,920. None at
    1×1 (min(C, T) = C)."""
    cfg = get_reduced(arch)
    if cfg.moe is None or kind != "train":
        return 0
    D, M = mesh
    m = cfg.moe
    n = _train_micro_batches(mesh)
    T = 4 // n * 64  # global tokens of one micro-batch
    C = max(1, min(T, math.ceil(m.top_k * T * m.capacity_factor / m.num_experts)))
    ep = m.num_experts % M == 0  # experts over ``model`` (EP), else ``ffn`` within each expert
    E_loc, f_loc = (m.num_experts // M, m.expert_d_ff) if ep else (m.num_experts, m.expert_d_ff // M)
    moe_layers = cfg.num_layers - m.first_dense_layers
    return -moe_layers * n * 4 * 3 * 2 * E_loc * (min(C, T // D) - C // D) * cfg.d_model * f_loc


def _latent_gap(arch: str, mesh: tuple, kind: str) -> int:
    """Per-device dot FLOPs the reference counts and the port does not in
    DeepSeek-V2-Lite's train cell at 2×2: MLA's latent projections ``w_dkv``
    (d × r) and ``w_kr`` (d × rope), whose rows are replicated over
    ``model``. The port splits their contraction over ``model`` in every
    dot (the rank's slice of x times its rows, the partial sums
    all-reduced), as in prefill, where the reference does the same. In the
    train cell the reference's GSPMD does so as with the router
    (``_router_gap``): of a scanned layer's four dots a micro-batch (the
    forward, the recompute under remat "full", the input and the weight
    gradients) it runs three whole and splits the weight gradient, and of
    the unscanned lead layer's three (no recompute) it runs two whole. Its
    compiled HLO holds 16 more of these dots at twice the port's size.
    Each whole dot of both weights is 2 · 64 · 64 · (32 + 8) = 327,680
    FLOPs against the port's half: 2 micro-batches × (2 + 2 × 3) dots ×
    163,840 = 2,621,440, 2.97% of the reference's 88,145,920."""
    cfg = get_reduced(arch)
    if cfg.mla is None or kind != "train" or mesh == (1, 1):
        return 0
    D, M = mesh
    n = _train_micro_batches(mesh)
    lead = cfg.moe.first_dense_layers if cfg.moe else 0
    whole_dots = 2 * lead + 3 * (cfg.num_layers - lead)
    rows = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    return n * whole_dots * 2 * (4 // n * 64 // D) * cfg.d_model * rows * (M - 1) // M


def _score_gap(arch: str, mesh: tuple, kind: str) -> int:
    """Per-device dot FLOPs the reference counts and the port does not in
    the train cells at 2×2 of RecurrentGemma, Whisper and Llama-3.2-Vision:
    score matmuls that the reference's backward recomputes. Its plain
    attention checkpoints its k-block body (``_score_recompute_flops``), and
    at 2×2 its compiled HLO keeps some of those recomputes, each a dot of
    the shape of a QK^T score matmul on the rank's heads, 2 · B_loc · (H /
    M) · S · T · hd FLOPs (B_loc = 1 row of a micro-batch, H / M = 2 heads,
    S = 64 queries, hd = 16); the port keeps the probabilities for its
    backward. At 1×1 XLA merges them with the forward's scores and there is
    no gap.

      * RecurrentGemma: one in its attention layer a micro-batch, T = 64:
        262,144 × 2 micro-batches = 524,288, 0.65% of the reference's
        80,216,064;
      * Whisper: three in each of its attention modules a micro-batch (the
        2 decoder self-attentions, the 2 cross-attentions over the 64
        encoder frames and the 2 encoder self-attentions, all T = 64): its
        compiled HLO holds 11 score-shaped dots a module where the port's
        trace holds 8 (the forward's QK^T and PV, their recompute under
        remat "full", and the four gradient dots), 3 × 6 × 262,144 × 2 =
        9,437,184, 6.57% of the reference's 143,654,912;
      * Llama-3.2-Vision: one in its gated cross block a micro-batch, over
        the 16 image tokens (T = 16): 65,536 × 2 = 131,072, 0.11% of the
        reference's 123,109,376; its four self-attention layers have none
        (the five layers are one scanned group)."""
    if kind != "train" or mesh == (1, 1):
        return 0
    cfg = get_reduced(arch)
    D, M = mesh
    n = _train_micro_batches(mesh)
    one = 2 * (4 // n // D) * (cfg.num_heads // M) * 64 * cfg.resolved_head_dim
    if arch == "recurrentgemma-9b":
        return n * sum(k == "attn" for k in cfg.attn_kinds) * one * 64
    if arch == "whisper-base":
        return n * 3 * (2 * cfg.num_layers + cfg.encdec.num_encoder_layers) * one * 64
    if arch == "llama-3.2-vision-90b":
        return n * sum(k == "cross" for k in cfg.attn_kinds) * one * cfg.vlm.num_image_tokens
    return 0


def _key_block_gap(arch: str, mesh: tuple, kind: str) -> int:
    """Per-device dot FLOPs the reference counts and the port does not in
    Whisper's decode cell. One op: the cross-attention over the 1500-frame
    audio memory (``WHISPER_DECODE_ENC_LEN``). The reference's plain
    attention takes keys in blocks of 1024 (``flash_attention_jnp``'s
    ``chunk_k``) and pads the memory to 2048, so each of its two dots (scores
    and probabilities × V) counts 2·B·H·hd·548 more per decoder layer; the
    port attends over the 1500 keys as they are. Reduced Whisper at B=4:
    2 layers × 2 dots × 2·4·4·16·548 = 1,122,304 at 1×1 (20.9% of the
    reference's 5,373,952), a quarter of that a device at 2×2 (rows over
    ``data``, heads over ``model``). Its prefill cell's memory is the 64
    frames of the batch, one block, and has no gap."""
    if arch != "whisper-base" or kind != "decode":
        return 0
    cfg = get_reduced(arch)
    pad = -WHISPER_DECODE_ENC_LEN % 1024
    return cfg.num_layers * 2 * 2 * 4 * cfg.num_heads * cfg.resolved_head_dim * pad // math.prod(mesh)


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_dryrun_cells_match_the_reference(arch, reference_cells):
    """At 1×1 and 2×2: params, active params and model FLOPs equal; the
    arguments' bytes per device equal (prefill, decode, and train for
    ``TRAIN_ARCHS``; the leaves the step reads, as the reference's compiled
    program keeps only those: Whisper's decode reads no encoder weight, no
    modal family's decode the cross-attention's ``wk`` / ``wv``, xLSTM's no
    ``pos``); dot FLOPs
    per device equal for prefill and decode (the port's ``hlo_dot_flops /
    num_chips`` against the reference's compiled per-device count; at 2×2
    the serving cells compute on shards, the multimodal ones on the cells'
    ``frames``, ``image_embeds`` and cross caches, up to the ops of
    ``_router_gap`` and ``_key_block_gap``); dot FLOPs per device equal for
    the train cells of ``TRAIN_ARCHS`` too, which compute on shards (the
    record's ``train_on_shards``; Whisper's and the VLM's on the cells'
    ``frames`` and ``image_embeds``; at 2×2 each weight's gradient is
    reduce-scattered into its block, so the collectives hold a
    reduce-scatter), up to the ops of ``_router_gap``, ``_capacity_gap``,
    ``_latent_gap`` and ``_score_gap``; and every record's argument bytes equal the closed
    form of its shardings."""
    for mesh in MESHES:
        for kind in _kinds(arch):
            ref = reference_cells[(arch, mesh, kind, "full")]
            rec = _port_cell(arch, mesh, kind)
            assert rec["status"] == "ok" and rec["mesh"] == "x".join(map(str, mesh))
            for key in ("params", "active_params", "model_flops"):
                assert rec[key] == ref[key], (mesh, kind, key)
            args = rec["memory"]["argument_size_in_bytes"]
            assert args == ref["argument_size_in_bytes"] == rec["closed_form_argument_bytes"], (mesh, kind)
            per_device = rec["hlo_dot_flops"] / rec["num_chips"]
            gap = (_router_gap(arch, mesh, kind) + _key_block_gap(arch, mesh, kind) + _capacity_gap(arch, mesh, kind)
                   + _latent_gap(arch, mesh, kind) + _score_gap(arch, mesh, kind))
            assert ref["dot_flops"] - per_device == gap, (mesh, kind)
            assert rec["collective_bytes"] == 0.0 if mesh == (1, 1) else rec["collective_bytes"] > 0
            if kind == "train":
                assert rec["train_on_shards"] is True, mesh
                assert ("reduce-scatter" in rec["collectives"]["bytes"]) == (mesh != (1, 1)), mesh


def _score_recompute_flops(arch: str) -> int:
    """One QK^T matmul per attention module and micro-batch (1 row of 64
    tokens each), where the reference's recompute survives: a GQA stack of
    more than one scanned group (``test_dryrun_train_flops_match_the_reference``).
    Whisper's layers hold two modules each (the self-attention and the
    cross-attention over the 64 encoder frames) and its encoder one a layer."""
    cfg = get_reduced(arch)
    if cfg.mla is not None or stack_layout(cfg).n_groups < 2:
        return 0
    modules = cfg.num_layers * (2 if cfg.encdec else 1) + (cfg.encdec.num_encoder_layers if cfg.encdec else 0)
    return 2 * 1 * cfg.num_heads * 64 * 64 * cfg.resolved_head_dim * modules * 4


@pytest.mark.parametrize("remat", TRAIN_REMATS)
def test_dryrun_train_flops_match_the_reference(remat, reference_cells):
    """Train at 1×1: the port's global dot FLOPs against the reference's.

    The only gap is the reference's attention backward. Its plain attention
    checkpoints each k-block body (``src/repro/models/attention.py:263-264``,
    ``jax.checkpoint(k_body)``), so under ``remat="none"`` its backward
    recomputes the QK^T scores: one 2·B·H·Sq·Sk·hd matmul per layer and
    micro-batch, 524,288 FLOPs × 2 layers × 4 micro-batches = 4,194,304 on
    reduced Mixtral (1.4% of its count, inside 2%) and on reduced Yi (2.2%).
    The port keeps the probabilities for its backward. Under "full" both
    recompute the whole group body and the counts are equal.

    Whisper's two scanned decoder layers show the same gap for each of its
    six attention modules (two self, two cross over the 64 frames, two in
    the encoder): 12,582,912, 2.9% of its 440,401,920. The other four show
    no gap under "none". DeepSeek-V2-Lite's
    MLA asks the reference's attention for its cache in training too
    (``src/repro/models/transformer.py:228``, ``return_cache=True``), which
    takes its ``differentiable=False`` path, with no checkpoint. Gemma-3's,
    RecurrentGemma's and Llama-3.2-Vision's stacks are one scanned group, a loop of one trip,
    which XLA turns into straight-line code where the recomputed scores
    merge with the forward's (reduced Mixtral cut to one layer shows the
    same: 176,553,984 dot FLOPs on both sides)."""
    for arch in TRAIN_ARCHS:
        ref = reference_cells[(arch, (1, 1), "train", remat)]
        rec = _port_cell(arch, (1, 1), "train", remat)
        gap = ref["dot_flops"] - rec["hlo_dot_flops"]
        assert gap == (_score_recompute_flops(arch) if remat == "none" else 0), arch
        if arch == "mixtral-8x22b":
            assert abs(gap) <= 0.02 * ref["dot_flops"]


def _implied_gather_bytes(leaf_bytes: int, spec, sizes: dict, over=("data", "model")) -> int:
    """Result bytes of the all-gathers that grow one block over the mesh
    dims in ``over``, one tensor dim at a time in dim order (the others stay
    split)."""
    dims = [ax for e in spec for ax in ((e,) if isinstance(e, str) else e or ())]
    block = leaf_bytes // math.prod(sizes[d] for d in dims)
    total = 0
    for d in dims:
        if d in over:
            block *= sizes[d]
            total += block
    return total


def _sharded_prefill_collectives(cfg, B: int, S: int, sizes: dict, leaves: dict) -> int:
    """Closed form of the collective bytes per device of the sharded prefill
    (``models.transformer.prefill_sharded``), bf16 activations:

      * FSDP: every param leaf's ``embed`` dim all-gathered over ``data``
        once per layer (its stacked groups' once each). Where the q heads
        do not divide ``model`` (H % model), the attention projections are
        all-gathered over ``model`` too;
      * the vocab-parallel embedding's rows all-reduced over ``model``;
      * per layer: ``wo``'s partial sums all-reduced over ``model`` when the
        q heads are split; with them, K/V computed on the rank's columns
        (Hkv·hd % model) all-gathered over ``model``; the MoE router's partial logits (fp32)
        all-reduced over ``model``, the expert ids (int64, T·k) all-gathered
        over ``data`` and the expert outputs all-reduced over ``model``; a
        dense MLP's down projection all-reduced over ``model``."""
    D, M = sizes["data"], sizes["model"]
    H, Hkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    B_loc = B // D if B % D == 0 else B
    T_loc = B_loc * S
    tp = H % M == 0 and (H * hd) % M == 0
    kv_split = tp and (Hkv * hd) % M == 0
    total = 0
    for path, (nbytes, spec) in leaves.items():
        whole_heads = tp if ".attn." in path else True
        total += _implied_gather_bytes(nbytes, spec, sizes, ("data",) if whole_heads else ("data", "model"))
    act = 2 * T_loc * d if cfg.vocab_size % M == 0 and M > 1 else 0
    per_layer = 0
    if tp and M > 1:
        per_layer += 2 * T_loc * d
    if kv_split and M > 1:
        per_layer += 2 * 2 * B_loc * S * Hkv * hd
    if cfg.moe is not None:
        E, k, f = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.expert_d_ff
        per_layer += 4 * T_loc * E if M > 1 and d % M == 0 else 0
        per_layer += 8 * B * S * k if D > 1 and B % D == 0 else 0
        per_layer += 2 * T_loc * d if M > 1 and (E % M == 0 or f % M == 0) else 0
    elif cfg.d_ff % M == 0 and M > 1:
        per_layer += 2 * T_loc * d
    return total + act + cfg.num_layers * per_layer


def test_reduced_cell_on_the_production_mesh():
    """Reduced Mixtral's prefill (B=16, S=64) on a fake 16×16 world: its
    arguments' bytes equal the closed form from the shardings over
    ``production_mesh_shape()``, and its collective bytes equal the closed
    form of the sharded step (``_sharded_prefill_collectives``: per-layer
    FSDP gathers plus the activation reductions), far under the all-gather
    of the whole tree that gather-at-use paid."""
    shape = ShapeSpec("prefill_b16s64", 64, 16, "prefill")
    rec = dryrun.run_cell("mixtral-8x22b", shape, device="cpu", out_dir=None, verbose=False,
                          extra_cfg=_reduced_fields("mixtral-8x22b"))
    assert rec["mesh"] == "16x16" and rec["num_chips"] == 256
    mesh = production_mesh_shape()
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    model = build_model(replace(get_reduced("mixtral-8x22b"), use_pallas=False))
    abstract = model.abstract(dtype=torch.bfloat16)
    sh = dict(flatten_with_paths(param_shardings(model.logical_axes(), abstract, mesh)))
    leaves = [(leaf, sh[p].spec) for p, leaf in flatten_with_paths(abstract)]
    entry = model.input_specs(shape)
    (batch,), (axes,) = entry.args, entry.arg_axes
    leaves += [(leaf, resolve_pspec(axes[k], leaf.shape, mesh, ACT_RULES)) for k, leaf in batch.items()]
    nbytes = [(leaf.numel() * leaf.element_size(), spec) for leaf, spec in leaves]
    closed = sum(b // spec_shard_divisor(spec, mesh) for b, spec in nbytes)
    assert rec["memory"]["argument_size_in_bytes"] == closed == rec["closed_form_argument_bytes"]
    params = {p: (leaf.numel() * leaf.element_size(), sh[p].spec) for p, leaf in flatten_with_paths(abstract)}
    want = _sharded_prefill_collectives(model.cfg, 16, 64, sizes, params)
    assert rec["collective_bytes"] == want
    assert want < sum(_implied_gather_bytes(b, spec, sizes) for b, spec in nbytes)  # the whole-tree gather
    assert set(rec["collectives"]["bytes"]) == {"all-gather", "all-reduce"}
    assert rec["fits"] and rec["memory"]["temp_size_in_bytes"] > 0


def test_dryrun_cli_writes_its_records(tmp_path, capsys):
    """The CLI on the CPU at a forced 2×2 mesh, widths cut by
    ``--override``: a decode_32k record with the reference's line, and
    long_500k skipped for a full-attention arch."""
    over = "num_layers=2,d_model=64,num_heads=4,num_kv_heads=2,d_ff=128,vocab_size=512,head_dim=16"
    common = ["--device", "cpu", "--mesh", "2x2", "--out", str(tmp_path), "--override", over]
    assert dryrun.main(["--arch", "yi-34b", "--shape", "decode_32k", *common]) == 0
    assert dryrun.main(["--arch", "yi-34b", "--shape", "long_500k", *common]) == 0
    ok = json.load(open(tmp_path / "yi-34b_decode_32k_2x2.json"))
    assert ok["status"] == "ok" and ok["num_chips"] == 4 and ok["micro_batches"] == 1
    assert ok["memory"]["argument_size_in_bytes"] == ok["closed_form_argument_bytes"]
    assert json.load(open(tmp_path / "yi-34b_long_500k_2x2.json"))["status"] == "skipped"
    out = capsys.readouterr().out
    assert "[dryrun] yi-34b × decode_32k × 2x2: OK flops/dev=" in out and "fits=yes" in out

"""Decoder-stack assembly for every family of the reference: uniform
attention stacks with a dense (SwiGLU) or MoE MLP — the Mixtral family plus
the dense Yi / Phi-3 / Mistral-Large configs — Gemma-3's 5:1 local/global
stack, DeepSeek-V2-Lite's MLA stack with its dense lead layer and
fine-grained MoE, RecurrentGemma's hybrid rec/rec/attn stack, xLSTM's m/s
stack, Whisper's encoder-decoder and Llama-3.2-Vision's 4-self:1-cross stack
(``repro.models.transformer`` counterpart).

Layers are grouped into scanned units with stacked parameters
(``groups.u{j}.*``, leading axis = group), plus unscanned ``lead.b{i}`` /
``tail.b{i}`` blocks where the depth is not a whole number of units,
exactly as the reference lays them out, so one artifact serves both
packages. A Python loop over the groups takes the place of ``lax.scan``.

The modal families. Whisper's encoder (``encoder.*``, every leaf
``modal:audio``) runs only when the batch carries ``frames``, and its
decoder blocks attend to the encoder's output through ``cross`` only then;
Llama-3.2-Vision's ``cross`` blocks (every leaf ``modal:image``) run only when
the batch carries ``image_embeds`` and are skipped whole otherwise. Both are
Python control flow, so a text-only entry's trace never touches their
weights, and the analyzer leaves them dead.

Entry points: ``loss_fn`` (the training forward and its cross-entropy),
``prefill`` (last-token logits + caches) and ``decode_step`` (one token
against the caches); on a rank's shards, for every family,
``prefill_sharded``, ``decode_step_sharded`` and ``loss_fn_sharded``.

Kernels on the training path. The loss runs the stack without collecting
caches, and there every block names the plain versions itself:
``gqa_forward(attend=flash_attention_plain)`` and
``rglru_block_forward(scan=rglru_scan_plain)``, on every device. No kernel
has a backward, and the reference trains with ``use_pallas=False``, so its
training runs these same plain forms. (A kernel wrapper refuses a CUDA
launch whose inputs require grad.) Under ``plain_versions()`` every
forward run names them too (the dry run: the reference lowers its cells with
``use_pallas=False``).

Rematerialization (``cfg.remat``) at the reference's two sites, the
encoder's blocks and each scanned group's body: ``"none"`` keeps every
activation; ``"full"`` wraps the body in ``torch.utils.checkpoint`` (its
backward recomputes the body from its inputs); ``"dots_saveable"`` saves the
outputs of the matmuls (``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``) and
recomputes the rest, as ``jax.checkpoint_policies.dots_saveable`` does;
``"inner"`` is ``"full"`` plus a checkpoint per block inside a multi-block
group. It acts only when autograd records the body (grad enabled and an
input that requires grad), so serving and tracing run the body as it is.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention_plain
from repro_torch.kernels.rglru_scan.ops import rglru_scan_plain
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (
    chunked_xent,
    embed,
    embed_sharded,
    embedding_spec,
    logits_from_embedding,
    logits_sharded,
    rmsnorm,
    rmsnorm_spec,
    softmax_xent,
    swiglu,
    swiglu_sharded,
    swiglu_spec,
    xent_sharded,
)
from repro_torch.models.spec import ParamSpec, stack_specs
from repro_torch.sharding.rules import PartitionSpec, Shard, constrain, spec_dims
from repro_torch.utils.tree import tree_map


def _modal(spec_tree: Any, modality: str) -> Any:
    """``spec_tree`` with every leaf annotated ``modal:<modality>``."""
    return tree_map(lambda s: replace(s, access=f"modal:{modality}"), spec_tree)


def _mlp_spec(cfg: ModelConfig, layer_idx: int) -> dict:
    if cfg.moe is not None:
        if layer_idx < cfg.moe.first_dense_layers:
            return {"dense": swiglu_spec(cfg.d_model, cfg.moe.dense_d_ff or cfg.d_ff)}
        return {"moe": moe_mod.moe_spec(cfg)}
    return {"dense": swiglu_spec(cfg.d_model, cfg.d_ff)}


def block_spec(cfg: ModelConfig, kind: str, layer_idx: int) -> dict:
    d = cfg.d_model
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if kind == "cross":  # the VLM's gated image block: both halves gated, all modal:image
        return {"norm1": rmsnorm_spec(d), "cross": attn.cross_attn_spec(d, H, Hkv, hd, cfg.vlm.vision_dim),
                "norm2": rmsnorm_spec(d), **_modal(_mlp_spec(cfg, layer_idx), "image"),
                "gate_ffn": ParamSpec((1,), (None,), init="zeros", access="modal:image")}
    if kind == "m":  # xLSTM blocks carry their own projections: no MLP
        return {"norm": rmsnorm_spec(d), "mlstm": xlstm_mod.mlstm_block_spec(cfg)}
    if kind == "s":
        return {"norm": rmsnorm_spec(d), "slstm": xlstm_mod.slstm_block_spec(cfg)}
    if kind in ("self", "local", "global", "attn"):
        mixer = {"attn": attn.mla_spec(cfg) if cfg.mla is not None else attn.gqa_spec(d, H, Hkv, hd)}
    elif kind == "rec":
        mixer = {"rglru": rec_mod.rglru_block_spec(cfg)}
    else:
        raise ValueError(f"block kind {kind!r} is not ported")
    spec = {"norm1": rmsnorm_spec(d), **mixer, "norm2": rmsnorm_spec(d), **_mlp_spec(cfg, layer_idx)}
    if cfg.encdec is not None:  # the decoder's cross-attention over the encoder output
        spec.update(norm_x=rmsnorm_spec(d), cross=attn.gqa_spec(d, H, Hkv, hd))
    return spec


@dataclass(frozen=True)
class StackLayout:
    lead_kinds: tuple  # unscanned blocks before the groups
    unit_kinds: tuple  # kinds inside one scanned group
    n_groups: int
    tail_kinds: tuple  # unscanned blocks after the groups


def stack_layout(cfg: ModelConfig) -> StackLayout:
    kinds = list(cfg.attn_kinds)
    lead = cfg.moe.first_dense_layers if cfg.moe else 0
    rest = kinds[lead:]
    if cfg.recurrent is not None:
        unit = len(cfg.recurrent.pattern)
    elif cfg.xlstm is not None:
        unit = len(cfg.xlstm.pattern)
    elif cfg.local_global_pattern is not None:
        unit = sum(cfg.local_global_pattern)
    elif cfg.vlm is not None:
        unit = cfg.vlm.cross_attn_every
    else:
        unit = cfg.layers_per_unit if len(rest) % max(cfg.layers_per_unit, 1) == 0 else 1
    n_groups = len(rest) // unit
    return StackLayout(tuple(kinds[:lead]), tuple(rest[:unit]), n_groups, tuple(rest[n_groups * unit:]))


def stack_spec(cfg: ModelConfig) -> dict:
    lay = stack_layout(cfg)
    spec: dict = {"embed": embedding_spec(cfg.vocab_size, cfg.d_model)}
    if cfg.tie_embeddings:
        # tied tables are consumed densely by the logits matmul -> tier-0
        e = spec["embed"]
        spec["embed"] = ParamSpec(e.shape, e.axes, e.init, e.scale, e.dtype, access="dense")
    else:
        spec["head"] = ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))
    if lay.lead_kinds:
        spec["lead"] = {f"b{i}": block_spec(cfg, k, i) for i, k in enumerate(lay.lead_kinds)}
    if lay.n_groups:
        unit_spec = {f"u{j}": block_spec(cfg, k, len(lay.lead_kinds) + j) for j, k in enumerate(lay.unit_kinds)}
        spec["groups"] = stack_specs(unit_spec, lay.n_groups)
    if lay.tail_kinds:
        spec["tail"] = {f"b{i}": block_spec(cfg, k, cfg.num_layers - len(lay.tail_kinds) + i)
                        for i, k in enumerate(lay.tail_kinds)}
    spec["final_norm"] = rmsnorm_spec(cfg.d_model)
    if cfg.encdec is not None:
        d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        # reachable only from entries that take audio frames
        enc_block = {"norm1": rmsnorm_spec(d), "attn": attn.gqa_spec(d, H, Hkv, hd), "norm2": rmsnorm_spec(d),
                     "dense": swiglu_spec(d, cfg.d_ff)}
        spec["encoder"] = {"blocks": stack_specs(_modal(enc_block, "audio"), cfg.encdec.num_encoder_layers),
                           "final_norm": ParamSpec((d,), ("embed",), init="ones", access="modal:audio")}
    return spec


def _kind_window(cfg: ModelConfig, kind: str) -> Optional[int]:
    if kind == "attn":  # RecurrentGemma's local attention
        return cfg.recurrent.window
    if kind == "local":  # Gemma-3's local layers
        return cfg.sliding_window
    if kind == "global":
        return None
    return cfg.sliding_window  # "self": SWA if the config sets it (Mixtral)


# logical axes of each cache leaf, by name (the reference's CacheLeaf.axes)
_CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", None), "v": ("batch", "kv_seq", "kv_heads", None),
    "ckv": ("batch", "kv_seq", None), "kr": ("batch", "kv_seq", None),
    "xk": ("batch", None, "kv_heads", None), "xv": ("batch", None, "kv_heads", None),  # the memory's rows whole
    "lru": ("batch", "ffn"), "conv": ("batch", None, "ffn"),
    "C": ("batch", "heads", None, None), "n": ("batch", "heads", None), "m": ("batch", "heads"),
}


def cache_leaf_axes(kind: str, name: str) -> tuple:
    """The logical axes of cache leaf ``name`` of a ``kind`` block (every
    leaf of an sLSTM block is ("batch", "heads", None))."""
    return ("batch", "heads", None) if kind == "s" else _CACHE_AXES[name]


def _mlp_apply(cfg: ModelConfig, params: dict, x: torch.Tensor, *, serving: bool, usage_rows=None):
    """Returns (y, usage): usage is the (E,) expert-routed mask when the
    config collects router stats (the engine's fault signal), else None;
    ``usage_rows`` (B, S) bool limits it to those rows."""
    if "moe" in params:
        if cfg.collect_moe_usage:
            return moe_mod.moe_forward(params["moe"], x, cfg, return_usage=True, serving=serving,
                                       usage_rows=usage_rows)
        return moe_mod.moe_forward(params["moe"], x, cfg, serving=serving), None
    return swiglu(params["dense"], x), None


class _PlainVersions(threading.local):
    on = False


_PLAIN_VERSIONS = _PlainVersions()


@contextlib.contextmanager
def plain_versions():
    """Every block of this thread names the plain attention and scan, on
    every device, as the loss does: the counterpart of the reference's
    ``use_pallas=False`` (the dry run's cells run under it)."""
    outer, _PLAIN_VERSIONS.on = _PLAIN_VERSIONS.on, True
    try:
        yield
    finally:
        _PLAIN_VERSIONS.on = outer


def _plain(collect_cache: bool) -> bool:
    return not collect_cache or _PLAIN_VERSIONS.on


def _block_forward(cfg, kind, params, x, positions, memory, collect_cache):
    """``_block_body`` with its output constrained to the activation rules
    (the layer boundary)."""
    x, cache = _block_body(cfg, kind, params, x, positions, memory, collect_cache)
    return constrain(x, ("batch", "seq", "embed")), cache


def _block_body(cfg, kind, params, x, positions, memory, collect_cache):
    """Returns (x, cache). ``memory`` holds the encoder output (``enc``) or
    the image embeddings (``image``) of a multimodal batch; a ``cross`` block
    without an image is skipped whole and has an empty cache. Without
    ``collect_cache`` (the training loss) attention and the RG-LRU scan run
    their plain versions."""
    eps = cfg.norm_eps
    cache = {}
    if kind in ("m", "s"):
        h = rmsnorm(x, params["norm"], eps)
        if kind == "m":
            o, c = xlstm_mod.mlstm_block_forward(params["mlstm"], h, cfg)
        else:
            o, c = xlstm_mod.slstm_block_forward(params["slstm"], h, cfg)
        if collect_cache:
            cache.update(c)
        return x + o, cache
    if kind == "cross":
        if memory.get("image") is None:
            return x, cache
        mem_kv = attn.cross_attn_memory(params["cross"], memory["image"], cfg)
        x = x + attn.cross_attn_forward(params["cross"], rmsnorm(x, params["norm1"], eps), mem_kv, cfg, gated=True)
        c, gate = {"xk": mem_kv[0], "xv": mem_kv[1]}, torch.tanh(params["gate_ffn"].to(x.dtype))
    else:
        h = rmsnorm(x, params["norm1"], eps)
        if kind == "rec":
            o, c = rec_mod.rglru_block_forward(params["rglru"], h, cfg,
                                               scan=rglru_scan_plain if _plain(collect_cache) else None)
        elif cfg.mla is not None:
            o, (ckv, kr) = attn.mla_forward(params["attn"], h, positions, cfg)
            c = {"ckv": ckv, "kr": kr}
        else:
            o, (k, v) = attn.gqa_forward(params["attn"], h, positions, cfg, causal=True,
                                         window=_kind_window(cfg, kind),
                                         attend=flash_attention_plain if _plain(collect_cache) else None)
            c = {"k": k, "v": v}
        x = x + o
        if cfg.encdec is not None and memory.get("enc") is not None:
            mem_kv = attn.cross_attn_memory(params["cross"], memory["enc"], cfg)
            x = x + attn.cross_attn_forward(params["cross"], rmsnorm(x, params["norm_x"], eps), mem_kv, cfg)
            c.update(xk=mem_kv[0], xv=mem_kv[1])
        gate = None
    y, usage = _mlp_apply(cfg, params, rmsnorm(x, params["norm2"], eps), serving=collect_cache)
    x = x + (y if gate is None else gate * y)
    if collect_cache:
        cache.update(c)
        if usage is not None:
            cache["moe_usage"] = usage  # rides the cache; the engine strips it
    return x, cache


def _block_decode(cfg, kind, params, x, pos, cache, active=None):
    """x (B, 1, D); returns (x, new_cache). K/V (MLA's latent ``ckv`` and
    ``kr``) are written into ``cache``'s tensors in place and come back as
    the same tensors; a rec block's conv and LRU state come back as new
    tensors, ``cache``'s left as they were, and so does an xLSTM block's
    whole state. Cross K/V (``xk`` / ``xv``, only
    in a multimodal cache) are read, never written; a ``cross`` block whose
    cache has none is skipped whole.
    ``active`` (B,) bool marks the rows whose routing counts toward the usage
    mask (None: every row)."""
    eps = cfg.norm_eps
    new_cache = dict(cache)
    if kind in ("m", "s"):
        h = rmsnorm(x, params["norm"], eps)
        if kind == "m":
            o, c = xlstm_mod.mlstm_block_decode(params["mlstm"], h, cache, cfg)
        else:
            o, c = xlstm_mod.slstm_block_decode(params["slstm"], h, cache, cfg)
        new_cache.update(c)
        return x + o, new_cache
    if kind == "cross":
        if "xk" not in cache:
            return x, new_cache
        h = rmsnorm(x, params["norm1"], eps)
        x = x + attn.cross_attn_forward(params["cross"], h, (cache["xk"], cache["xv"]), cfg, gated=True)
        gate = torch.tanh(params["gate_ffn"].to(x.dtype))
    else:
        h = rmsnorm(x, params["norm1"], eps)
        if kind == "rec":
            o, c = rec_mod.rglru_block_decode(params["rglru"], h, cache, cfg)
            new_cache.update(c)
        elif cfg.mla is not None:
            o, new_cache["ckv"], new_cache["kr"] = attn.mla_decode(params["attn"], h, pos, cache["ckv"],
                                                                   cache["kr"], cfg)
        else:
            window = _kind_window(cfg, kind)
            rolling = window if (window is not None and cache["k"].shape[1] == window) else None
            o, new_cache["k"], new_cache["v"] = attn.gqa_decode(
                params["attn"], h, pos, cache["k"], cache["v"], cfg, rolling_window=rolling)
        x = x + o
        if cfg.encdec is not None and "xk" in cache:
            hx = rmsnorm(x, params["norm_x"], eps)
            x = x + attn.cross_attn_forward(params["cross"], hx, (cache["xk"], cache["xv"]), cfg)
        gate = None
    h2 = rmsnorm(x, params["norm2"], eps)
    y, usage = _mlp_apply(cfg, params, h2, serving=True,
                          usage_rows=active[:, None] if active is not None else None)
    x = x + (y if gate is None else gate * y)
    if usage is not None:
        new_cache["moe_usage"] = usage
    return x, new_cache


def _select(tree: Any, i: int) -> Any:
    """Group ``i`` of a stacked tree (leading axis)."""
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list) -> Any:
    """Inverse of ``_select`` over a list of per-group trees."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default}


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _records_grad(tree: Any) -> bool:
    """True when a leaf of ``tree`` requires grad (a ``Shard`` through its
    fp32 master)."""
    if isinstance(tree, dict):
        return any(_records_grad(v) for v in tree.values())
    if isinstance(tree, Shard):
        tree = tree.master
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def _remat(mode: str, fn: Callable) -> Callable:
    """``fn`` under the remat policy ``mode`` (module docstring); the
    policy applies only to a call that autograd records."""
    if mode == "none":
        return fn

    def run(*args):
        if not (torch.is_grad_enabled() and any(_records_grad(a) for a in args)):
            return fn(*args)
        if mode == "dots_saveable":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=lambda: create_selective_checkpoint_contexts(_dots_saveable))
        return checkpoint(fn, *args, use_reentrant=False)

    return run


def _model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _encoder_input(frames: torch.Tensor) -> tuple:
    """The encoder's input (frames plus sinusoidal positions built in fp32)
    and its RoPE positions 0..T-1, (B, T)."""
    B, T, D = frames.shape
    pos = torch.arange(T, device=frames.device)
    half = D // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=frames.device) / half)
    ang = pos[:, None].to(torch.float32) * freqs[None, :]
    x = frames + torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(frames.dtype)[None]
    return x, pos[None].expand(B, T)


def _encode(cfg: ModelConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder: frames (B, T, d_model), precomputed embeddings (the
    conv/mel frontend is a stub, as in the reference), plus sinusoidal
    positions built in fp32, then non-causal self-attention with RoPE on
    positions 0..T-1 and SwiGLU per layer, with plain attention on every
    device (``attention.encoder_attn_forward``)."""
    eps = cfg.norm_eps
    x, positions = _encoder_input(frames)

    def body(x, p):
        x = x + attn.encoder_attn_forward(p["attn"], rmsnorm(x, p["norm1"], eps), positions, cfg)
        return x + swiglu(p["dense"], rmsnorm(x, p["norm2"], eps))

    body = _remat(cfg.remat, body)
    blocks = params["encoder"]["blocks"]
    for i in range(cfg.encdec.num_encoder_layers):
        x = body(x, _select(blocks, i))
    return rmsnorm(x, params["encoder"]["final_norm"], eps)


def _memory_from_batch(cfg: ModelConfig, params: dict, batch: dict) -> dict:
    """The cross-attention memory of a multimodal batch: the encoder's
    output for ``frames``, the ``image_embeds`` as they are; empty for a
    text-only batch."""
    memory = {}
    if cfg.encdec is not None and "frames" in batch:
        memory["enc"] = _encode(cfg, params, batch["frames"])
    if cfg.vlm is not None and "image_embeds" in batch:
        memory["image"] = batch["image_embeds"]
    return memory


def forward_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, memory: Optional[dict] = None,
                   collect_cache: bool = False):
    """Embed + full stack. Returns (hidden (B, S, D), caches or None)."""
    lay = stack_layout(cfg)
    memory = memory or {}
    B, S = tokens.shape
    x = constrain(embed(params["embed"], tokens, _model_dtype(cfg), cfg.d_model), ("batch", "seq", "embed"))
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    caches: dict = {}

    def unscanned(section, kinds):
        nonlocal x
        sec = {}
        for i, kind in enumerate(kinds):
            x, sec[f"b{i}"] = _block_forward(cfg, kind, params[section][f"b{i}"], x, positions, memory,
                                             collect_cache)
        caches[section] = sec

    if lay.lead_kinds:
        unscanned("lead", lay.lead_kinds)
    if lay.n_groups:
        def block_step(kind, bp, x):
            return _block_forward(cfg, kind, bp, x, positions, memory, collect_cache)

        if cfg.remat == "inner" and len(lay.unit_kinds) > 1:
            # nested: the group saves its boundary, each block its own
            block_step = _remat("full", block_step)

        def group_body(x, gp):
            cs = {}
            for j, kind in enumerate(lay.unit_kinds):
                x, cs[f"u{j}"] = block_step(kind, gp[f"u{j}"], x)
            return x, cs

        group_body = _remat(cfg.remat, group_body)
        group_caches = []
        for gi in range(lay.n_groups):
            x, cs = group_body(x, _select(params["groups"], gi))
            group_caches.append(cs)
        caches["groups"] = _stack(group_caches)
    if lay.tail_kinds:
        unscanned("tail", lay.tail_kinds)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, (caches if collect_cache else None)


def logits_table(cfg: ModelConfig, params: dict) -> torch.Tensor:
    """The head's table: the embedding itself where the config ties them."""
    return params["embed"] if cfg.tie_embeddings else params["head"]


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (fp32 scalar); per sequence chunk of
    ``cfg.logits_chunk`` when it is set, so the (B, S, V) logits never exist
    whole. Attention and the RG-LRU scan run plain (module docstring)."""
    hidden, _ = forward_hidden(cfg, params, batch["tokens"], memory=_memory_from_batch(cfg, params, batch))
    table = logits_table(cfg, params)
    if cfg.logits_chunk:
        return chunked_xent(hidden, table, batch["labels"], cfg.logits_chunk)
    return softmax_xent(constrain(logits_from_embedding(hidden, table), ("batch", "seq", "vocab")), batch["labels"])


def prefill(cfg: ModelConfig, params: dict, batch: dict):
    """Returns (last-token logits (B, V), caches). A multimodal batch (with
    ``frames`` or ``image_embeds``) also fills the cross caches ``xk`` / ``xv``."""
    hidden, caches = forward_hidden(cfg, params, batch["tokens"], memory=_memory_from_batch(cfg, params, batch),
                                    collect_cache=True)
    return logits_from_embedding(hidden[:, -1, :], logits_table(cfg, params)), caches


def decode_step(cfg: ModelConfig, params: dict, caches: dict, batch: dict):
    """batch: tokens (B, 1), pos (B,), optional active (B,) bool. Returns
    (logits (B, V), new caches).

    Every K/V cache (MLA's ``ckv`` / ``kr``) is written in place (the
    scanned groups' through the views ``_select`` returns) and comes back as
    the same tensor. Every other leaf (a rec block's conv and LRU state, the
    usage masks) is a new tensor (the groups' stacked into one buffer), and
    ``caches`` keeps the state the step started from: a step re-run after an
    expert fault equals one run.
    The caller commits the new state once the step is final
    (``serving.engine.commit_decode_caches``). ``active`` only gates
    usage-mask collection (``Model.decode_step_masked``)."""
    lay = stack_layout(cfg)
    tokens, pos, active = batch["tokens"], batch["pos"], batch.get("active")
    x = embed(params["embed"], tokens, _model_dtype(cfg), cfg.d_model)
    new_caches: dict = {}

    def unscanned(section, kinds):
        nonlocal x
        sec = {}
        for i, kind in enumerate(kinds):
            key = f"b{i}"
            x, sec[key] = _block_decode(cfg, kind, params[section][key], x, pos, caches[section][key], active)
        new_caches[section] = sec

    if lay.lead_kinds:
        unscanned("lead", lay.lead_kinds)
    if lay.n_groups:
        groups: dict = {}
        for gi in range(lay.n_groups):
            gp = _select(params["groups"], gi)
            gc = _select(caches["groups"], gi)
            for j, kind in enumerate(lay.unit_kinds):
                u = f"u{j}"
                x, c = _block_decode(cfg, kind, gp[u], x, pos, gc[u], active)
                out = groups.setdefault(u, {})
                for name, t in c.items():
                    if t is gc[u].get(name):  # written in place through the group's view
                        out[name] = caches["groups"][u][name]
                        continue
                    if name not in out:
                        out[name] = t.new_empty((lay.n_groups, *t.shape))
                    out[name][gi] = t
        new_caches["groups"] = groups
    if lay.tail_kinds:
        unscanned("tail", lay.tail_kinds)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_from_embedding(x[:, 0, :], logits_table(cfg, params))
    return logits, new_caches



# -- the sharded step (every family; ``prefill_sharded``)
#
# Each rank computes on its own blocks: ``params`` are ``Shard`` leaves
# (``sharding.rules.Shard``), the batch entries too (the rank's rows), the
# decode caches its local blocks in their ``cache_axes`` layout. Collectives
# go through ``comm`` (``sharding.comm``). See ``prefill_sharded``.


def _rows(batch: dict) -> tuple:
    """The mesh dims the batch rows are split over, and their layout spec."""
    dims = batch["tokens"].split(0)
    return dims, PartitionSpec(dims or None)


def _sharded_mlp(cfg, p, h, comm, dims, cache: dict, usage_rows=None):
    """The block's MLP on a rank's rows (``moe_forward_sharded`` or
    ``swiglu_sharded``); a MoE block's usage mask goes into ``cache``."""
    if "moe" not in p:
        return swiglu_sharded(p["dense"], h, comm)
    out = moe_mod.moe_forward_sharded(p["moe"], h, cfg, comm, batch_dims=dims, serving=True,
                                      return_usage=cfg.collect_moe_usage, usage_rows=usage_rows)
    if not cfg.collect_moe_usage:
        return out
    cache["moe_usage"] = out[1]
    return out[0]


def _sharded_mixer(cfg, kind, p, h, positions, comm, *, plain: bool):
    """The block's sequence mixer on a rank's blocks, by kind: the RG-LRU
    (``rec``), MLA, or GQA self-attention with the kind's window; attention
    and the scan through their plain versions where ``plain``. Returns (out,
    cache), the cache as the rank computes it (``_mixer_cache`` lays it out)."""
    if kind == "rec":
        return rec_mod.rglru_block_forward_sharded(p["rglru"], h, cfg, comm,
                                                   scan=rglru_scan_plain if plain else None)
    if cfg.mla is not None:
        o, (ckv, kr) = attn.mla_forward_sharded(p["attn"], h, positions, cfg, comm)
        return o, {"ckv": ckv, "kr": kr}
    o, (k, v) = attn.gqa_forward_sharded(p["attn"], h, positions, cfg, comm, causal=True,
                                         window=_kind_window(cfg, kind),
                                         attend=flash_attention_plain if plain else None)
    return o, {"k": k, "v": v}


def _mixer_cache(kind, p, cache: dict, comm, rows) -> dict:
    """A mixer's prefill cache as its blocks of the ``cache_axes`` layout:
    the RG-LRU's conv and LRU state of the rank's channels, K/V or MLA's
    latent rows of the rank's rows."""
    dims, layout = rows
    if kind == "rec":
        chans = p["rglru"]["w_in"].split(1) or None
        layouts = {"conv": PartitionSpec(dims or None, None, chans), "lru": PartitionSpec(dims or None, chans)}
    else:
        layouts = dict.fromkeys(cache, layout)
    return {name: constrain(t, _CACHE_AXES[name], comm=comm, layout=layouts[name]) for name, t in cache.items()}


def _cross_cache(mem_kv: tuple, comm, layout) -> dict:
    """A prefill's cross K/V (every kv head, the rank's rows) as its blocks
    of the cross caches' layout."""
    return {name: constrain(t, _CACHE_AXES[name], comm=comm, layout=layout) for name, t in zip(("xk", "xv"), mem_kv)}


def _xlstm_cache(cfg, kind, p, c: dict, comm, dims) -> dict:
    """An xLSTM block's new state as its blocks of the ``cache_axes``
    layout: computed on the rank's rows, its heads (``xlstm.rank_heads``)
    and, for the mLSTM's conv inputs, its channels (``conv_w``'s block)."""
    heads = "model" if xlstm_mod.rank_heads(cfg, comm)[1] < cfg.num_heads else None
    rows = dims or None
    chans = (p["mlstm"]["conv_w"].split(1) or None) if kind == "m" else None
    return {name: constrain(t, cache_leaf_axes(kind, name), comm=comm,
                            layout=PartitionSpec(rows, None, chans) if name == "conv" else PartitionSpec(rows, heads))
            for name, t in c.items()}


def _xlstm_sharded(kind: str):
    """(params key, prefill form, decode form) of an xLSTM block kind."""
    if kind == "m":
        return "mlstm", xlstm_mod.mlstm_block_forward_sharded, xlstm_mod.mlstm_block_decode_sharded
    return "slstm", xlstm_mod.slstm_block_forward_sharded, xlstm_mod.slstm_block_decode_sharded


def _sharded_block(cfg, kind, p, x, positions, memory, comm, rows):
    """``_block_body`` on a rank's blocks, by kind: an xLSTM block (its own
    projections, no MLP), the VLM's gated ``cross`` block (skipped whole
    without an image, as unsharded), or a mixer (``_sharded_mixer``), then
    Whisper's cross-attention over the encoder output where the batch has
    one, then the MLP. ``memory`` holds the rank's rows of the encoder output
    (``enc``) or of the image embeddings (``image``). Returns (x, cache)."""
    eps = cfg.norm_eps
    dims, layout = rows
    if kind in ("m", "s"):
        key, forward, _ = _xlstm_sharded(kind)
        o, c = forward(p[key], rmsnorm(x, p["norm"].gathered(comm), eps), cfg, comm)
        return constrain(x + o, ("batch", "seq", "embed"), comm=comm, layout=layout), \
            _xlstm_cache(cfg, kind, p, c, comm, dims)
    if kind == "cross":
        if memory.get("image") is None:
            return x, {}
        mem_kv = attn.cross_attn_memory_sharded(p["cross"], memory["image"], cfg, comm)
        x = x + attn.cross_attn_forward_sharded(p["cross"], rmsnorm(x, p["norm1"].gathered(comm), eps), mem_kv, cfg,
                                                comm, gated=True)
        cache, gate = _cross_cache(mem_kv, comm, layout), torch.tanh(p["gate_ffn"].gathered(comm).to(x.dtype))
    else:
        o, cache = _sharded_mixer(cfg, kind, p, rmsnorm(x, p["norm1"].gathered(comm), eps), positions, comm,
                                  plain=_PLAIN_VERSIONS.on)
        cache = _mixer_cache(kind, p, cache, comm, rows)
        x = x + o
        if cfg.encdec is not None and memory.get("enc") is not None:
            mem_kv = attn.cross_attn_memory_sharded(p["cross"], memory["enc"], cfg, comm)
            x = x + attn.cross_attn_forward_sharded(p["cross"], rmsnorm(x, p["norm_x"].gathered(comm), eps), mem_kv,
                                                    cfg, comm)
            cache.update(_cross_cache(mem_kv, comm, layout))
        gate = None
    y = _sharded_mlp(cfg, p, rmsnorm(x, p["norm2"].gathered(comm), eps), comm, dims, cache)
    x = x + (y if gate is None else gate * y)
    return constrain(x, ("batch", "seq", "embed"), comm=comm, layout=layout), cache


def _encode_sharded(cfg: ModelConfig, params: dict, frames: torch.Tensor, comm) -> torch.Tensor:
    """``_encode`` on a rank's rows of ``frames``: each layer's
    self-attention through ``gqa_forward_sharded`` (not causal, plain on
    every device, as the reference's encoder), its SwiGLU through
    ``swiglu_sharded``, each layer under ``cfg.remat`` as ``_encode``'s."""
    eps = cfg.norm_eps
    x, positions = _encoder_input(frames)

    def body(x, p):
        x = x + attn.gqa_forward_sharded(p["attn"], rmsnorm(x, p["norm1"].gathered(comm), eps), positions, cfg, comm,
                                         causal=False, attend=flash_attention_plain)[0]
        return x + swiglu_sharded(p["dense"], rmsnorm(x, p["norm2"].gathered(comm), eps), comm)

    body = _remat(cfg.remat, body)
    blocks = params["encoder"]["blocks"]
    for i in range(cfg.encdec.num_encoder_layers):
        x = body(x, _select(blocks, i))
    return rmsnorm(x, params["encoder"]["final_norm"].gathered(comm), eps)


def _memory_sharded(cfg: ModelConfig, params: dict, batch: dict, comm) -> dict:
    """``_memory_from_batch`` on a rank's rows: the encoder's output for
    ``frames`` (``_encode_sharded``), the rank's rows of ``image_embeds``;
    empty for a text-only batch."""
    memory = {}
    if cfg.encdec is not None and "frames" in batch:
        memory["enc"] = _encode_sharded(cfg, params, batch["frames"].local, comm)
    if cfg.vlm is not None and "image_embeds" in batch:
        memory["image"] = batch["image_embeds"].local
    return memory


def _sharded_sections(cfg: ModelConfig):
    """(section, key, kind, group) of every block in stack order; ``group``
    is the scanned group's index (None for lead / tail blocks)."""
    lay = stack_layout(cfg)
    out = [("lead", f"b{i}", kind, None) for i, kind in enumerate(lay.lead_kinds)]
    for gi in range(lay.n_groups):
        out += [("groups", f"u{j}", kind, gi) for j, kind in enumerate(lay.unit_kinds)]
    return out + [("tail", f"b{i}", kind, None) for i, kind in enumerate(lay.tail_kinds)]


def prefill_sharded(cfg: ModelConfig, params: dict, batch: dict, comm):
    """``prefill`` on a rank's blocks, for every family. Returns (this
    rank's (rows, vocab rows) block of the last-token logits, caches): DP
    splits the rows over ``batch``'s mesh dims; FSDP gathers each weight's
    ``embed`` dim over ``data`` at its use; TP keeps heads and ``ffn``
    column-parallel and the output projections row-parallel (all-reduced
    over ``model``); EP or TP-within-expert as the rules resolve
    ``experts``; the embedding and the head (a tied model's one table) are
    vocab-parallel. Blocks dispatch by kind (``_sharded_block``): GQA with
    the kind's window, MLA, the RG-LRU on the rank's channels, the mLSTM /
    sLSTM on the rank's heads (``xlstm.rank_heads``), the VLM's gated cross
    block and Whisper's cross-attention over a multimodal batch's memory
    (``frames`` through the encoder on the rank's rows, or
    ``image_embeds``). Each cache comes out as its block of the
    ``cache_axes`` layout (K/V and MLA's latent rows with ``kv_seq`` over
    ``model``, cross K/V and the recurrent states with ``kv_heads`` /
    ``heads`` / channels over ``model`` where the rules split them), the
    usage masks whole. On a mesh of 1s the collectives are no-ops and the
    math is ``prefill``'s."""
    rows = _rows(batch)
    tokens = batch["tokens"].local
    B, S = tokens.shape
    memory = _memory_sharded(cfg, params, batch, comm)
    x = embed_sharded(params["embed"], tokens, _model_dtype(cfg), cfg.d_model, comm)
    x = constrain(x, ("batch", "seq", "embed"), comm=comm, layout=rows[1])
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    caches: dict = {}
    groups: dict = {}
    for section, key, kind, gi in _sharded_sections(cfg):
        p = params[section][key] if gi is None else _select(params[section], gi)[key]
        x, c = _sharded_block(cfg, kind, p, x, positions, memory, comm, rows)
        if gi is None:
            caches.setdefault(section, {})[key] = c
        else:
            groups.setdefault(key, []).append(c)
    if groups:
        caches["groups"] = {key: _stack(cs) for key, cs in groups.items()}
    x = rmsnorm(x[:, -1, :], params["final_norm"].gathered(comm), cfg.norm_eps)
    table = logits_table(cfg, params)
    return logits_sharded(x, table.gathered(comm, ("data",))), caches


# the leaves besides ``embed`` that the loss reads in fp32 whatever
# ``cfg.dtype``: a MoE router, the RG-LRU's gate biases and decay, the
# mLSTM's gate bias, the xLSTM's group-norm scales and the sLSTM's recurrent
# weights (multiplied with its fp32 state)
_FP32_LEAVES = ("router", "b_r", "b_i", "lam", "b_if", "gn_scale", "r_zifo")


def master_compute_dtype(cfg: ModelConfig, path: str) -> torch.dtype:
    """The dtype the loss reads leaf ``path`` in, to which a sharded train
    step casts its fp32 master block once a step: fp32 for the embedding
    table (``embed`` looks its rows up in fp32 and casts them, so the
    gradients of a repeated token add in fp32; a tied head casts the same
    fp32 block), for the head under ``cfg.logits_chunk`` (each chunk casts
    it, so the chunks' gradients add in fp32) and for the leaves of
    ``_FP32_LEAVES`` (a MoE router, which ``moe.router_probs`` reads in
    fp32, the RG-LRU's ``b_r`` / ``b_i`` / ``lam``, the mLSTM's ``b_if``, the
    xLSTM's ``gn_scale`` and the sLSTM's ``r_zifo``); ``cfg.dtype`` for every
    other leaf."""
    fp32 = path == "embed" or (path == "head" and cfg.logits_chunk) or path.rsplit(".", 1)[-1] in _FP32_LEAVES
    return torch.float32 if fp32 else _model_dtype(cfg)


def _train_block_sharded(cfg, kind, p, x, positions, memory, comm, dims):
    """``_block_body`` for the loss on a rank's blocks, by kind as
    ``_sharded_block`` dispatches, with the caches dropped: an xLSTM block
    on the rank's heads, the VLM's gated ``cross`` block (skipped whole
    without an image), or the mixer of ``_sharded_mixer`` through the plain
    versions, then Whisper's cross-attention over the encoder output where
    the batch has one; then the MLP, the MoE at training's capacity over the
    global token count."""
    eps = cfg.norm_eps
    if kind in ("m", "s"):
        key, forward, _ = _xlstm_sharded(kind)
        return x + forward(p[key], rmsnorm(x, p["norm"].gathered(comm), eps), cfg, comm)[0]
    if kind == "cross":
        if memory.get("image") is None:
            return x
        mem_kv = attn.cross_attn_memory_sharded(p["cross"], memory["image"], cfg, comm)
        x = x + attn.cross_attn_forward_sharded(p["cross"], rmsnorm(x, p["norm1"].gathered(comm), eps), mem_kv, cfg,
                                                comm, gated=True)
        gate = torch.tanh(p["gate_ffn"].gathered(comm).to(x.dtype))
    else:
        o, _ = _sharded_mixer(cfg, kind, p, rmsnorm(x, p["norm1"].gathered(comm), eps), positions, comm, plain=True)
        x = x + o
        if cfg.encdec is not None and memory.get("enc") is not None:
            mem_kv = attn.cross_attn_memory_sharded(p["cross"], memory["enc"], cfg, comm)
            x = x + attn.cross_attn_forward_sharded(p["cross"], rmsnorm(x, p["norm_x"].gathered(comm), eps), mem_kv,
                                                    cfg, comm)
        gate = None
    h = rmsnorm(x, p["norm2"].gathered(comm), eps)
    if "moe" in p:
        y = moe_mod.moe_forward_sharded(p["moe"], h, cfg, comm, batch_dims=dims, serving=False)
    else:
        y = swiglu_sharded(p["dense"], h, comm)
    return x + (y if gate is None else gate * y)


def loss_fn_sharded(cfg: ModelConfig, params: dict, batch: dict, comm) -> torch.Tensor:
    """``loss_fn`` on a rank's blocks, for every family: this rank's share
    of the global mean next-token cross-entropy (its rows' mean over the
    ``data`` size; the shares of the ``data`` ranks sum to the loss, and the
    ``model`` ranks of one row block hold the same share).

    ``params`` are ``Shard`` leaves whose ``master`` is the fp32 block the
    gradient lands in. Each weight is all-gathered over ``data`` at its use
    and its gradient reduce-scattered into the master block in the backward
    (``Shard.gathered``). TP, EP and the vocab-parallel embedding are
    ``prefill_sharded``'s, and so is each block by kind
    (``_train_block_sharded``: GQA with the kind's window, MLA, the RG-LRU on
    the rank's channels, the mLSTM / sLSTM on the rank's heads, the VLM's
    gated cross block, Whisper's cross-attention), the routing global at
    training's capacity, and the memory of a multimodal batch
    (``_memory_sharded``: ``frames`` through the encoder on the rank's rows,
    or the rank's rows of ``image_embeds``); the cross-entropy is
    vocab-parallel (``layers.xent_sharded``), per ``cfg.logits_chunk`` chunk
    when it is set. A tied table is read twice, by the embedding and by the
    head, and both reads' gradients add into its one fp32 master block.
    ``cfg.remat`` wraps each encoder layer and each scanned group (and,
    under "inner", each block of a multi-block group), as ``_encode`` and
    ``forward_hidden`` do; its checkpoints are non-reentrant, so a
    recomputed forward issues its collectives in the same order on every
    rank. On a mesh of 1s every collective is skipped and the math is
    ``loss_fn``'s."""
    dims = batch["tokens"].split(0)
    tokens, labels = batch["tokens"].local, batch["labels"].local
    B, S = tokens.shape
    memory = _memory_sharded(cfg, params, batch, comm)
    x = embed_sharded(params["embed"], tokens, _model_dtype(cfg), cfg.d_model, comm)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    lay = stack_layout(cfg)

    def block(kind, p, x):
        return _train_block_sharded(cfg, kind, p, x, positions, memory, comm, dims)

    for i, kind in enumerate(lay.lead_kinds):
        x = block(kind, params["lead"][f"b{i}"], x)
    if lay.n_groups:
        block_step = _remat("full", block) if cfg.remat == "inner" and len(lay.unit_kinds) > 1 else block

        def group_body(x, gp):
            for j, kind in enumerate(lay.unit_kinds):
                x = block_step(kind, gp[f"u{j}"], x)
            return x

        group_body = _remat(cfg.remat, group_body)
        for gi in range(lay.n_groups):
            x = group_body(x, _select(params["groups"], gi))
    for i, kind in enumerate(lay.tail_kinds):
        x = block(kind, params["tail"][f"b{i}"], x)
    x = rmsnorm(x, params["final_norm"].gathered(comm), cfg.norm_eps)
    loss = xent_sharded(x, logits_table(cfg, params), labels, cfg.logits_chunk, comm)
    return loss / comm.size("data")


def _sharded_decode_mixer(cfg, kind, p, h, pos, cache: dict, specs: dict, lead: int, comm):
    """``_sharded_mixer`` for one decode step: the rank's blocks of the
    caches (their specs in ``specs``; ``lead`` axes before the batch axis)
    read, K/V or the latent rows written in place, or the RG-LRU's new
    state of the rank's channels. Returns (out, cache)."""
    if kind == "rec":  # no slot axis: the state of the rank's channels, split as its params'
        if spec_dims(specs["lru"], lead + 1) != p["rglru"]["w_in"].split(1):
            raise ValueError(f"an LRU state split as {specs['lru']} against weights whose channels are split "
                             f"over {p['rglru']['w_in'].split(1)}")
        return rec_mod.rglru_block_decode_sharded(p["rglru"], h, cache, cfg, comm)
    if cfg.mla is not None:
        o, ckv, kr = attn.mla_decode_sharded(p["attn"], h, pos, cache["ckv"], cache["kr"], cfg, comm,
                                             seq_dims=spec_dims(specs["ckv"], lead + 1))
        return o, {"ckv": ckv, "kr": kr}
    seq_dims = spec_dims(specs["k"], lead + 1)  # the slot axis
    window = _kind_window(cfg, kind)
    n_slots = cache["k"].shape[1] * math.prod(comm.size(a) for a in seq_dims)
    o, k, v = attn.gqa_decode_sharded(p["attn"], h, pos, cache["k"], cache["v"], cfg, comm, seq_dims=seq_dims,
                                      rolling_window=window if window is not None and n_slots == window else None)
    return o, {"k": k, "v": v}


def _check_xlstm_state(cfg, kind, p, specs: dict, lead: int, comm) -> None:
    """An xLSTM decode state must be split as the sharded step computes it:
    its ``heads`` axis over ``model`` exactly where the rank runs its own
    heads, the mLSTM's conv channels as ``conv_w``'s."""
    def split(dims: tuple) -> tuple:  # a mesh dim of size 1 splits nothing
        return tuple(d for d in dims if comm.size(d) > 1)

    heads = ("model",) if xlstm_mod.rank_heads(cfg, comm)[1] < cfg.num_heads else ()
    leaf = "C" if kind == "m" else "c"
    if split(spec_dims(specs[leaf], lead + 1)) != heads:
        raise ValueError(f"an xLSTM state split as {specs[leaf]} against a step that runs heads split over {heads}")
    if kind == "m" and split(spec_dims(specs["conv"], lead + 2)) != split(p["mlstm"]["conv_w"].split(1)):
        raise ValueError(f"an mLSTM conv state split as {specs['conv']} against weights whose channels are split "
                         f"over {p['mlstm']['conv_w'].split(1)}")


def _sharded_decode_block(cfg, kind, p, x, pos, cache: dict, specs: dict, lead: int, comm, dims, usage_rows):
    """``_block_decode`` on a rank's blocks, by kind (see ``_sharded_block``):
    cross K/V (``xk`` / ``xv``, a multimodal cache's) are read as the rank's
    blocks and come back as the same tensors; an xLSTM block's state of the
    rank's heads comes back as new tensors. Returns (x, cache)."""
    eps = cfg.norm_eps
    if kind in ("m", "s"):
        _check_xlstm_state(cfg, kind, p, specs, lead, comm)
        key, _, decode = _xlstm_sharded(kind)
        o, c = decode(p[key], rmsnorm(x, p["norm"].gathered(comm), eps), cache, cfg, comm)
        return x + o, c
    if kind == "cross":
        if "xk" not in cache:
            return x, {}
        x = x + attn.cross_attn_forward_sharded(p["cross"], rmsnorm(x, p["norm1"].gathered(comm), eps),
                                                (cache["xk"], cache["xv"]), cfg, comm, gated=True)
        c, gate = {"xk": cache["xk"], "xv": cache["xv"]}, torch.tanh(p["gate_ffn"].gathered(comm).to(x.dtype))
    else:
        o, c = _sharded_decode_mixer(cfg, kind, p, rmsnorm(x, p["norm1"].gathered(comm), eps), pos, cache, specs,
                                     lead, comm)
        x = x + o
        if cfg.encdec is not None and "xk" in cache:
            x = x + attn.cross_attn_forward_sharded(p["cross"], rmsnorm(x, p["norm_x"].gathered(comm), eps),
                                                    (cache["xk"], cache["xv"]), cfg, comm)
            c.update(xk=cache["xk"], xv=cache["xv"])
        gate = None
    y = _sharded_mlp(cfg, p, rmsnorm(x, p["norm2"].gathered(comm), eps), comm, dims, c, usage_rows)
    return x + (y if gate is None else gate * y), c


def decode_step_sharded(cfg: ModelConfig, params: dict, caches: dict, batch: dict, comm, cache_specs: dict):
    """``decode_step`` on a rank's blocks (see ``prefill_sharded``):
    ``caches`` are this rank's blocks in the ``cache_specs`` layout, K/V
    (MLA's latent rows) written in place by the rank that holds the new
    slot; the attention is combined over the slot axis's mesh dims
    (split-KV); cross K/V are only read; a rec or xLSTM block's state comes
    back as new tensors, committed once as ``decode_step``'s are.
    ``active`` (whole batch, gathered from the rows) gates the usage masks
    as in ``decode_step``. Returns (the logits block, new caches)."""
    rows = _rows(batch)
    dims, layout = rows
    tokens, pos = batch["tokens"].local, batch["pos"].local
    usage_rows = None
    if "active" in batch:
        usage_rows = batch["active"].local.to(torch.int32)
        for ax in reversed(dims):
            usage_rows = comm.all_gather(usage_rows, ax, 0)
        usage_rows = usage_rows.to(torch.bool)[:, None]
    x = embed_sharded(params["embed"], tokens, _model_dtype(cfg), cfg.d_model, comm)
    new_caches: dict = {}
    for section, key, kind, gi in _sharded_sections(cfg):
        p = params[section][key] if gi is None else _select(params[section], gi)[key]
        cache = caches[section][key] if gi is None else _select(caches[section], gi)[key]
        # a scanned group's cache leaves lead with the stacked axis
        x, c = _sharded_decode_block(cfg, kind, p, x, pos, cache, cache_specs[section][key], 0 if gi is None else 1,
                                     comm, dims, usage_rows)
        x = constrain(x, ("batch", "seq", "embed"), comm=comm, layout=layout)
        if gi is None:
            new_caches.setdefault(section, {})[key] = c
            continue
        out_c = new_caches.setdefault(section, {}).setdefault(key, {})
        for name, t in c.items():
            if t is cache.get(name):  # written in place (or only read) through the group's view
                out_c[name] = caches[section][key][name]
            else:
                if name not in out_c:
                    out_c[name] = t.new_empty((stack_layout(cfg).n_groups, *t.shape))
                out_c[name][gi] = t
    x = rmsnorm(x[:, 0, :], params["final_norm"].gathered(comm), cfg.norm_eps)
    table = logits_table(cfg, params)
    return logits_sharded(x, table.gathered(comm, ("data",))), new_caches

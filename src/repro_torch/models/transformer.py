"""Decoder-stack assembly for uniform attention stacks with a dense (SwiGLU)
or MoE MLP — the Mixtral family plus the dense Yi / Phi-3 / Mistral-Large
configs — for Gemma-3's 5:1 local/global stack, for DeepSeek-V2-Lite's MLA
stack with its dense lead layer and fine-grained MoE, and for
RecurrentGemma's hybrid rec/rec/attn stack (``repro.models.transformer``
counterpart).

Layers are grouped into scanned units with stacked parameters
(``groups.u{j}.*``, leading axis = group), plus unscanned ``lead.b{i}`` /
``tail.b{i}`` blocks where the depth is not a whole number of units,
exactly as the reference lays them out, so one artifact serves both
packages. A Python loop over the groups takes the place of ``lax.scan``.

Entry points: ``prefill`` (last-token logits + caches) and ``decode_step``
(one token against the caches).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.layers import (
    embed,
    embedding_spec,
    logits_from_embedding,
    rmsnorm,
    rmsnorm_spec,
    swiglu,
    swiglu_spec,
)
from repro_torch.models.spec import ParamSpec, stack_specs


def check_supported(cfg: ModelConfig) -> None:
    """The port covers self-attention stacks (GQA, local/global, MLA) with
    dense or routed MLPs and the RG-LRU hybrid; xLSTM, the encoder-decoder
    and the vision-language families are still to be ported."""
    unsupported = [name for name in ("xlstm", "encdec", "vlm") if getattr(cfg, name) is not None]
    if unsupported:
        raise NotImplementedError(f"{cfg.name}: {', '.join(unsupported)} not ported yet")


def _mlp_spec(cfg: ModelConfig, layer_idx: int) -> dict:
    if cfg.moe is not None:
        if layer_idx < cfg.moe.first_dense_layers:
            return {"dense": swiglu_spec(cfg.d_model, cfg.moe.dense_d_ff or cfg.d_ff)}
        return {"moe": moe_mod.moe_spec(cfg)}
    return {"dense": swiglu_spec(cfg.d_model, cfg.d_ff)}


def block_spec(cfg: ModelConfig, kind: str, layer_idx: int) -> dict:
    d = cfg.d_model
    if kind in ("self", "local", "global", "attn"):
        mixer = {"attn": attn.mla_spec(cfg) if cfg.mla is not None else
                 attn.gqa_spec(d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)}
    elif kind == "rec":
        mixer = {"rglru": rec_mod.rglru_block_spec(cfg)}
    else:
        raise ValueError(f"block kind {kind!r} is not ported")
    return {"norm1": rmsnorm_spec(d), **mixer, "norm2": rmsnorm_spec(d), **_mlp_spec(cfg, layer_idx)}


@dataclass(frozen=True)
class StackLayout:
    lead_kinds: tuple  # unscanned blocks before the groups
    unit_kinds: tuple  # kinds inside one scanned group
    n_groups: int
    tail_kinds: tuple  # unscanned blocks after the groups


def stack_layout(cfg: ModelConfig) -> StackLayout:
    check_supported(cfg)
    kinds = list(cfg.attn_kinds)
    lead = cfg.moe.first_dense_layers if cfg.moe else 0
    rest = kinds[lead:]
    if cfg.recurrent is not None:
        unit = len(cfg.recurrent.pattern)
    elif cfg.local_global_pattern is not None:
        unit = sum(cfg.local_global_pattern)
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
    return spec


def _kind_window(cfg: ModelConfig, kind: str) -> Optional[int]:
    if kind == "attn":  # RecurrentGemma's local attention
        return cfg.recurrent.window
    if kind == "local":  # Gemma-3's local layers
        return cfg.sliding_window
    if kind == "global":
        return None
    return cfg.sliding_window  # "self": SWA if the config sets it (Mixtral)


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


def _block_forward(cfg, kind, params, x, positions, collect_cache):
    cache = {}
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    if kind == "rec":
        o, c = rec_mod.rglru_block_forward(params["rglru"], h, cfg)
    elif cfg.mla is not None:
        o, (ckv, kr) = attn.mla_forward(params["attn"], h, positions, cfg)
        c = {"ckv": ckv, "kr": kr}
    else:
        o, (k, v) = attn.gqa_forward(params["attn"], h, positions, cfg,
                                     causal=True, window=_kind_window(cfg, kind))
        c = {"k": k, "v": v}
    if collect_cache:
        cache.update(c)
    x = x + o
    h2 = rmsnorm(x, params["norm2"], cfg.norm_eps)
    y, usage = _mlp_apply(cfg, params, h2, serving=collect_cache)
    x = x + y
    if collect_cache and usage is not None:
        cache["moe_usage"] = usage  # rides the cache; the engine strips it
    return x, cache


def _block_decode(cfg, kind, params, x, pos, cache, active=None):
    """x (B, 1, D); returns (x, new_cache). K/V (MLA's latent ``ckv`` and
    ``kr``) are written into ``cache``'s tensors in place and come back as
    the same tensors; a rec block's conv and LRU state come back as new
    tensors, ``cache``'s left as they were.
    ``active`` (B,) bool marks the rows whose routing counts toward the usage
    mask (None: every row)."""
    new_cache = dict(cache)
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
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
    h2 = rmsnorm(x, params["norm2"], cfg.norm_eps)
    y, usage = _mlp_apply(cfg, params, h2, serving=True,
                          usage_rows=active[:, None] if active is not None else None)
    x = x + y
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


def _model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def forward_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, collect_cache: bool = False):
    """Embed + full stack. Returns (hidden (B, S, D), caches or None)."""
    lay = stack_layout(cfg)
    B, S = tokens.shape
    x = embed(params["embed"], tokens, _model_dtype(cfg), cfg.d_model)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    caches: dict = {}

    def unscanned(section, kinds):
        nonlocal x
        sec = {}
        for i, kind in enumerate(kinds):
            x, sec[f"b{i}"] = _block_forward(cfg, kind, params[section][f"b{i}"], x, positions, collect_cache)
        caches[section] = sec

    if lay.lead_kinds:
        unscanned("lead", lay.lead_kinds)
    if lay.n_groups:
        group_caches = []
        for gi in range(lay.n_groups):
            gp = _select(params["groups"], gi)
            cs = {}
            for j, kind in enumerate(lay.unit_kinds):
                x, cs[f"u{j}"] = _block_forward(cfg, kind, gp[f"u{j}"], x, positions, collect_cache)
            group_caches.append(cs)
        caches["groups"] = _stack(group_caches)
    if lay.tail_kinds:
        unscanned("tail", lay.tail_kinds)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, (caches if collect_cache else None)


def _logits_table(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["head"]


def prefill(cfg: ModelConfig, params: dict, batch: dict):
    """Returns (last-token logits (B, V), caches)."""
    hidden, caches = forward_hidden(cfg, params, batch["tokens"], collect_cache=True)
    return logits_from_embedding(hidden[:, -1, :], _logits_table(cfg, params)), caches


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
    logits = logits_from_embedding(x[:, 0, :], _logits_table(cfg, params))
    return logits, new_caches


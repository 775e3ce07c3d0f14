"""GQA attention with RoPE: prefill (causal / sliding window) through the
flash-attention wrapper, one-token decode over linear and rolling KV
caches, and one-token decode over a paged KV pool; DeepSeek's MLA
(expanded prefill, absorbed decode over the latent cache); cross-attention
over an encoder's or an image's memory (Whisper's decoder, Llama-3.2-Vision's
gated image layers) (``repro.models.attention`` counterpart).

Prefill attention goes through ``kernels.flash_attention.ops.
flash_attention`` and paged decode through ``kernels.decode_attention.ops.
paged_decode_attention``, each by device: the CUDA kernel for CUDA tensors,
its plain version for CPU tensors. ``cfg.use_pallas`` is not consulted. The
dense decode calls ``decode_attention_plain`` on every device, as the
reference's calls ``decode_attention_jnp``. MLA's prefill attention is
``flash_attention_plain`` on every device, as the reference's calls
``flash_attention_jnp`` directly: its qk head dim (192 at full width) is not
one the kernel takes, and the reference has no kernel there. The kernel is
reached only through ``gqa_forward``: every attention the reference runs
plain calls ``flash_attention_plain`` itself, with no flag to choose. Those
are MLA's prefill, cross-attention (not causal) and the Whisper encoder's
self-attention (``encoder_attn_forward``). The training loss passes
``flash_attention_plain`` to ``gqa_forward`` as its ``attend``: no kernel
has a backward, and the reference trains with ``use_pallas=False``.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Callable, Optional

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels.decode_attention.ops import NEG_INF, decode_attention_plain, paged_decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.spec import ParamSpec


def gqa_spec(d_model: int, num_heads: int, num_kv_heads: int, head_dim: int) -> dict:
    return {
        "wq": ParamSpec((d_model, num_heads * head_dim), ("embed", "heads")),
        "wk": ParamSpec((d_model, num_kv_heads * head_dim), ("embed", "kv_heads")),
        "wv": ParamSpec((d_model, num_kv_heads * head_dim), ("embed", "kv_heads")),
        "wo": ParamSpec((num_heads * head_dim, d_model), ("heads", "embed")),
    }


def cross_attn_spec(d_model: int, num_heads: int, num_kv_heads: int, head_dim: int, mem_dim: int) -> dict:
    """A gated image cross-attention's weights, each ``modal:image`` (only a
    multimodal entry reaches them): ``wk`` / ``wv`` read the image memory's
    ``mem_dim``, and the tanh ``gate`` starts at zero."""
    gqa = gqa_spec(d_model, num_heads, num_kv_heads, head_dim)
    spec = {k: replace(s, access="modal:image") for k, s in gqa.items()}
    spec["wk"] = ParamSpec((mem_dim, num_kv_heads * head_dim), ("embed", "kv_heads"), access="modal:image")
    spec["wv"] = ParamSpec((mem_dim, num_kv_heads * head_dim), ("embed", "kv_heads"), access="modal:image")
    spec["gate"] = ParamSpec((1,), (None,), init="zeros", access="modal:image")
    return spec


def mla_spec(cfg: ModelConfig) -> dict:
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": ParamSpec((d, H * qd), ("embed", "heads")),
        "w_dkv": ParamSpec((d, m.kv_lora_rank), ("embed", None)),
        "w_kr": ParamSpec((d, m.qk_rope_head_dim), ("embed", None)),
        "kv_norm": ParamSpec((m.kv_lora_rank,), (None,), init="ones"),
        "w_uk": ParamSpec((m.kv_lora_rank, H * m.qk_nope_head_dim), (None, "heads")),
        "w_uv": ParamSpec((m.kv_lora_rank, H * m.v_head_dim), (None, "heads")),
        "wo": ParamSpec((H * m.v_head_dim, d), ("heads", "embed")),
    }


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


def _qkv(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    q = _split_heads(x @ params["wq"].to(x.dtype), H)
    k = _split_heads(x @ params["wk"].to(x.dtype), Hkv)
    v = _split_heads(x @ params["wv"].to(x.dtype), Hkv)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def gqa_forward(
    params: dict,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    attend: Optional[Callable] = None,
):
    """Prefill/forward attention; returns ``(out, (k, v))`` with the roped
    keys and the values for the cache. ``attend`` is the attention itself:
    None for this module's ``flash_attention`` (the kernel's wrapper, looked
    up at the call), or ``flash_attention_plain`` named by a caller that
    needs a backward (the training loss)."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(params, x, positions, cfg)
    o = (attend or flash_attention)(q, k, v, causal=causal, window=window, softcap=cfg.attn_logit_softcap)
    out = o.reshape(*o.shape[:2], H * hd) @ params["wo"].to(x.dtype)
    return out, (k, v)


def encoder_attn_forward(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The Whisper encoder's self-attention: RoPE, not causal, plain on every
    device, as the reference's encoder calls ``gqa_forward`` without
    ``use_pallas``."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(params, x, positions, cfg)
    o = flash_attention_plain(q, k, v, causal=False, softcap=cfg.attn_logit_softcap)
    return o.reshape(*o.shape[:2], H * hd) @ params["wo"].to(x.dtype)


def _scatter_rows(cache: torch.Tensor, slot: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """cache (B, S, ...), slot (B,), row (B, ...): writes row at [b, slot[b]]
    in place and returns ``cache`` itself. The reference builds a new cache;
    in place, a step moves one row instead of the whole cache, and the cache
    keeps the fixed address a captured CUDA graph reads it at. Re-running a
    step rewrites the same rows, so a retried step equals a single one."""
    b = torch.arange(cache.shape[0], device=cache.device)
    return cache.index_put_((b, slot.long()), row.to(cache.dtype))


def gqa_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, D)
    pos: torch.Tensor,  # (B,) absolute position of the new token
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cfg: ModelConfig,
    *,
    rolling_window: Optional[int] = None,
):
    """One decode step; returns (out, k_cache, v_cache): the caches it was
    given, with the new token's K/V written in place. Linear cache: write at
    pos. Rolling cache: write at pos % window (softmax is order-invariant, so
    slot order does not matter; the row overwritten has left the window)."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    B = x.shape[0]
    q, k, v = _qkv(params, x, pos[:, None], cfg)
    slot = pos % rolling_window if rolling_window else pos
    k_cache = _scatter_rows(k_cache, slot, k[:, 0])
    v_cache = _scatter_rows(v_cache, slot, v[:, 0])
    o = decode_attention_plain(
        q[:, 0], k_cache, v_cache, pos + 1,
        rolling=rolling_window is not None, softcap=cfg.attn_logit_softcap,
    )
    out = o.reshape(B, H * hd) @ params["wo"].to(x.dtype)
    return out[:, None, :], k_cache, v_cache


def paged_kv_write(
    k_pages: torch.Tensor,  # (P, ps, Hkv, hd)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, NP)
    slot: torch.Tensor,  # (B,) logical cache slot (pos, or pos % window)
    k_new: torch.Tensor,  # (B, Hkv, hd)
    v_new: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one token's K/V at logical slot ``slot[b]`` of each sequence:
    physical page ``page_table[b, slot // ps]``, offset ``slot % ps``.
    Unlike the reference's functional update, the pool is written in place
    (a copy of the whole pool per token would dwarf the step) and the same
    tensors are returned. Distinct sequences own disjoint pages, so the
    writes never collide."""
    ps = k_pages.shape[1]
    phys = torch.gather(page_table.long(), 1, (slot // ps).long()[:, None])[:, 0]
    off = (slot % ps).long()
    k_pages[phys, off] = k_new.to(k_pages.dtype)
    v_pages[phys, off] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def paged_gqa_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, D)
    pos: torch.Tensor,  # (B,) absolute position of the new token
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    cfg: ModelConfig,
    *,
    rolling_window: Optional[int] = None,
):
    """One decode step over a paged KV cache; returns (out, k_pages,
    v_pages). The contract of ``gqa_decode`` with the (B, Skv, ...) slot
    cache replaced by pool + page table; the attention is
    ``paged_decode_attention`` (the reference's ``use_pallas`` branch)."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    B = x.shape[0]
    q, k, v = _qkv(params, x, pos[:, None], cfg)
    slot = pos % rolling_window if rolling_window else pos
    k_pages, v_pages = paged_kv_write(k_pages, v_pages, page_table, slot, k[:, 0], v[:, 0])
    o = paged_decode_attention(
        q[:, 0], k_pages, v_pages, page_table, pos + 1,
        rolling=rolling_window is not None, softcap=cfg.attn_logit_softcap,
    )
    out = o.reshape(B, H * hd) @ params["wo"].to(x.dtype)
    return out[:, None, :], k_pages, v_pages


def _mla_q(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """(q_nope (B, S, H, nope), roped q_rope (B, S, H, rope))."""
    m = cfg.mla
    q = _split_heads(x @ params["wq"].to(x.dtype), cfg.num_heads)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """The cache rows of ``x`` (B, S, D): normed latent c_kv (B, S, r) and
    roped shared rope key k_r (B, S, rope)."""
    c_kv = rmsnorm(x @ params["w_dkv"].to(x.dtype), params["kv_norm"], cfg.norm_eps)
    k_r = apply_rope((x @ params["w_kr"].to(x.dtype))[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_r


def mla_forward(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """Prefill with the heads expanded; returns ``(out, (c_kv, k_r))``, the
    latent cache rows. v is zero-padded to the qk head dim for the attention
    and trimmed back, as in the reference."""
    m, H = cfg.mla, cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    c_kv, k_r = _mla_latent(params, x, positions, cfg)
    k_nope = _split_heads(c_kv @ params["w_uk"].to(x.dtype), H)
    value = _split_heads(c_kv @ params["w_uv"].to(x.dtype), H)
    k_full = torch.cat([k_nope, k_r[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    v_pad = torch.nn.functional.pad(value, (0, qd - m.v_head_dim))
    o = flash_attention_plain(q_full, k_full, v_pad, causal=True)[..., : m.v_head_dim]
    out = o.reshape(B, S, H * m.v_head_dim) @ params["wo"].to(x.dtype)
    return out, (c_kv, k_r)


def mla_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, D)
    pos: torch.Tensor,  # (B,)
    ckv_cache: torch.Tensor,  # (B, S, r)
    kr_cache: torch.Tensor,  # (B, S, rope)
    cfg: ModelConfig,
):
    """Absorbed decode: W_uk is folded into the query, and the scores are
    taken against the latent cache and the rope keys directly (no per-step
    K/V expansion). Returns (out, ckv_cache, kr_cache): the caches it was
    given, with the new token's rows written in place at ``pos``."""
    m, H = cfg.mla, cfg.num_heads
    B = x.shape[0]
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    q_nope, q_rope = _mla_q(params, x, pos[:, None], cfg)
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]  # (B, H, nope), (B, H, rope)
    c_new, kr_new = _mla_latent(params, x, pos[:, None], cfg)
    ckv_cache = _scatter_rows(ckv_cache, pos, c_new[:, 0])
    kr_cache = _scatter_rows(kr_cache, pos, kr_new[:, 0])

    w_uk = params["w_uk"].to(x.dtype).reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)  # W_uk absorbed into q
    ckv = ckv_cache.to(torch.float32)
    s = torch.einsum("bhr,bsr->bhs", q_lat.to(torch.float32), ckv)
    s = s + torch.einsum("bhr,bsr->bhs", q_rope.to(torch.float32), kr_cache.to(torch.float32))
    s = s * scale
    valid = torch.arange(ckv_cache.shape[1], device=x.device)[None, :] < (pos + 1)[:, None]
    p = torch.softmax(torch.where(valid[:, None, :], s, NEG_INF), dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", p, ckv).to(x.dtype)
    w_uv = params["w_uv"].to(x.dtype).reshape(m.kv_lora_rank, H, m.v_head_dim)
    o = torch.einsum("bhr,rhv->bhv", ctx, w_uv)
    out = o.reshape(B, H * m.v_head_dim) @ params["wo"].to(x.dtype)
    return out[:, None, :], ckv_cache, kr_cache


def cross_attn_forward(
    params: dict,
    x: torch.Tensor,  # (B, S, D)
    memory_kv: tuple,  # projected (B, T, Hkv, hd) k and v of the memory
    cfg: ModelConfig,
    *,
    gated: bool = False,
) -> torch.Tensor:
    """Attention of ``x`` over a memory's keys and values, not causal and
    without RoPE; ``gated`` scales the output by tanh(``gate``) (the VLM's
    image layers)."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    k, v = memory_kv
    q = _split_heads(x @ params["wq"].to(x.dtype), H)
    o = flash_attention_plain(q, k, v, causal=False)
    out = o.reshape(*o.shape[:2], H * hd) @ params["wo"].to(x.dtype)
    if gated:
        out = out * torch.tanh(params["gate"].to(x.dtype))
    return out


def cross_attn_memory(params: dict, memory: torch.Tensor, cfg: ModelConfig) -> tuple:
    """The memory (encoder output or image embeddings, (B, T, mem_dim))
    projected once to (k, v) of (B, T, Hkv, hd): a prefill's cross cache,
    which decode reads."""
    Hkv = cfg.num_kv_heads
    k = _split_heads(memory @ params["wk"].to(memory.dtype), Hkv)
    v = _split_heads(memory @ params["wv"].to(memory.dtype), Hkv)
    return k, v


# -- sharded forms (a rank's local blocks; ``sharding.comm``) ------------------


def _heads_split(params: dict, cfg: ModelConfig, comm) -> bool:
    """True where ``wq`` keeps its ``model`` split: the split falls between
    whole heads, and each rank computes its own heads (with the other head-
    split weights of the block). Otherwise those weights are all-gathered
    over ``model`` and every rank computes every head."""
    return "model" in params["wq"].split(1) and cfg.num_heads % comm.size("model") == 0


def _kv_split(params: dict, tp: bool) -> bool:
    """With the q heads split (``tp``), a kv projection whose columns the
    rules split over ``model`` is computed on the rank's columns and its
    output all-gathered (``_kv_proj``), whether or not the split falls
    between whole kv heads, as GSPMD partitions it."""
    return tp and "model" in params["wk"].split(1)


def _proj_weight(w, comm, keep_model: bool, dtype) -> torch.Tensor:
    """A weight's block gathered over ``data`` (FSDP), and over ``model``
    too unless its ``model`` split is kept."""
    return w.gathered(comm, ("data",) if keep_model else ("data", "model")).to(dtype)


def _proj(w, x: torch.Tensor, comm, keep_model: bool) -> torch.Tensor:
    return x @ _proj_weight(w, comm, keep_model, x.dtype)


def _kv_proj(w, x: torch.Tensor, comm, kv_split: bool) -> torch.Tensor:
    """k or v of every kv head, (..., Hkv·hd): the rank's columns all-gathered
    over ``model`` where they are split, else the whole projection."""
    out = _proj(w, x, comm, kv_split)
    return comm.all_gather(out, "model", out.dim() - 1) if kv_split else out


def _local_kv(k: torch.Tensor, v: torch.Tensor, h0: int, n_heads: int, G: int):
    """The kv heads the q heads [h0, h0 + n_heads) read, from all of them:
    a contiguous run when the local q heads cover whole groups or sit in one
    group, else one kv head per q head. Contiguous copies (the kernel reads
    dense inputs)."""
    if n_heads % G == 0:
        sel = slice(h0 // G, h0 // G + n_heads // G)
    elif G % n_heads == 0:
        sel = slice(h0 // G, h0 // G + 1)
    else:
        sel = torch.tensor([(h0 + j) // G for j in range(n_heads)], device=k.device)
    return k[:, :, sel].contiguous(), v[:, :, sel].contiguous()


def _row_parallel(w, o: torch.Tensor, comm, tp: bool) -> torch.Tensor:
    """``o @ w`` for an output projection: over the rank's heads with the
    partial sums all-reduced over ``model`` (``tp``), else whole."""
    out = o @ _proj_weight(w, comm, tp, o.dtype)
    return comm.all_reduce(out, "model") if tp else out


def gqa_forward_sharded(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, comm, *,
                        causal: bool = True, window: Optional[int] = None, attend: Optional[Callable] = None):
    """``gqa_forward`` on a rank's rows and heads: q column-parallel, k and
    v of every kv head (``_kv_proj``), attention over the local q heads with
    the kv heads they read (the kernel takes ``H`` and ``Hkv`` at run time),
    ``wo`` row-parallel with its partial sums all-reduced over ``model``.
    Returns ``(out, (k, v))`` with the keys and values of every kv head, for
    the cache. Under autograd (``sharding.comm``): with the heads split, ``x``
    enters the ``model`` region before the rank's q (and k, v) columns, and
    whole k and v enter it before each rank takes the kv heads of its own
    q heads."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    tp = _heads_split(params, cfg, comm)
    kv_split = _kv_split(params, tp)
    M = comm.size("model") if tp else 1
    h_loc = H // M
    xq = comm.enter(x, "model") if tp else x
    q = _split_heads(_proj(params["wq"], xq, comm, tp), h_loc)
    if kv_split:
        k = _split_heads(_kv_proj(params["wk"], xq, comm, kv_split), Hkv)
        v = _split_heads(_kv_proj(params["wv"], xq, comm, kv_split), Hkv)
    else:
        k = _split_heads(_kv_proj(params["wk"], x, comm, kv_split), Hkv)
        v = _split_heads(_kv_proj(params["wv"], x, comm, kv_split), Hkv)
        if tp:
            k, v = comm.enter(k, "model"), comm.enter(v, "model")
    q, k = apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)
    ka, va = _local_kv(k, v, comm.index("model") * h_loc, h_loc, H // Hkv) if tp else (k, v)
    o = (attend or flash_attention)(q.contiguous(), ka, va, causal=causal, window=window,
                                    softcap=cfg.attn_logit_softcap)
    return _row_parallel(params["wo"], o.reshape(*o.shape[:2], h_loc * hd), comm, tp), (k, v)


def cross_attn_memory_sharded(params: dict, memory: torch.Tensor, cfg: ModelConfig, comm) -> tuple:
    """``cross_attn_memory`` on a rank's rows of the memory: ``wk`` / ``wv``
    gathered over ``data`` (their ``embed`` dim is the memory's width), k
    and v of every kv head (``_kv_proj``), (B_loc, T, Hkv, hd). Under
    autograd, as ``gqa_forward_sharded``'s k and v: the memory enters the
    ``model`` region before the rank's k, v columns, or with the kv
    projections whole, k and v enter it before each rank takes the kv heads
    of its own q heads (``cross_attn_forward_sharded``)."""
    tp = _heads_split(params, cfg, comm)
    kv_split = _kv_split(params, tp)
    Hkv = cfg.num_kv_heads
    if kv_split:
        memory = comm.enter(memory, "model")
    k = _split_heads(_kv_proj(params["wk"], memory, comm, kv_split), Hkv)
    v = _split_heads(_kv_proj(params["wv"], memory, comm, kv_split), Hkv)
    if tp and not kv_split:
        k, v = comm.enter(k, "model"), comm.enter(v, "model")
    return k, v


def cross_attn_forward_sharded(params: dict, x: torch.Tensor, memory_kv: tuple, cfg: ModelConfig, comm, *,
                               gated: bool = False) -> torch.Tensor:
    """``cross_attn_forward`` on a rank's rows and heads: ``wq`` column-
    parallel, the attention over the rank's q heads plain (not causal, as the
    reference's cross-attention, which reaches no kernel), ``wo`` row-
    parallel. ``memory_kv`` holds every kv head (a prefill's memory, or a
    cache whose kv heads are not split), from which the rank's q heads take
    theirs, or the rank's own block of them (a cache split over ``model``).
    Under autograd ``x`` enters the ``model`` region before the rank's q
    columns; the ``gate`` scales an output that is whole on every ``model``
    rank, so its gradient is too."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    tp = _heads_split(params, cfg, comm)
    h_loc = H // comm.size("model") if tp else H
    k, v = memory_kv
    if k.shape[2] != Hkv and not tp:
        raise ValueError(f"a cross cache split to {k.shape[2]} of {Hkv} kv heads against q heads that are not")
    if tp and k.shape[2] == Hkv:
        k, v = _local_kv(k, v, comm.index("model") * h_loc, h_loc, H // Hkv)
    q = _split_heads(_proj(params["wq"], comm.enter(x, "model") if tp else x, comm, tp), h_loc)
    o = flash_attention_plain(q, k, v, causal=False)
    out = _row_parallel(params["wo"], o.reshape(*o.shape[:2], h_loc * hd), comm, tp)
    if gated:
        out = out * torch.tanh(params["gate"].gathered(comm).to(x.dtype))
    return out


def _write_owned(cache: torch.Tensor, local: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``_scatter_rows`` for a block of the cache's slots: each row lands at
    its block-local slot ``local`` where the block owns it, and the other
    rows leave the block as it was (in place; no host sync)."""
    n = cache.shape[1]
    owned = (local >= 0) & (local < n)
    at = local.clamp(0, n - 1).long()
    b = torch.arange(cache.shape[0], device=cache.device)
    keep = cache[b, at]
    shape = (-1,) + (1,) * (row.dim() - 1)
    return cache.index_put_((b, at), torch.where(owned.view(shape), row.to(cache.dtype), keep))


def _slot_block(cache: torch.Tensor, comm, seq_dims: tuple) -> tuple[int, int]:
    """(first slot, total slots) of this rank's block of a cache's slot axis
    (axis 1), split over ``seq_dims``."""
    start = 0
    for ax in seq_dims:
        start = start * comm.size(ax) + comm.index(ax)
    n_loc = cache.shape[1]
    return start * n_loc, n_loc * math.prod(comm.size(a) for a in seq_dims)


def gqa_decode_sharded(params: dict, x: torch.Tensor, pos: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, cfg: ModelConfig, comm, *, seq_dims: tuple = (),
                       rolling_window: Optional[int] = None):
    """``gqa_decode`` on a rank's rows and its block of the caches' slots
    (``seq_dims``: the mesh dims the slot axis is split over, ``kv_seq`` →
    ``model``). The new token's q and K/V come out for every head (all-
    gathered over ``model`` where column-parallel), the K/V row is written
    by the rank whose block holds its slot, and each rank takes the
    attention over its own slots: its max, sum and weighted values are
    combined over ``seq_dims`` (max, then sums), as split-KV decoding does.
    ``wo`` is row-parallel over the local q heads. Returns ``(out, k_cache,
    v_cache)``, the caches written in place."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B = x.shape[0]
    tp = _heads_split(params, cfg, comm)
    kv_split = _kv_split(params, tp)
    M = comm.size("model") if tp else 1
    q = _split_heads(_proj(params["wq"], x, comm, tp), H // M)
    k = _split_heads(_kv_proj(params["wk"], x, comm, kv_split), Hkv)
    v = _split_heads(_kv_proj(params["wv"], x, comm, kv_split), Hkv)[:, 0]
    q, k = apply_rope(q, pos[:, None], cfg.rope_theta)[:, 0], apply_rope(k, pos[:, None], cfg.rope_theta)[:, 0]
    if tp:
        q = comm.all_gather(q, "model", 1)
    slot = pos % rolling_window if rolling_window else pos
    start, total = _slot_block(k_cache, comm, seq_dims)
    k_cache = _write_owned(k_cache, slot - start, k)
    v_cache = _write_owned(v_cache, slot - start, v)
    if not seq_dims:
        o = decode_attention_plain(q, k_cache, v_cache, pos + 1, rolling=rolling_window is not None,
                                   softcap=cfg.attn_logit_softcap)
    else:
        o = _decode_partial(q, k_cache, v_cache, pos + 1, start, total, comm, seq_dims,
                            rolling=rolling_window is not None, softcap=cfg.attn_logit_softcap)
    if tp:
        h0 = comm.index("model") * (H // M)
        o = o[:, h0:h0 + H // M]
    return _row_parallel(params["wo"], o.reshape(B, (H // M) * hd), comm, tp)[:, None, :], k_cache, v_cache


def _mla_latent_sharded(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, comm, *,
                        x_model: Optional[torch.Tensor] = None):
    """``_mla_latent`` on a rank's rows: ``w_dkv`` and ``w_kr`` gathered
    over ``data``, their contraction split over ``model`` where ``model``
    divides d_model (the rank's slice of x times its rows of the weights,
    the partial sums all-reduced before the norm and the rope), as GSPMD
    partitions them; whole on every rank otherwise. Under autograd the
    weights (replicated over ``model``) and ``x`` enter the ``model`` region
    before the slice, so the shares of their gradients are summed (``x_model``:
    ``x`` as the caller entered it for its other ``model`` share, one enter
    for both)."""
    w_dkv, w_kr = params["w_dkv"].gathered(comm, ("data",)), params["w_kr"].gathered(comm, ("data",))
    M, d = comm.size("model"), x.shape[-1]
    if M > 1 and d % M == 0:
        c, j = d // M, comm.index("model")
        xs = (comm.enter(x, "model") if x_model is None else x_model)[..., j * c:(j + 1) * c]
        w_dkv, w_kr = comm.enter(w_dkv, "model"), comm.enter(w_kr, "model")
        c_kv = comm.all_reduce(xs @ w_dkv[j * c:(j + 1) * c].to(x.dtype), "model")
        k_r = comm.all_reduce(xs @ w_kr[j * c:(j + 1) * c].to(x.dtype), "model")
    else:
        c_kv, k_r = x @ w_dkv.to(x.dtype), x @ w_kr.to(x.dtype)
    c_kv = rmsnorm(c_kv, params["kv_norm"].gathered(comm), cfg.norm_eps)
    k_r = apply_rope(k_r[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_r


def mla_forward_sharded(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, comm):
    """``mla_forward`` on a rank's rows and heads: ``wq``, ``w_uk`` and
    ``w_uv`` column-parallel, the latent and rope key of every row
    (``_mla_latent_sharded``), the expanded heads through
    ``flash_attention_plain`` (the reference's MLA prefill reaches no
    kernel), ``wo`` row-parallel. Returns ``(out, (c_kv, k_r))``, the rank's
    rows of the latent cache, whole on the slot axis. Under autograd, with
    the heads split: ``x`` enters the ``model`` region before the rank's q
    columns (and its latent slice), and the normed latent and the roped key
    before the rank's heads read them, so ``kv_norm``'s gradient and the
    rope's see every head's share."""
    m = cfg.mla
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    tp = _heads_split(params, cfg, comm)
    h_loc = cfg.num_heads // comm.size("model") if tp else cfg.num_heads
    B, S, _ = x.shape
    xq = comm.enter(x, "model") if tp else x
    q = _split_heads(_proj(params["wq"], xq, comm, tp), h_loc)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    c_kv, k_r = _mla_latent_sharded(params, x, positions, cfg, comm, x_model=xq if tp else None)
    ckv_h, kr_h = (comm.enter(c_kv, "model"), comm.enter(k_r, "model")) if tp else (c_kv, k_r)
    k_nope = _split_heads(_proj(params["w_uk"], ckv_h, comm, tp), h_loc)
    value = _split_heads(_proj(params["w_uv"], ckv_h, comm, tp), h_loc)
    k_full = torch.cat([k_nope, kr_h[:, :, None, :].expand(B, S, h_loc, m.qk_rope_head_dim)], dim=-1)
    v_pad = torch.nn.functional.pad(value, (0, qd - m.v_head_dim))
    o = flash_attention_plain(torch.cat([q_nope, q_rope], dim=-1), k_full, v_pad, causal=True)[..., : m.v_head_dim]
    return _row_parallel(params["wo"], o.reshape(B, S, h_loc * m.v_head_dim), comm, tp), (c_kv, k_r)


def mla_decode_sharded(params: dict, x: torch.Tensor, pos: torch.Tensor, ckv_cache: torch.Tensor,
                       kr_cache: torch.Tensor, cfg: ModelConfig, comm, *, seq_dims: tuple = ()):
    """``mla_decode`` on a rank's rows, heads and block of the latent
    cache's slots (``seq_dims``, ``kv_seq`` → ``model``): the rank's heads
    of ``q_lat = q_nope · W_uk`` and of the roped ``q_rope``, all-gathered
    over ``model`` to every head; the new latent row written by the rank
    whose block holds ``pos``; the scores of every head against the rank's
    slots, combined over ``seq_dims`` (max, then the exp-sums and the latent
    context (B, H, r); a block with no valid slot adds zeros); then the
    rank's heads of the context through ``w_uv`` and row-parallel ``wo``.
    Returns (out, ckv_cache, kr_cache), the caches written in place."""
    m = cfg.mla
    B = x.shape[0]
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    tp = _heads_split(params, cfg, comm)
    h_loc = cfg.num_heads // comm.size("model") if tp else cfg.num_heads
    q = _split_heads(_proj(params["wq"], x, comm, tp), h_loc)
    q_nope = q[:, 0, :, : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], pos[:, None], cfg.rope_theta)[:, 0]
    w_uk = _proj_weight(params["w_uk"], comm, tp, x.dtype).reshape(m.kv_lora_rank, h_loc, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)
    if tp:
        q_lat, q_rope = comm.all_gather(q_lat, "model", 1), comm.all_gather(q_rope, "model", 1)
    c_new, kr_new = _mla_latent_sharded(params, x, pos[:, None], cfg, comm)
    start, _ = _slot_block(ckv_cache, comm, seq_dims)
    ckv_cache = _write_owned(ckv_cache, pos - start, c_new[:, 0])
    kr_cache = _write_owned(kr_cache, pos - start, kr_new[:, 0])

    ckv = ckv_cache.to(torch.float32)
    s = torch.einsum("bhr,bsr->bhs", q_lat.to(torch.float32), ckv)
    s = (s + torch.einsum("bhr,bsr->bhs", q_rope.to(torch.float32), kr_cache.to(torch.float32))) * scale
    idx = torch.arange(start, start + ckv_cache.shape[1], device=x.device)
    valid = (idx[None, :] < (pos + 1)[:, None])[:, None, :]
    s = torch.where(valid, s, NEG_INF)
    mx = s.amax(dim=-1, keepdim=True)
    for ax in seq_dims:
        mx = comm.all_reduce(mx, ax, "max")
    p = torch.where(valid, torch.exp(s - mx), 0.0)
    l, ctx = p.sum(dim=-1, keepdim=True), torch.einsum("bhs,bsr->bhr", p, ckv)
    for ax in seq_dims:
        l, ctx = comm.all_reduce(l, ax), comm.all_reduce(ctx, ax)
    ctx = (ctx / l).to(x.dtype)
    if tp:
        h0 = comm.index("model") * h_loc
        ctx = ctx[:, h0:h0 + h_loc]
    w_uv = _proj_weight(params["w_uv"], comm, tp, x.dtype).reshape(m.kv_lora_rank, h_loc, m.v_head_dim)
    o = torch.einsum("bhr,rhv->bhv", ctx, w_uv)
    out = _row_parallel(params["wo"], o.reshape(B, h_loc * m.v_head_dim), comm, tp)
    return out[:, None, :], ckv_cache, kr_cache


def _decode_partial(q, k_cache, v_cache, kv_len, start: int, total: int, comm, seq_dims: tuple, *,
                    rolling: bool, softcap: Optional[float]) -> torch.Tensor:
    """``decode_attention_plain`` over the slots [start, start + n) of a
    cache of ``total`` slots, combined across ``seq_dims``: the scores' max
    is all-reduced (max), then the exp-sums and the weighted values (sum);
    a block with no valid slot contributes zeros."""
    B, H, hd = q.shape
    _, n, Hkv, _ = k_cache.shape
    qg = q.reshape(B, Hkv, H // Hkv, hd).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32)) * hd**-0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    idx = torch.arange(start, start + n, device=q.device)
    limit = torch.clamp(kv_len, max=total) if rolling else kv_len
    valid = (idx[None, :] < limit[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    for ax in seq_dims:
        m = comm.all_reduce(m, ax, "max")
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    for ax in seq_dims:
        l, o = comm.all_reduce(l, ax), comm.all_reduce(o, ax)
    return (o / l).reshape(B, H, hd).to(q.dtype)

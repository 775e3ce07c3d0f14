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


def _head_split(params: dict, cfg: ModelConfig, comm) -> tuple[bool, bool]:
    """(q heads split, kv heads split) over ``model``: a projection keeps its
    ``model`` split only where it falls between whole heads; otherwise it is
    all-gathered over ``model`` and every rank computes all those heads."""
    M = comm.size("model")
    tp = "model" in params["wq"].split(1) and cfg.num_heads % M == 0
    tp_kv = tp and "model" in params["wk"].split(1) and cfg.num_kv_heads % M == 0
    return tp, tp_kv


def _proj(w, x: torch.Tensor, comm, keep_model: bool) -> torch.Tensor:
    return x @ w.gathered(comm, ("data",) if keep_model else ("data", "model")).to(x.dtype)


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


def gqa_forward_sharded(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, comm, *,
                        causal: bool = True, window: Optional[int] = None, attend: Optional[Callable] = None):
    """``gqa_forward`` on a rank's rows and heads: q (and k, v where the kv
    heads divide ``model``) column-parallel, attention over the local q
    heads with their own kv heads (the kernel takes ``H`` and ``Hkv`` at run
    time), ``wo`` row-parallel with its partial sums all-reduced over
    ``model``. Returns ``(out, (k, v))`` with the keys and values of every
    kv head (gathered over ``model`` where split), for the cache."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    tp, tp_kv = _head_split(params, cfg, comm)
    M = comm.size("model") if tp else 1
    h_loc = H // M
    q = _split_heads(_proj(params["wq"], x, comm, tp), h_loc)
    k = _split_heads(_proj(params["wk"], x, comm, tp_kv), Hkv // M if tp_kv else Hkv)
    v = _split_heads(_proj(params["wv"], x, comm, tp_kv), Hkv // M if tp_kv else Hkv)
    q, k = apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)
    if tp_kv or not tp:
        ka, va = k, v
    else:
        ka, va = _local_kv(k, v, comm.index("model") * h_loc, h_loc, H // Hkv)
    o = (attend or flash_attention)(q.contiguous(), ka, va, causal=causal, window=window,
                                    softcap=cfg.attn_logit_softcap)
    out = o.reshape(*o.shape[:2], h_loc * hd) @ params["wo"].gathered(
        comm, ("data",) if tp else ("data", "model")).to(x.dtype)
    if tp:
        out = comm.all_reduce(out, "model")
    if tp_kv:
        k, v = comm.all_gather(k, "model", 2), comm.all_gather(v, "model", 2)
    return out, (k, v)


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
    tp, tp_kv = _head_split(params, cfg, comm)
    M = comm.size("model") if tp else 1
    q = _split_heads(_proj(params["wq"], x, comm, tp), H // M)
    k = _split_heads(_proj(params["wk"], x, comm, tp_kv), Hkv // M if tp_kv else Hkv)
    v = _split_heads(_proj(params["wv"], x, comm, tp_kv), Hkv // M if tp_kv else Hkv)
    q, k = apply_rope(q, pos[:, None], cfg.rope_theta)[:, 0], apply_rope(k, pos[:, None], cfg.rope_theta)[:, 0]
    v = v[:, 0]
    if tp:
        q = comm.all_gather(q, "model", 1)
    if tp_kv:
        k, v = comm.all_gather(k, "model", 1), comm.all_gather(v, "model", 1)
    slot = pos % rolling_window if rolling_window else pos
    n_loc = k_cache.shape[1]
    start = 0
    for ax in seq_dims:
        start = start * comm.size(ax) + comm.index(ax)
    start *= n_loc
    k_cache = _write_owned(k_cache, slot - start, k)
    v_cache = _write_owned(v_cache, slot - start, v)
    if not seq_dims:
        o = decode_attention_plain(q, k_cache, v_cache, pos + 1, rolling=rolling_window is not None,
                                   softcap=cfg.attn_logit_softcap)
    else:
        o = _decode_partial(q, k_cache, v_cache, pos + 1, start, n_loc * math.prod(comm.size(a) for a in seq_dims),
                            comm, seq_dims, rolling=rolling_window is not None, softcap=cfg.attn_logit_softcap)
    if tp:
        h0 = comm.index("model") * (H // M)
        o = o[:, h0:h0 + H // M]
    out = o.reshape(B, (H // M) * hd) @ params["wo"].gathered(comm, ("data",) if tp else ("data", "model")).to(x.dtype)
    if tp:
        out = comm.all_reduce(out, "model")
    return out[:, None, :], k_cache, v_cache


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

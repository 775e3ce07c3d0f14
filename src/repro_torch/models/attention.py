"""GQA attention with RoPE: prefill (causal / sliding window) through the
flash-attention wrapper, one-token decode over linear and rolling KV
caches, and one-token decode over a paged KV pool (``repro.models.attention``
counterpart, GQA only).

Prefill attention goes through ``kernels.flash_attention.ops.
flash_attention`` and paged decode through ``kernels.decode_attention.ops.
paged_decode_attention``, each by device: the CUDA kernel for CUDA tensors,
its plain version for CPU tensors. ``cfg.use_pallas`` is not consulted. The
dense decode calls ``decode_attention_plain`` on every device, as the
reference's calls ``decode_attention_jnp``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention_plain, paged_decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope
from repro_torch.models.spec import ParamSpec


def gqa_spec(d_model: int, num_heads: int, num_kv_heads: int, head_dim: int) -> dict:
    return {
        "wq": ParamSpec((d_model, num_heads * head_dim), ("embed", "heads")),
        "wk": ParamSpec((d_model, num_kv_heads * head_dim), ("embed", "kv_heads")),
        "wv": ParamSpec((d_model, num_kv_heads * head_dim), ("embed", "kv_heads")),
        "wo": ParamSpec((num_heads * head_dim, d_model), ("heads", "embed")),
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
):
    """Prefill/forward attention; returns ``(out, (k, v))`` with the roped
    keys and the values for the cache."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(params, x, positions, cfg)
    o = flash_attention(q, k, v, causal=causal, window=window, softcap=cfg.attn_logit_softcap)
    out = o.reshape(*o.shape[:2], H * hd) @ params["wo"].to(x.dtype)
    return out, (k, v)


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

"""GQA attention with RoPE: prefill (causal / sliding window) through the
flash-attention wrapper, and one-token decode over linear and rolling KV
caches (``repro.models.attention`` counterpart, GQA only).

Prefill attention goes through ``kernels.flash_attention.ops.
flash_attention`` by device: the CUDA kernel for CUDA tensors, its plain
version for CPU tensors. ``cfg.use_pallas`` is not consulted.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import NEG_INF, flash_attention
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


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return s if cap is None else cap * torch.tanh(s / cap)


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


def decode_attention_plain(
    q: torch.Tensor,  # (B, H, hd), roped
    k_cache: torch.Tensor,  # (B, Skv, Hkv, hd)
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,  # (B,) number of valid cache entries
    *,
    rolling: bool = False,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention over a KV cache, in fp32 (``decode_attention_jnp``).
    For a rolling cache every slot is valid once kv_len >= Skv."""
    B, H, hd = q.shape
    _, Skv, Hkv, _ = k_cache.shape
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, hd).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32))
    s = _softcap(s * hd**-0.5, softcap)
    idx = torch.arange(Skv, device=q.device)
    limit = torch.clamp(kv_len, max=Skv) if rolling else kv_len
    valid = idx[None, :] < limit[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, H, hd).to(q.dtype)


def _scatter_rows(cache: torch.Tensor, slot: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """cache (B, S, ...), slot (B,), row (B, ...) -> a new cache with row
    written at [b, slot[b]]."""
    b = torch.arange(cache.shape[0], device=cache.device)
    return cache.index_put((b, slot), row.to(cache.dtype))


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
    """One decode step; returns (out, new_k_cache, new_v_cache). Linear cache:
    write at pos. Rolling cache: write at pos % window (softmax is order-
    invariant, so slot order does not matter)."""
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

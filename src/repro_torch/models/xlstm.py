"""xLSTM blocks: mLSTM (matrix memory, exponentially gated) and sLSTM
(scalar memory with a nonlinear recurrence) (``repro.models.xlstm``
counterpart).

Both use the stabilized exponential gating of the xLSTM paper
(arXiv:2405.04517): a running stabilizer ``m`` keeps exp(i), exp(f)
bounded. mLSTM blocks up-project by ``proj_factor_m`` and carry no separate
FFN; sLSTM blocks run the cell at d_model with a gated FFN tail.

Shapes: the mLSTM head dim is ``d_model * proj_factor_m / H`` (384 at
xlstm-125m's full width), the sLSTM head dim ``d_model / H`` (192); neither
is ``cfg.head_dim``. ``q``, ``k``, ``v``, the gates and every state leaf
(mLSTM ``C``, ``n``, ``m``; sLSTM ``c``, ``n``, ``h``, ``m``) are fp32 whatever
``cfg.dtype`` is; only the conv state is in ``cfg.dtype``.

Prefill takes the chunkwise form when ``S > chunk`` and ``S % chunk == 0``,
else the step-by-step scan, as the reference does. The chunkwise form runs
the stabilizer's exact max-plus recurrence with the scan's operations, so
its ``m`` equals the scan's bit for bit. Nothing here reaches a kernel: the
reference runs both cells in ``jnp``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.recurrent import causal_conv1d
from repro_torch.models.spec import ParamSpec

M_INIT = -1e30  # the stabilizer's starting value inside the block functions


def _groupnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head layernorm (GroupNorm with one group per head). x (..., H, hd)."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_block_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    xc = cfg.xlstm
    di = int(d * xc.proj_factor_m)  # inner width
    H = cfg.num_heads
    return {
        "w_up": ParamSpec((d, 2 * di), ("embed", "ffn")),
        "conv_w": ParamSpec((xc.conv_width, di), (None, "ffn"), scale=0.5),
        "conv_b": ParamSpec((di,), ("ffn",), init="zeros"),
        "w_q": ParamSpec((di, di), ("ffn", None)),
        "w_k": ParamSpec((di, di), ("ffn", None)),
        "w_v": ParamSpec((di, di), ("ffn", None)),
        "w_if": ParamSpec((di, 2 * H), ("ffn", None), scale=0.1),
        "b_if": ParamSpec((2 * H,), (None,), init="zeros"),
        "gn_scale": ParamSpec((di,), ("ffn",), init="ones"),
        "w_down": ParamSpec((di, d), ("ffn", "embed")),
    }


def mlstm_cache_shapes(cfg: ModelConfig, batch: int) -> dict[str, tuple]:
    """The ``m`` block's decode cache: the matrix memory ``C``, the
    normalizer ``n``, the stabilizer ``m`` (fp32) and the last (cw-1) conv
    inputs (``cfg.dtype``)."""
    xc = cfg.xlstm
    di = int(cfg.d_model * xc.proj_factor_m)
    H = cfg.num_heads
    hd = di // H
    return {"C": (batch, H, hd, hd), "n": (batch, H, hd), "m": (batch, H), "conv": (batch, xc.conv_width - 1, di)}


def _mlstm_heads(x: torch.Tensor, H: int) -> torch.Tensor:
    b, s, di = x.shape
    return x.reshape(b, s, H, di // H)


def _initial_state(B: int, H: int, hd: int, device) -> tuple:
    return (torch.zeros(B, H, hd, hd, dtype=torch.float32, device=device),
            torch.zeros(B, H, hd, dtype=torch.float32, device=device),
            torch.full((B, H), M_INIT, dtype=torch.float32, device=device))


def mlstm_scan(q, k, v, log_i, log_f, state=None):
    """The stabilized mLSTM recurrence, one step at a time.

    q, k, v (B, S, H, hd) fp32; log_i, log_f (B, S, H) fp32; ``state`` is
    (C (B, H, hd, hd), n (B, H, hd), m (B, H)) or None.
    Returns (h (B, S, H, hd) fp32, final state). The inputs are unbound
    into steps once (a step indexed at a time would add a whole-size
    gradient a step in the backward)."""
    B, S, H, hd = q.shape
    C, n, m = state if state is not None else _initial_state(B, H, hd, q.device)
    hs = []
    for qt, kt, vt, li, lf in zip(*(t.unbind(1) for t in (q, k, v, log_i, log_f))):
        m_new = torch.maximum(lf + m, li)
        i_bar = torch.exp(li - m_new)[..., None]
        f_bar = torch.exp(lf + m - m_new)[..., None]
        C = f_bar[..., None] * C + i_bar[..., None] * (kt[..., :, None] * vt[..., None, :])
        n = f_bar * n + i_bar * kt
        denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, qt)), torch.exp(-m_new))[..., None]
        hs.append(torch.einsum("bhdk,bhd->bhk", C, qt) / denom)
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_chunkwise(q, k, v, log_i, log_f, chunk: int, state=None):
    """Chunkwise-parallel stabilized mLSTM: the same function as
    ``mlstm_scan``, taking time in blocks of ``chunk``. Within a chunk the
    contributions come from an (L, L) masked score matrix; across chunks
    they flow through the carried state.

    q, k, v (B, S, H, hd) fp32 (k pre-scaled by 1/sqrt(hd)); log_i, log_f
    (B, S, H) fp32. Returns ((B, S, H, hd) fp32, final state)."""
    B, S, H, hd = q.shape
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    n_chunks, L = S // chunk, chunk
    C, nvec, m_prev = state if state is not None else _initial_state(B, H, hd, q.device)
    causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=q.device))
    hs = []
    for c in range(n_chunks):
        sl = slice(c * L, (c + 1) * L)
        qb, kb, vb, li, lf = q[:, sl], k[:, sl], v[:, sl], log_i[:, sl], log_f[:, sl]
        # cumulative log decay including step t: B_t = sum_{s<=t} lf_s
        Bcum = torch.cumsum(lf, dim=1)  # (B, L, H)
        u = li - Bcum
        # the stabilizer is state (it crosses chunk and request boundaries),
        # so it runs the exact max-plus recurrence m_t = max(lf_t + m_{t-1},
        # li_t) with mlstm_scan's operations, not the cumsum form, whose
        # float32 rounding drifts by ~eps·|B_t|
        m_steps, m = [], m_prev
        for lf_t, li_t in zip(lf.unbind(1), li.unbind(1)):
            m = torch.maximum(lf_t + m, li_t)
            m_steps.append(m)
        m_t = torch.stack(m_steps, dim=1)  # (B, L, H)
        # inter-chunk: exp(B_t + m_prev - m_t) * q_t C_prev
        w_inter = torch.exp(Bcum + m_prev[:, None, :] - m_t)
        h_inter = torch.einsum("blhd,bhdk->blhk", qb, C) * w_inter[..., None]
        n_inter = torch.einsum("blhd,bhd->blh", qb, nvec) * w_inter
        # intra-chunk: D_{t,s} = exp(B_t - B_s + li_s - m_t) for s <= t
        logD = (Bcum - m_t)[:, :, None, :] + u[:, None, :, :]  # (B, t, s, H)
        # masked before the exp (the reference masks after it): the same
        # values, but under torch's autograd a masked lane whose exp
        # overflows would turn its zero gradient into 0·inf = NaN
        D = torch.exp(torch.where(causal[None, :, :, None], logD, -math.inf))
        scores = torch.einsum("bthd,bshd->btsh", qb, kb) * D
        h_intra = torch.einsum("btsh,bshd->bthd", scores, vb)
        n_intra = scores.sum(dim=2)  # (B, L, H)
        denom = torch.maximum(torch.abs(n_inter + n_intra), torch.exp(-m_t))[..., None]
        hs.append((h_inter + h_intra) / denom)
        # carry to the next chunk (row t = L of the same recurrence)
        BL = Bcum[:, -1, :]
        m_next = m_t[:, -1, :]
        w_C = torch.exp(BL + m_prev - m_next)  # (B, H)
        w_s = torch.exp(BL[:, None, :] - Bcum + li - m_next[:, None, :])  # (B, L, H)
        C = w_C[..., None, None] * C + torch.einsum("blh,blhd,blhk->bhdk", w_s, kb, vb)
        nvec = w_C[..., None] * nvec + torch.einsum("blh,blhd->bhd", w_s, kb)
        m_prev = m_next
    return torch.cat(hs, dim=1), (C, nvec, m_prev)


def _mlstm_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig, conv_state: Optional[torch.Tensor] = None):
    H = cfg.num_heads
    up = x @ params["w_up"].to(x.dtype)
    z, o_gate = torch.chunk(up, 2, dim=-1)
    zc, conv_state = causal_conv1d(z, params["conv_w"], params["conv_b"], state=conv_state)
    zc = F.silu(zc.to(torch.float32)).to(x.dtype)
    q = _mlstm_heads(zc @ params["w_q"].to(x.dtype), H).to(torch.float32)
    k = _mlstm_heads(zc @ params["w_k"].to(x.dtype), H).to(torch.float32)
    v = _mlstm_heads(z @ params["w_v"].to(x.dtype), H).to(torch.float32)
    k = k / math.sqrt(k.shape[-1])
    gates = (zc @ params["w_if"].to(x.dtype)).to(torch.float32) + params["b_if"].to(torch.float32)
    log_i, f_raw = torch.chunk(gates, 2, dim=-1)  # (B, S, H) each
    log_f = -F.softplus(-f_raw)  # log sigmoid(f)
    return q, k, v, log_i, log_f, o_gate, conv_state


def _mlstm_out(params: dict, h: torch.Tensor, o_gate: torch.Tensor, x: torch.Tensor, H: int) -> torch.Tensor:
    h = h.to(x.dtype).reshape(x.shape[0], x.shape[1], -1)
    h = _groupnorm(_mlstm_heads(h, H), params["gn_scale"].reshape(H, -1)).reshape(h.shape)
    h = h * F.silu(o_gate.to(torch.float32)).to(x.dtype)
    return h @ params["w_down"].to(x.dtype)


def mlstm_block_forward(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Prefill / training path. Returns (y, cache) with cache = {C, n, m, conv}."""
    q, k, v, log_i, log_f, o_gate, conv_state = _mlstm_qkv(params, x, cfg)
    S, chunk = x.shape[1], cfg.xlstm.chunk_size
    if S > chunk and S % chunk == 0:
        h, state = mlstm_chunkwise(q, k, v, log_i, log_f, chunk)
    else:
        h, state = mlstm_scan(q, k, v, log_i, log_f)
    y = _mlstm_out(params, h, o_gate, x, cfg.num_heads)
    return y, {"C": state[0], "n": state[1], "m": state[2], "conv": conv_state}


def mlstm_block_decode(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x (B, 1, D) one step. The new state comes back as new tensors and
    ``cache`` is only read (the caller commits it once the step is final)."""
    q, k, v, log_i, log_f, o_gate, conv_state = _mlstm_qkv(params, x, cfg, conv_state=cache["conv"])
    h, state = mlstm_scan(q, k, v, log_i, log_f, state=(cache["C"], cache["n"], cache["m"]))
    y = _mlstm_out(params, h, o_gate, x, cfg.num_heads)
    return y, {"C": state[0], "n": state[1], "m": state[2], "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_block_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    f = int(d * cfg.xlstm.proj_factor_s)
    return {
        "w_zifo": ParamSpec((d, 4 * d), ("embed", "ffn")),
        "r_zifo": ParamSpec((H, hd, 4 * hd), (None, None, None), scale=0.5),
        "b_zifo": ParamSpec((4 * d,), ("ffn",), init="zeros"),
        "gn_scale": ParamSpec((d,), ("embed",), init="ones"),
        "ffn_up": ParamSpec((d, 2 * f), ("embed", "ffn")),
        "ffn_down": ParamSpec((f, d), ("ffn", "embed")),
    }


def slstm_cache_shapes(cfg: ModelConfig, batch: int) -> dict[str, tuple]:
    """The ``s`` block's decode cache: cell, normalizer, output and the
    per-channel stabilizer, each (B, H, hd) fp32."""
    H = cfg.num_heads
    shape = (batch, H, cfg.d_model // H)
    return {"c": shape, "n": shape, "h": shape, "m": shape}


def _slstm_cell_step(r_zifo: torch.Tensor, xt: torch.Tensor, carry: tuple, H: int, hd: int):
    """xt (B, 4·H·hd) pre-activation from the input; carry (c, n, h, m), each
    (B, H, hd) (the stabilizer is per channel); ``r_zifo`` (H, hd, 4hd)."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,hdk->bhk", h, r_zifo.to(h.dtype))  # (B, H, 4hd)
    pre = xt.reshape(xt.shape[0], H, 4 * hd).to(torch.float32) + rec.to(torch.float32)
    z, i_raw, f_raw, o_raw = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o_raw)
    log_f = -F.softplus(-f_raw)  # log sigmoid(f)
    m_new = torch.maximum(log_f + m, i_raw)
    i_bar = torch.exp(i_raw - m_new)
    f_bar = torch.exp(log_f + m - m_new)
    c = f_bar * c + i_bar * z
    n = f_bar * n + i_bar
    h_new = o * c / torch.clamp(n, min=1e-6)
    return (c, n, h_new, m_new), h_new


def slstm_cell(params: dict, x_pre: torch.Tensor, cfg: ModelConfig, state=None):
    """x_pre (B, S, 4d). Returns (h (B, S, H, hd) fp32, state)."""
    H = cfg.num_heads
    return _slstm_steps(params["r_zifo"], x_pre, H, cfg.d_model // H, state)


def _slstm_steps(r_zifo: torch.Tensor, x_pre: torch.Tensor, H: int, hd: int, state=None):
    """The cell over time for H heads of hd channels: x_pre (B, S, 4·H·hd),
    r_zifo (H, hd, 4hd). Returns (h (B, S, H, hd) fp32, state)."""
    B, S, _ = x_pre.shape
    if state is None:
        zeros = torch.zeros(B, H, hd, dtype=torch.float32, device=x_pre.device)
        state = (zeros, zeros, zeros, torch.full((B, H, hd), M_INIT, dtype=torch.float32, device=x_pre.device))
    hs = []
    for xt in x_pre.unbind(1):  # once, as ``mlstm_scan``'s inputs
        state, h = _slstm_cell_step(r_zifo, xt, state, H, hd)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def _slstm_tail(params: dict, h: torch.Tensor, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S = x.shape[0], x.shape[1]
    h = _groupnorm(h.to(x.dtype), params["gn_scale"].reshape(cfg.num_heads, -1)).reshape(B, S, -1)
    a, b = torch.chunk(h @ params["ffn_up"].to(x.dtype), 2, dim=-1)
    # jax.nn.gelu's default is the tanh approximation
    hf = F.gelu(a.to(torch.float32), approximate="tanh").to(x.dtype) * b
    return hf @ params["ffn_down"].to(x.dtype)


def _slstm_pre(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w_zifo"].to(x.dtype) + params["b_zifo"].to(x.dtype)


def slstm_block_forward(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Prefill / training path. Returns (y, cache) with cache = {c, n, h, m}."""
    h, state = slstm_cell(params, _slstm_pre(params, x), cfg)
    return _slstm_tail(params, h, x, cfg), dict(zip("cnhm", state))


def slstm_block_decode(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x (B, 1, D) one step; ``cache`` is only read, the new state is new tensors."""
    state = tuple(cache[k] for k in "cnhm")
    h, state = slstm_cell(params, _slstm_pre(params, x), cfg, state=state)
    return _slstm_tail(params, h, x, cfg), dict(zip("cnhm", state))


# ---------------------------------------------------------------------------
# sharded forms (a rank's local blocks; ``sharding.comm``)
# ---------------------------------------------------------------------------
#
# Laid out as GSPMD partitions the reference's blocks (its compiled 2×2 HLO):
# a weight whose columns the rules split over ``model`` is applied to the
# rank's columns and the output all-gathered (``_cols_whole``: the fused
# ``w_up`` / ``ffn_up`` are chunked afterwards, since a rank's block of their
# columns is not its channels of both halves); one whose rows (the
# contraction) are split takes the rank's block of its input, the partial
# sums reduced over ``model`` before anything nonlinear (``_contract``). The
# recurrence runs on the rank's heads where ``model`` divides them, its
# inputs' partial sums reduce-scattered to those heads, else on every head on
# every rank (``rank_heads``).
#
# Under autograd (``sharding.comm``) each rank's output of a block is whole
# (all-reduced), and the gradient of every whole tensor inside it is a share
# on each rank: a rank reads only its block of the channels into a row-
# parallel weight, or only its heads. So ``x`` enters the ``model`` region
# before the column-parallel weights, and so does a whole leaf read for
# part of its use (a weight the rules leave whole over ``model``, a bias, a
# group-norm scale or the sLSTM's recurrent weights cut to the rank's
# heads); the all-gathers' backward reduce-scatters the shares to the
# rank's columns or heads. Where every rank runs every head, the partial
# sums that feed the recurrence are all-reduced and then enter the region,
# so their shares are summed before the backward leaves the recurrence.


def rank_heads(cfg: ModelConfig, comm) -> tuple[int, int]:
    """(first head, heads) of the recurrence on this rank: its own block
    where ``model`` divides the heads (the state's ``heads`` axis is split
    then), else every head."""
    H, M = cfg.num_heads, comm.size("model")
    if M > 1 and H % M == 0:
        return comm.index("model") * (H // M), H // M
    return 0, H


def _cols_whole(w, x: torch.Tensor, comm) -> torch.Tensor:
    """``x @ w`` whole on every rank: the rank's columns of ``w`` (gathered
    over ``data``), all-gathered over ``model`` where the rules split them;
    a weight whole over ``model`` enters the region (each rank reads a part
    of the product)."""
    wl = w.gathered(comm, ("data",))
    if "model" in w.split(1):
        out = x @ wl.to(x.dtype)
        return comm.all_gather(out, "model", out.dim() - 1)
    return x @ comm.enter(wl, "model").to(x.dtype)


def _partial(w, h: torch.Tensor, comm) -> torch.Tensor:
    """This rank's partial sum of ``h @ w`` with the contraction (``w``'s
    rows) split over ``model``: the rank's block of the rows where the rules
    split them, else rows [j·c, (j+1)·c) with c = ceil(rows / model) (the
    last block shorter), as GSPMD splits a dim that ``model`` does not
    divide, by padding it (the whole weight entering the region). ``h`` is
    whole (cut here) or already that block."""
    wl = w.gathered(comm, ("data",))
    M, n = comm.size("model"), w.shape[0]
    if M == 1:
        return h @ wl.to(h.dtype)
    if "model" in w.split(0):
        lo = w.start(0, comm)
        hi = lo + wl.shape[0]
    else:
        c = -(-n // M)
        lo = min(comm.index("model") * c, n)
        hi = min(lo + c, n)
        wl = comm.enter(wl, "model")[lo:hi]
    if h.shape[-1] == n:
        h = h[..., lo:hi]
    return h @ wl.to(h.dtype)


def _contract(w, h: torch.Tensor, comm) -> torch.Tensor:
    """``h @ w`` whole on every rank: ``_partial``'s sums all-reduced over
    ``model``."""
    return comm.all_reduce(_partial(w, h, comm), "model")


def _mlstm_qkv_sharded(params: dict, x: torch.Tensor, cfg: ModelConfig, comm, conv_state=None):
    """``_mlstm_qkv`` on a rank's rows: ``up`` whole (``_cols_whole``), the
    conv on the rank's channels of ``z`` (``conv_w``'s block), q / k / v and
    the gates with their contraction over those channels (``_partial``),
    reduce-scattered to the rank's heads where ``model`` divides them, else
    all-reduced (``rank_heads``)."""
    H = cfg.num_heads
    x = comm.enter(x, "model")
    z, o_gate = torch.chunk(_cols_whole(params["w_up"], x, comm), 2, dim=-1)
    conv_w = params["conv_w"]
    lo = conv_w.start(1, comm)
    z_c = z[..., lo:lo + conv_w.local.shape[1]]
    zc, conv_state = causal_conv1d(z_c, conv_w.gathered(comm, ("data",)), params["conv_b"].gathered(comm, ("data",)),
                                   state=conv_state)
    zc = F.silu(zc.to(torch.float32)).to(x.dtype)
    h0, nh = rank_heads(cfg, comm)
    split = nh < H

    def heads(w, h: torch.Tensor) -> torch.Tensor:  # (B, S, nh, hd) fp32
        t = _partial(w, h, comm)
        t = comm.reduce_scatter(t, "model", t.dim() - 1) if split else \
            comm.enter(comm.all_reduce(t, "model"), "model")
        return _mlstm_heads(t, nh).to(torch.float32)

    q, k, v = heads(params["w_q"], zc), heads(params["w_k"], zc), heads(params["w_v"], z_c)
    k = k / math.sqrt(k.shape[-1])
    g, b = _partial(params["w_if"], zc, comm), params["b_if"].gathered(comm)
    if split:  # the (i, f) pair of the rank's heads
        g = comm.reduce_scatter(g.unflatten(-1, (2, H)), "model", g.dim())
        log_i, f_raw = (g.to(torch.float32) + comm.enter(b, "model").view(2, H)[:, h0:h0 + nh].to(torch.float32)) \
            .unbind(-2)
    else:
        gates = comm.enter(comm.all_reduce(g, "model").to(torch.float32) + b.to(torch.float32), "model")
        log_i, f_raw = torch.chunk(gates, 2, dim=-1)
    return q, k, v, log_i, -F.softplus(-f_raw), o_gate, conv_state


def _mlstm_out_sharded(params: dict, h: torch.Tensor, o_gate: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
                       comm) -> torch.Tensor:
    """``_mlstm_out`` for the rank's heads h (B, S, nh, hd): the group norm
    on whole heads, the output gate on their channels, row-parallel
    ``w_down`` (its rows cut where h holds every head)."""
    H = cfg.num_heads
    h0, nh = rank_heads(cfg, comm)
    hd = h.shape[-1]
    gn = comm.enter(params["gn_scale"].gathered(comm), "model").reshape(H, hd)[h0:h0 + nh]
    h = _groupnorm(h.to(x.dtype), gn).reshape(x.shape[0], x.shape[1], nh * hd)
    h = h * F.silu(o_gate[..., h0 * hd:(h0 + nh) * hd].to(torch.float32)).to(x.dtype)
    return _contract(params["w_down"], h, comm)


def mlstm_block_forward_sharded(params: dict, x: torch.Tensor, cfg: ModelConfig, comm):
    """``mlstm_block_forward`` on a rank's rows (``Shard`` params). Returns
    (y, cache): C / n / m of the rank's heads, conv of its channels."""
    q, k, v, log_i, log_f, o_gate, conv_state = _mlstm_qkv_sharded(params, x, cfg, comm)
    S, chunk = x.shape[1], cfg.xlstm.chunk_size
    if S > chunk and S % chunk == 0:
        h, state = mlstm_chunkwise(q, k, v, log_i, log_f, chunk)
    else:
        h, state = mlstm_scan(q, k, v, log_i, log_f)
    y = _mlstm_out_sharded(params, h, o_gate, x, cfg, comm)
    return y, {"C": state[0], "n": state[1], "m": state[2], "conv": conv_state}


def mlstm_block_decode_sharded(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig, comm):
    """``mlstm_block_decode`` on a rank's rows: ``cache`` holds the state of
    the rank's heads and the conv inputs of its channels, only read; the new
    state comes back as new tensors."""
    q, k, v, log_i, log_f, o_gate, conv_state = _mlstm_qkv_sharded(params, x, cfg, comm, conv_state=cache["conv"])
    h, state = mlstm_scan(q, k, v, log_i, log_f, state=(cache["C"], cache["n"], cache["m"]))
    y = _mlstm_out_sharded(params, h, o_gate, x, cfg, comm)
    return y, {"C": state[0], "n": state[1], "m": state[2], "conv": conv_state}


def _slstm_sharded(params: dict, x: torch.Tensor, cfg: ModelConfig, comm, state=None):
    """The sLSTM block on a rank's rows. Where ``model`` divides the heads a
    rank's block of ``w_zifo``'s columns is its heads' four gates, and the
    cell runs on them; otherwise the pre-activation is all-gathered and every
    rank runs every head. The group norm runs on whole heads, whose outputs
    are all-gathered over ``model`` for ``ffn_up`` (whole, ``_cols_whole``);
    ``ffn_down`` is row-parallel (``_contract``). Returns (y, state)."""
    H = cfg.num_heads
    hd = cfg.d_model // H
    h0, nh = rank_heads(cfg, comm)
    w, b = params["w_zifo"], params["b_zifo"]
    x = comm.enter(x, "model")
    if nh < H:
        pre = x @ w.gathered(comm, ("data",)).to(x.dtype) + b.gathered(comm, ("data",)).to(x.dtype)
    else:
        pre = _cols_whole(w, x, comm) + comm.enter(b.gathered(comm), "model").to(x.dtype)
    r = comm.enter(params["r_zifo"].gathered(comm), "model")[h0:h0 + nh]
    h, state = _slstm_steps(r, pre, nh, hd, state)
    B, S = x.shape[0], x.shape[1]
    gn = comm.enter(params["gn_scale"].gathered(comm), "model").reshape(H, hd)[h0:h0 + nh]
    h = _groupnorm(h.to(x.dtype), gn).reshape(B, S, nh * hd)
    if nh < H:
        h = comm.all_gather(h, "model", 2)
    a, b_ = torch.chunk(_cols_whole(params["ffn_up"], h, comm), 2, dim=-1)
    hf = F.gelu(a.to(torch.float32), approximate="tanh").to(x.dtype) * b_
    return _contract(params["ffn_down"], hf, comm), state


def slstm_block_forward_sharded(params: dict, x: torch.Tensor, cfg: ModelConfig, comm):
    """``slstm_block_forward`` on a rank's rows (``_slstm_sharded``); the
    cache holds the rank's heads (every head where ``model`` does not
    divide them)."""
    y, state = _slstm_sharded(params, x, cfg, comm)
    return y, dict(zip("cnhm", state))


def slstm_block_decode_sharded(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig, comm):
    """``slstm_block_decode`` on a rank's rows; ``cache`` is only read."""
    y, state = _slstm_sharded(params, x, cfg, comm, state=tuple(cache[k] for k in "cnhm"))
    return y, dict(zip("cnhm", state))

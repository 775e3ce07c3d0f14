"""Mixture-of-Experts layer: token-choice top-k routing with capacity-based
gather/scatter dispatch (``repro.models.moe`` counterpart).

The routed expert tables are the FaaSLight "optional functions"
(``access="routed"``); the serving engine reads the per-layer usage mask to
fault cold experts in. The slot order, the capacity rule and the usage mask
follow the reference exactly: top-k in descending order, then a cumsum over
the flattened (token, choice) list decides ``pos_in_expert`` — and so which
tokens are dropped once a prefill exceeds 1024 tokens.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import swiglu, swiglu_sharded, swiglu_spec
from repro_torch.models.spec import ParamSpec


def moe_spec(cfg: ModelConfig) -> dict:
    m: MoEConfig = cfg.moe
    d, f, E = cfg.d_model, m.expert_d_ff, m.num_experts
    spec = {
        "router": ParamSpec((d, E), ("embed", None)),
        "w_gate": ParamSpec((E, d, f), ("experts", "embed", "ffn"), access="routed"),
        "w_up": ParamSpec((E, d, f), ("experts", "embed", "ffn"), access="routed"),
        "w_down": ParamSpec((E, f, d), ("experts", "ffn", "embed"), access="routed"),
    }
    if m.num_shared_experts:
        spec["shared"] = swiglu_spec(d, f * m.num_shared_experts)
    return spec


def router_probs(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(..., E) softmax router probabilities (fp32)."""
    logits = x.to(torch.float32) @ params["router"].to(torch.float32)
    return torch.softmax(logits, dim=-1)


def capacity(m: MoEConfig, T: int, *, serving: bool) -> int:
    """Tokens per expert: dropless (C = T) for serving batches of at most
    1024 tokens, a 2x capacity factor for longer serving prefills, the
    config's factor for training."""
    k, E = m.top_k, m.num_experts
    if serving and T <= 1024:
        return T
    cf = max(m.capacity_factor, 2.0) if serving else m.capacity_factor
    return max(1, min(T, int(math.ceil(k * T * cf / E))))


def moe_forward(
    params: dict,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    return_usage: bool = False,  # also return the (E,) bool "expert routed to" mask
    serving: bool = False,
    usage_rows: torch.Tensor | None = None,  # (B, S) bool: the rows counted in the usage mask
):
    m: MoEConfig = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    T = B * S
    xf = x.reshape(T, d)

    probs = router_probs(params, xf)  # (T, E)
    gate_w, ids = torch.topk(probs, k, dim=-1)  # descending, like lax.top_k
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    C = capacity(m, T, serving=serving)

    flat_ids = ids.reshape(-1)  # (T*k,)
    onehot = F.one_hot(flat_ids, E)
    pos_in_expert = (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat_ids[:, None])[:, 0]
    keep = pos_in_expert < C
    slot = torch.where(keep, flat_ids * C + pos_in_expert, E * C)  # E*C = drop sentinel

    # (E*C,) dispatch table of token indices; empty slots point at a zero row
    token_idx = torch.arange(T * k, device=x.device) // k
    table = torch.full((E * C + 1,), T, dtype=torch.int64, device=x.device)
    table = table.scatter(0, slot, token_idx)[: E * C]

    xg = torch.cat([xf, xf.new_zeros(1, d)], dim=0)[table].reshape(E, C, d)
    g = torch.bmm(xg, params["w_gate"].to(x.dtype))
    u = torch.bmm(xg, params["w_up"].to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    yg = torch.bmm(h, params["w_down"].to(x.dtype))  # (E, C, d)

    # combine: each (token, choice) slot's output, gate-weighted, summed over k
    yflat = torch.cat([yg.reshape(E * C, d), yg.new_zeros(1, d)], dim=0)
    per_slot = yflat[torch.clamp(slot, max=E * C)]
    per_slot = torch.where(keep[:, None], per_slot, torch.zeros_like(per_slot))
    y = (per_slot.reshape(T, k, d) * gate_w[..., None].to(x.dtype)).sum(dim=1)

    if m.num_shared_experts:
        y = y + swiglu(params["shared"], xf)
    y = y.reshape(B, S, d)
    if not return_usage:
        return y
    # experts this batch routed to, pre-capacity (a safe over-approximation
    # for the engine's expert pre-fault). Rows outside ``usage_rows`` (a
    # scheduler's free slots decoding pad tokens) go to the drop sentinel E,
    # so their routing never faults an expert in.
    usage_ids = ids
    if usage_rows is not None:
        usage_ids = torch.where(usage_rows.reshape(T, 1), ids, E)
    usage = torch.zeros(E + 1, dtype=torch.bool, device=x.device).scatter(0, usage_ids.reshape(-1), True)
    return y, usage[:E]


def moe_forward_sharded(
    params: dict,  # Shard leaves (``sharding.rules.Shard``)
    x: torch.Tensor,  # (B_loc, S, d): this rank's rows
    cfg: ModelConfig,
    comm,
    *,
    batch_dims: tuple = (),  # the mesh dims the batch rows are split over
    serving: bool = False,
    return_usage: bool = False,
    usage_rows: torch.Tensor | None = None,  # (B, S) bool over the whole batch
):
    """``moe_forward`` on a rank's rows, with the routing kept global.

    The router's contraction is split over ``model`` (its partial logits
    all-reduced), then each rank takes the top-k of its own tokens. The
    (token, choice) expert ids are all-gathered over ``batch_dims`` (T·k
    ints), so the capacity ``C`` comes from the global T and every
    position in an expert is the global cumsum's, in global token order:
    the tokens kept and dropped are the unsharded layer's. A rank then runs
    its own tokens through its own experts (EP where ``experts`` divides
    ``model``, else every expert with ``ffn`` split over ``model``), the
    expert weights all-gathered over ``data`` at use. Its tokens are a
    contiguous run of the global order, so each expert's kept ones are a
    prefix of them and fit a local capacity of ``min(C, T_loc)``. The
    gate-weighted outputs are summed over ``model`` (the other experts'
    choices, or the ``ffn`` partial sums). The usage mask is the global
    one, the same on every rank.

    Training (``serving=False``): the capacity is the config's factor of the
    global T. Under autograd the rank's tokens, the router and the gate
    weights enter the ``model`` region (``sharding.comm``) where a rank
    uses them on its own share: the router's slice of the contraction, and
    the tokens its experts (or its ``ffn`` columns) take."""
    m: MoEConfig = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    T_loc = B * S
    xf = x.reshape(T_loc, d)
    w = params["w_gate"]
    expert_dims = tuple(dict.fromkeys(w.split(0) + w.split(2)))  # the dims the expert work is split over
    xe = xf
    for ax in expert_dims:
        xe = comm.enter(xe, ax)

    router = params["router"].gathered(comm, ("data",)).to(torch.float32)
    M = comm.size("model")
    if M > 1 and d % M == 0:
        c, j = d // M, comm.index("model")
        xr = xe if "model" in expert_dims else comm.enter(xf, "model")  # one enter for both shares
        router = comm.enter(router, "model")
        logits = comm.all_reduce(xr.to(torch.float32)[:, j * c:(j + 1) * c] @ router[j * c:(j + 1) * c], "model")
    else:
        logits = xf.to(torch.float32) @ router
    gate_w, ids = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    for ax in expert_dims:
        gate_w = comm.enter(gate_w, ax)

    all_ids, rank = ids.reshape(B, S * k), 0
    for ax in reversed(batch_dims):
        all_ids = comm.all_gather(all_ids, ax, 0)
    for ax in batch_dims:
        rank = rank * comm.size(ax) + comm.index(ax)
    all_ids = all_ids.reshape(-1)
    T = all_ids.numel() // k
    C = capacity(m, T, serving=serving)
    onehot = F.one_hot(all_ids, E)
    first = rank * T_loc * k  # this rank's first (token, choice) in the global order
    flat_ids = ids.reshape(-1)
    pos = (torch.cumsum(onehot, dim=0) - onehot)[first:first + T_loc * k].gather(1, flat_ids[:, None])[:, 0]
    keep = pos < C
    pos_loc = pos - onehot[:first].sum(dim=0)[flat_ids]  # position among this rank's tokens

    e0, E_loc = (w.start(0, comm), w.local.shape[0]) if w.split(0) else (0, E)
    C_loc = min(C, T_loc)
    e_loc = flat_ids - e0
    mine = keep & (e_loc >= 0) & (e_loc < E_loc)
    slot = torch.where(mine, e_loc * C_loc + pos_loc, E_loc * C_loc)
    token_idx = torch.arange(T_loc * k, device=x.device) // k
    table = torch.full((E_loc * C_loc + 1,), T_loc, dtype=torch.int64, device=x.device)
    table = table.scatter(0, slot, token_idx)[: E_loc * C_loc]

    xg = torch.cat([xe, xe.new_zeros(1, d)], dim=0)[table].reshape(E_loc, C_loc, d)
    g = torch.bmm(xg, w.gathered(comm, ("data",)).to(x.dtype))
    u = torch.bmm(xg, params["w_up"].gathered(comm, ("data",)).to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    del g, u, xg
    yg = torch.bmm(h, params["w_down"].gathered(comm, ("data",)).to(x.dtype))
    del h

    # each (token, choice) row's output (the clamped index of a row not kept
    # here reads some slot, zeroed by ``mine``: no copy of ``yg`` with a zero row)
    per_slot = yg.reshape(E_loc * C_loc, d)[torch.clamp(slot, max=E_loc * C_loc - 1)]
    del yg
    per_slot = torch.where(mine[:, None], per_slot, torch.zeros_like(per_slot))
    y = (per_slot.reshape(T_loc, k, d) * gate_w[..., None].to(x.dtype)).sum(dim=1)
    for ax in dict.fromkeys(w.split(0) + w.split(2)):
        y = comm.all_reduce(y, ax)

    if m.num_shared_experts:
        y = y + swiglu_sharded(params["shared"], xf, comm)
    y = y.reshape(B, S, d)
    if not return_usage:
        return y
    usage_ids = all_ids.reshape(T, k)
    if usage_rows is not None:
        usage_ids = torch.where(usage_rows.reshape(T, 1), usage_ids, E)
    usage = torch.zeros(E + 1, dtype=torch.bool, device=x.device).scatter(0, usage_ids.reshape(-1), True)
    return y, usage[:E]

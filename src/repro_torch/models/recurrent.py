"""Griffin/RecurrentGemma RG-LRU residual block (``repro.models.recurrent``
counterpart).

Temporal mixing:  y = W_out( GeLU(W_gate x) ⊙ RG-LRU(conv1d(W_in x)) )
RG-LRU:           r_t = σ(W_r h_t + b_r); i_t = σ(W_i h_t + b_i)
                  log a_t = -c · softplus(Λ) · r_t         (c = 8)
                  s_t = a_t ⊙ s_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ h_t)

Prefill computes the gates in fp32 and hands ``a, b`` to
``kernels.rglru_scan.ops.rglru_scan``, which owns only the serial
dependency (the reference's ``use_pallas`` branch): the CUDA kernel for CUDA
tensors, the plain step loop for CPU ones; the training loss names
``rglru_scan_plain`` itself, on every device. Decode is one fused step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.models.spec import ParamSpec

LRU_C = 8.0


def rglru_block_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.recurrent.lru_width or d
    cw = cfg.recurrent.conv_width
    return {
        "w_in": ParamSpec((d, w), ("embed", "ffn")),
        "w_gate_branch": ParamSpec((d, w), ("embed", "ffn")),
        "conv_w": ParamSpec((cw, w), (None, "ffn"), scale=0.5),
        "conv_b": ParamSpec((w,), ("ffn",), init="zeros"),
        "w_r": ParamSpec((w, w), ("ffn", None)),
        "b_r": ParamSpec((w,), (None,), init="zeros"),
        "w_i": ParamSpec((w, w), ("ffn", None)),
        "b_i": ParamSpec((w,), (None,), init="zeros"),
        "lam": ParamSpec((w,), (None,), init="lru_a"),
        "w_out": ParamSpec((w, d), ("ffn", "embed")),
    }


def rglru_cache_shapes(cfg: ModelConfig, batch: int) -> dict[str, tuple]:
    """The ``rec`` block's decode cache: the last (cw-1) conv inputs and the
    recurrence state."""
    w = cfg.recurrent.lru_width or cfg.d_model
    return {"conv": (batch, cfg.recurrent.conv_width - 1, w), "lru": (batch, w)}


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time. x (B, S, W), w (cw, W). Taps are
    summed in order i = 0..cw-1, then the bias is added. Returns
    (y, new_state) where the state is the last (cw-1) inputs."""
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, cw):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    new_state = xp[:, xp.shape[1] - (cw - 1):] if cw > 1 else x.new_zeros(x.shape[0], 0, x.shape[2])
    return y, new_state


def _gates(params: dict, h: torch.Tensor):
    """fp32 decay ``a`` and input ``b`` of the recurrence for h (..., W)."""
    return _gate_math(h @ params["w_r"].to(h.dtype), h @ params["w_i"].to(h.dtype), params["b_r"], params["b_i"],
                      params["lam"], h)


def _gate_math(r_pre, i_pre, b_r, b_i, lam, h: torch.Tensor):
    """``_gates`` from the gates' pre-activations (the products with
    ``w_r`` and ``w_i``), each channel on its own."""
    r = torch.sigmoid(r_pre.float() + b_r.float())
    i = torch.sigmoid(i_pre.float() + b_i.float())
    a = torch.exp(-LRU_C * F.softplus(lam.float()) * r)
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * h.float())
    return a, gated_x


def rglru_step(params: dict, h: torch.Tensor, state: torch.Tensor):
    """h (B, W) one step -> (out (B, W) in h's dtype, new fp32 state (B, W))."""
    a, b = _gates(params, h)
    s = a * state.float() + b
    return s.to(h.dtype), s


def _gate_branch(params: dict, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    g = x @ params["w_gate_branch"].to(x.dtype)
    return F.gelu(g.float(), approximate="tanh").to(x.dtype)


def rglru_block_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *, scan: Optional[Callable] = None):
    """Prefill / training path. Returns (y, cache) with cache = {conv, lru}.
    ``scan`` is None for this module's ``rglru_scan`` (the kernel's wrapper,
    looked up at the call), or ``rglru_scan_plain`` named by a caller that
    needs a backward (the training loss)."""
    gate = _gate_branch(params, x)
    h = x @ params["w_in"].to(x.dtype)
    h, conv_state = causal_conv1d(h, params["conv_w"], params["conv_b"])
    a, b = _gates(params, h)
    s = (scan or rglru_scan)(a, b)
    y = (gate * s.to(h.dtype)) @ params["w_out"].to(x.dtype)
    return y, {"conv": conv_state, "lru": s[:, -1].to(x.dtype)}


def rglru_block_decode(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x (B, 1, D) one step. Returns (y (B, 1, D), new_cache). The conv and
    LRU state come back as new tensors and ``cache`` is only read: unlike a
    K/V row write, advancing the recurrence in place would advance it twice
    when the engine re-runs the step after an expert fault, so the caller
    commits the new state once the step is final."""
    gate = _gate_branch(params, x)
    h = x @ params["w_in"].to(x.dtype)
    h, conv_state = causal_conv1d(h, params["conv_w"], params["conv_b"], state=cache["conv"])
    s, lru_state = rglru_step(params, h[:, 0], cache["lru"])
    y = (gate * s[:, None]) @ params["w_out"].to(x.dtype)
    return y, {"conv": conv_state, "lru": lru_state.to(x.dtype)}


# -- sharded forms (a rank's local blocks; ``sharding.comm``) ------------------
#
# The block's channels (``lru_width``, the ``ffn`` axis) are split over
# ``model`` where the rules split them: ``w_in`` and ``w_gate_branch``
# column-parallel, the depthwise conv and the scan on the rank's channels,
# ``w_out`` row-parallel. ``w_r`` and ``w_i`` split their contraction, so
# their partial pre-activations are reduce-scattered over ``model`` to the
# rank's channels before the sigmoid, as GSPMD partitions them (a quarter of
# the dot FLOPs a device on a 2×2 mesh, as the reference's). Under autograd
# (``sharding.comm``) ``x`` enters the ``model`` region before the
# column-parallel weights, the reduce-scatter's backward all-gathers the
# gates' gradient to every channel, and ``b_r`` / ``b_i`` / ``lam``
# (replicated over ``model``) enter it before each rank cuts its channels.


def _channels(params: dict, comm) -> tuple[tuple, int, int]:
    """(mesh dims the channels are split over, first channel, count) of
    this rank's block."""
    w_in = params["w_in"]
    return w_in.split(1), w_in.start(1, comm), w_in.local.shape[1]


def _gates_sharded(params: dict, h: torch.Tensor, comm):
    """``_gates`` for the rank's channels of h (..., W_loc)."""
    dims, c0, n = _channels(params, comm)

    def pre(w) -> torch.Tensor:
        out = h @ w.gathered(comm, ("data",)).to(h.dtype)
        for ax in dims:  # the first dim outermost, as the channels' blocks
            out = comm.reduce_scatter(out, ax, out.dim() - 1)
        return out

    def mine(t) -> torch.Tensor:  # a whole per-channel vector cut to the rank's channels
        t = t.gathered(comm)
        for ax in dims:
            t = comm.enter(t, ax)
        return t[c0:c0 + n]

    return _gate_math(pre(params["w_r"]), pre(params["w_i"]), mine(params["b_r"]), mine(params["b_i"]),
                      mine(params["lam"]), h)


def _temporal_sharded(params: dict, x: torch.Tensor, comm, state: Optional[torch.Tensor]):
    """The gate branch and the conv on the rank's channels: (gate, h, conv state)."""
    for ax in params["w_in"].split(1):
        x = comm.enter(x, ax)
    g = x @ params["w_gate_branch"].gathered(comm, ("data",)).to(x.dtype)
    gate = F.gelu(g.float(), approximate="tanh").to(x.dtype)
    h = x @ params["w_in"].gathered(comm, ("data",)).to(x.dtype)
    h, conv_state = causal_conv1d(h, params["conv_w"].gathered(comm, ("data",)),
                                  params["conv_b"].gathered(comm, ("data",)), state=state)
    return gate, h, conv_state


def _out_sharded(params: dict, y: torch.Tensor, comm) -> torch.Tensor:
    out = y @ params["w_out"].gathered(comm, ("data",)).to(y.dtype)
    for ax in params["w_out"].split(0):
        out = comm.all_reduce(out, ax)
    return out


def rglru_block_forward_sharded(params: dict, x: torch.Tensor, cfg: ModelConfig, comm, *,
                                scan: Optional[Callable] = None):
    """``rglru_block_forward`` on a rank's rows and channels: the scan runs
    on the rank's (B, S, W_loc) block (the recurrence is elementwise per
    channel, so its channels equal the unsharded scan's). Returns (y, cache)
    with the cache's conv and LRU state of the rank's channels."""
    gate, h, conv_state = _temporal_sharded(params, x, comm, None)
    a, b = _gates_sharded(params, h, comm)
    s = (scan or rglru_scan)(a, b)
    y = _out_sharded(params, gate * s.to(h.dtype), comm)
    return y, {"conv": conv_state, "lru": s[:, -1].to(x.dtype)}


def rglru_block_decode_sharded(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig, comm):
    """``rglru_block_decode`` on a rank's rows and channels (``cache`` holds
    the rank's channels); the new state comes back as new tensors."""
    gate, h, conv_state = _temporal_sharded(params, x, comm, cache["conv"])
    a, b = _gates_sharded(params, h[:, 0], comm)
    s = a * cache["lru"].float() + b
    y = _out_sharded(params, gate * s.to(h.dtype)[:, None], comm)
    return y, {"conv": conv_state, "lru": s.to(x.dtype)}

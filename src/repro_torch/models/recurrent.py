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
    r = torch.sigmoid((h @ params["w_r"].to(h.dtype)).float() + params["b_r"].float())
    i = torch.sigmoid((h @ params["w_i"].to(h.dtype)).float() + params["b_i"].float())
    a = torch.exp(-LRU_C * F.softplus(params["lam"].float()) * r)
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

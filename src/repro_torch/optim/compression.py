"""Gradient compression for the slow (cross-pod) axis
(``repro.optim.compression`` counterpart): int8 quantization with error
feedback. Each step sends ``q = round(g / scale)`` in int8 and carries the
residual ``g - q·scale`` into the next step's gradient, so the quantization
error is compensated rather than accumulated. Per-leaf symmetric scaling
(max-abs / 127) keeps the quantizer parameter-free.

Only the single-group form is ported: ``compressed_psum`` without an axis
is the exact pass-through. The reduction over a named axis comes with the
sharding slice (the reference runs it inside ``shard_map``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.utils.tree import tree_map


class EFState(NamedTuple):
    residual: Any  # fp32 tree, same structure as the grads


def init_error_feedback(params: Any) -> EFState:
    return EFState(residual=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def abstract_error_feedback(abstract_params: Any) -> EFState:
    return EFState(residual=tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
                                     abstract_params))


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, fp32 scale). Symmetric max-abs scaling; ties round to even."""
    g32 = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grads: Any, ef: EFState, axis_name: Optional[str], *,
                    denom: Optional[int] = None) -> tuple[Any, EFState]:
    """Error-feedback int8 all-reduce over ``axis_name``. Without an axis (a
    single group) it is the exact pass-through: the grads in fp32 and the
    error-feedback state unchanged."""
    if axis_name is None:
        return tree_map(lambda g: g.to(torch.float32), grads), ef
    raise NotImplementedError(
        f"compressed_psum over axis {axis_name!r} needs a device mesh, which comes with the sharding slice")

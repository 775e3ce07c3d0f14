"""Gradient compression for the slow (cross-pod) axis
(``repro.optim.compression`` counterpart): int8 quantization with error
feedback. Each step sends ``q = round(g / scale)`` in int8 and carries the
residual ``g - q·scale`` into the next step's gradient, so the quantization
error is compensated rather than accumulated. Per-leaf symmetric scaling
(max-abs / 127) keeps the quantizer parameter-free.

``compressed_psum(grads, ef, axis_name)`` reduces over the dim
``axis_name`` of the ambient mesh (``sharding.use_mesh``), where the
reference runs inside ``shard_map``: the int8 payloads are all-reduced as
int32 and the scales summed over that dim's ranks. Without an axis it is
the exact pass-through.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.sharding import current_mesh
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
    """Error-feedback int8 all-reduce over the ambient mesh's dim
    ``axis_name``. Returns (the mean-reduced fp32 grads, the new EF state):
    each leaf plus its residual is quantized, the residual keeps what the
    int8 payload failed to carry, the payloads are summed as int32 and the
    scales summed, and the mean is ``q_sum * (scale_sum / n) / n`` with
    ``n`` the dim's size (or ``denom``), as the reference approximates it.
    Without an axis (a single group) it is the exact pass-through: the grads
    in fp32 and the error-feedback state unchanged."""
    if axis_name is None:
        return tree_map(lambda g: g.to(torch.float32), grads), ef
    mesh = current_mesh()
    if mesh is None or axis_name not in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise ValueError(f"compressed_psum over {axis_name!r} needs a DeviceMesh with that dim under use_mesh()")
    group = mesh.get_group(axis_name)
    n = denom or mesh.shape[mesh.mesh_dim_names.index(axis_name)]

    def one(g, r):
        g32 = g.to(torch.float32) + r
        q, scale = quantize_int8(g32)
        q_sum, scale_sum = q.to(torch.int32), scale.clone()
        dist.all_reduce(q_sum, group=group)
        dist.all_reduce(scale_sum, group=group)
        # the mean, and the residual: what this step failed to send
        return q_sum.to(torch.float32) * (scale_sum / n) / n, g32 - dequantize_int8(q, scale)

    out = _zip_map(one, grads, ef.residual)
    return tree_map(lambda o: o[0], out), EFState(tree_map(lambda o: o[1], out))


def _zip_map(fn, a: Any, b: Any) -> Any:
    """``fn(leaf_a, leaf_b)`` over two trees of the same nested dicts."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)

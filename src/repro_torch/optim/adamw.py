"""AdamW, global-norm clipping and the warmup-cosine schedule
(``repro.optim.adamw`` counterpart): functions over nested dicts of tensors.

Moments are fp32 whatever the params' dtype; the update is computed in fp32
and cast back. ``adamw_update`` returns new tensors; ``adamw_update_``
writes the same numbers in place, leaf by leaf (a sharded train step's
local blocks); both run ``_adamw``. The
bias corrections and the schedule are fp32 tensors, as the reference's are
fp32 arrays, so a step's numbers do not drift with Python's doubles.

The moments are also the canonical FaaSLight "optional collection": 2× the
param bytes that no serving entry can reach. The paper's *before* bundle
holds them (``core.analyzer.write_monolithic``) and file elimination drops
them from *after1*.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.sharding.rules import spec_dims
from repro_torch.utils.tree import flatten_with_paths, tree_from_flat, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any  # fp32 tree
    v: Any  # fp32 tree


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # decay is skipped for leaves of fewer dims (norm scales / biases)
    decay_min_ndim: int = 2


def init_adamw(params: Any) -> AdamWState:
    """Zero moments in fp32 (distinct buffers), on each param's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = flatten_with_paths(params)[0][1].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def abstract_adamw(abstract_params: Any) -> AdamWState:
    """The state's shapes and dtypes on the ``meta`` device."""
    def z():
        return tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), abstract_params)

    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"), m=z(), v=z())


def global_norm(tree: Any, *, specs: Optional[dict] = None, comm=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared fp32 entries, leaves in path
    order. On a rank's blocks (a sharded train step): ``specs`` maps each
    leaf's path to its block's ``PartitionSpec`` and ``comm`` is the rank's
    ``sharding.comm.Comm``; each leaf's sum of squares is all-reduced over
    the mesh dims its spec splits it over (one all-reduce a mesh dim, of
    every leaf's sum at once), so a leaf replicated over a dim counts once."""
    flat = flatten_with_paths(tree)
    sq = [torch.sum(torch.square(x.to(torch.float32))) for _, x in flat]
    dims = [ax for ax, n in (comm.sizes.items() if comm is not None else ()) if n > 1]
    if dims and sq:
        split = [{ax for a in range(len(specs[path])) for ax in spec_dims(specs[path], a)} for path, _ in flat]
        v = torch.stack(sq)
        for ax in dims:
            mask = torch.tensor([ax in names for names in split], device=v.device)
            v = torch.where(mask, comm.all_reduce(torch.where(mask, v, torch.zeros_like(v)), ax), v)
        sq = list(v.unbind())
    return torch.sqrt(sum(sq))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def _adamw(cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any, lr, specs: Optional[dict], comm,
           write: Callable) -> torch.Tensor:
    """One AdamW update, leaf by leaf in path order: ``write(path, (p, m,
    v), (p', m', v'))`` takes each leaf's new param and moments as they are
    computed. Gradients are clipped by the whole gradient's norm
    (``global_norm``, over blocks with ``specs`` / ``comm``). Returns the new
    step count."""
    if cfg.clip_norm:
        scale = _clip_scale(global_norm(grads, specs=specs, comm=comm), cfg.clip_norm)
    step = state.step + 1
    lr_t = cfg.lr if lr is None else lr
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    flat_g, flat_m, flat_v = (dict(flatten_with_paths(t)) for t in (grads, state.m, state.v))
    for path, p in flatten_with_paths(params):
        g, m, v = flat_g[path], flat_m[path], flat_v[path]
        if cfg.clip_norm:
            g = (g.to(torch.float32) * scale).to(g.dtype)
        g32 = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * torch.square(g32)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= cfg.decay_min_ndim:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        write(path, (p, m, v), ((p.to(torch.float32) - lr_t * delta).to(p.dtype), m_new, v_new))
    return step


def adamw_update(
    cfg: AdamWConfig,
    grads: Any,
    state: AdamWState,
    params: Any,
    lr: Optional[Union[float, torch.Tensor]] = None,
) -> tuple[Any, AdamWState]:
    """Returns (new_params, new_state). ``lr`` overrides cfg.lr (schedules)."""
    out = {}
    step = _adamw(cfg, grads, state, params, lr, None, None, lambda path, old, new: out.__setitem__(path, new))
    new_p, new_m, new_v = (tree_from_flat({path: o[i] for path, o in out.items()}) for i in range(3))
    return new_p, AdamWState(step=step, m=new_m, v=new_v)


def adamw_update_(
    cfg: AdamWConfig,
    grads: Any,
    state: AdamWState,
    params: Any,
    lr: Optional[Union[float, torch.Tensor]] = None,
    *,
    specs: Optional[dict] = None,
    comm=None,
) -> AdamWState:
    """``adamw_update`` in place: each leaf of ``params`` and of the moments
    is overwritten with its update as it is computed, so no second tree is
    held. ``specs`` / ``comm``: the trees are a rank's blocks, clipped by the
    whole gradient's norm (``global_norm``). Returns the state with the new
    step and the same moment tensors."""
    def write(path, old, new):
        for dst, src in zip(old, new):
            dst.copy_(src)

    step = _adamw(cfg, grads, state, params, lr, specs, comm, write)
    return AdamWState(step=step, m=state.m, v=state.v)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def warmup_cosine(base_lr: float, warmup: int, total: int, min_frac: float = 0.1) -> Callable:
    """step (int tensor) -> lr (fp32 tensor): linear warmup, then a cosine
    down to ``min_frac`` of ``base_lr`` at ``total``."""

    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = base_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)

    return sched

"""Logical-axis sharding rules → partition specs
(``repro.sharding.rules`` counterpart, over ``torch.distributed``'s
``DeviceMesh``).

Every param leaf carries logical axis names (its ``ParamSpec.axes``);
activations are constrained at block boundaries with logical names. Rules
map a logical name to an *ordered candidate list* of mesh dims; resolution
is greedy, with divisibility checks and first-wins conflicts, so one rule
set serves every architecture (kv_heads = 8 on a 16-way model dim falls
back to replication instead of failing).

Parallelism coverage, as in the reference:
  DP   — "batch" → ("pod", "data")
  FSDP — params' "embed" → "data" (toggle: ModelConfig.fsdp)
  TP   — "heads" / "ffn" / "vocab" → "model"
  EP   — "experts" → "model" (divisibility-gated)
  SP   — "kv_seq" / "seq_shard" → "model"
  PP   — a separate "stage" mesh in ``repro_torch.training.pipeline``

A mesh here is anything with dim names and sizes: a ``DeviceMesh``
(``mesh_dim_names``, ``shape``), the shape-only ``MeshShape`` (which
resolves the production geometries without 256 ranks), or an object with
``axis_names`` and ``devices.shape``. Only placement (``placements()``,
``local_box``) and ``constrain`` on a ``DTensor`` need a real
``DeviceMesh``. A spec entry naming several mesh dims is split in mesh-dim
order (the first dim outermost), which is the only order DTensor knows;
every candidate tuple of the rules lists its dims in that order.
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence

from repro_torch.utils.tree import flatten_with_paths, tree_from_flat, tree_map

# logical axis -> ordered mesh-dim candidates (first divisible unused wins)
PARAM_RULES: dict[str, tuple[str, ...]] = {
    "embed": ("data",),  # FSDP: shard the d_model dim of weights over data
    "ffn": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "layers": (),
}

ACT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    # boundary-only context parallelism: the layer-boundary activation
    # shards its seq dim over "model"; inside a block the first consumer
    # gathers it again (sharding seq inside blocks would book the model dim
    # twice against TP)
    "seq_shard": ("model",),
    "embed": (),
    "ffn": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "kv_seq": ("model",),  # SP: long KV caches over model
    "moe_cap": (),  # the MoE dispatch buffer's capacity dim stays replicated
}


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh-dim name, or a
    tuple of names (the dim split over all of them); trailing Nones are
    trimmed by ``resolve_pspec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and sizes with no process behind it."""
    axis_names: tuple
    shape: tuple


def mesh_sizes(mesh) -> dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh``, a ``MeshShape`` or any
    object with ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = mesh.devices.shape if hasattr(mesh, "devices") else mesh.shape
    return dict(zip(names, (int(s) for s in shape)))


def _entry_names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """A partition spec on a mesh (``jax.sharding.NamedSharding``'s
    counterpart). ``placements()`` is its DTensor form."""
    mesh: Any
    spec: PartitionSpec

    def placements(self) -> tuple:
        """``Shard(d)`` on every mesh dim that spec entry ``d`` names,
        ``Replicate()`` on the others."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_sizes(self.mesh))
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            for ax in _entry_names(entry):
                out[names.index(ax)] = Shard(d)
        return tuple(out)


class _State(threading.local):
    def __init__(self):
        self.mesh = None
        self.param_rules = dict(PARAM_RULES)
        self.act_rules = dict(ACT_RULES)


_STATE = _State()


@contextlib.contextmanager
def use_mesh(mesh, param_rules: Optional[dict] = None, act_rules: Optional[dict] = None):
    """Ambient mesh and rules of this thread, for ``constrain``,
    ``param_shardings`` and ``compressed_psum``."""
    old = (_STATE.mesh, _STATE.param_rules, _STATE.act_rules)
    _STATE.mesh = mesh
    if param_rules is not None:
        _STATE.param_rules = dict(param_rules)
    if act_rules is not None:
        _STATE.act_rules = dict(act_rules)
    try:
        yield
    finally:
        _STATE.mesh, _STATE.param_rules, _STATE.act_rules = old


def set_rules(param_rules: Optional[dict] = None, act_rules: Optional[dict] = None) -> None:
    if param_rules is not None:
        _STATE.param_rules = dict(param_rules)
    if act_rules is not None:
        _STATE.act_rules = dict(act_rules)


def current_mesh():
    return _STATE.mesh


def resolve_pspec(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
                  rules: dict[str, tuple[str, ...]]) -> PartitionSpec:
    """Greedy, divisibility-aware logical → mesh-dim resolution. A logical
    axis may map to a group of mesh dims (batch → ("pod", "data")): the group
    is one entry when the dim divides by the group's combined size, else its
    suffixes are tried, else the dim replicates. Reads only the mesh's dim
    names and sizes."""
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    entries: list = []
    for dim, name in zip(shape, axes):
        assigned = None
        if name is not None:
            group = [a for a in rules.get(name, ()) if a in sizes and a not in used]
            while group:
                if dim % math.prod(sizes[a] for a in group) == 0:
                    assigned = tuple(group)
                    used.update(group)
                    break
                group = group[1:]
        entries.append(None if assigned is None else assigned[0] if len(assigned) == 1 else assigned)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def param_shardings(logical_tree, abstract_tree, mesh=None, fsdp: bool = True) -> dict:
    """Tree of ``NamedSharding`` matching an abstract param tree."""
    mesh = mesh if mesh is not None else _STATE.mesh
    rules = dict(_STATE.param_rules)
    if not fsdp:
        rules["embed"] = ()
    flat_axes = dict(flatten_with_paths(logical_tree))
    return tree_from_flat({path: NamedSharding(mesh, resolve_pspec(flat_axes[path], leaf.shape, mesh, rules))
                           for path, leaf in flatten_with_paths(abstract_tree)})


def spec_shard_divisor(spec: PartitionSpec, mesh) -> int:
    """The number of distinct shards a spec splits an array into: the product
    of the sizes of every mesh dim it names (1 when replicated). A shard
    holds ``nbytes / divisor`` bytes, which is what the tiered residency
    layer charges per device."""
    sizes = mesh_sizes(mesh)
    div = 1
    for entry in spec:
        for ax in _entry_names(entry):
            div *= sizes.get(ax, 1)
    return div


def local_box(shape: Sequence[int], mesh, placements: Sequence) -> tuple:
    """``((start, stop), ...)`` per tensor dim: the part of a global array
    of ``shape`` that this rank holds under ``placements`` on ``mesh`` (a
    ``DeviceMesh`` this rank belongs to). A dim split over several mesh
    dims is split in mesh-dim order. Every split must be even."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    sizes = tuple(mesh.shape)
    index, parts = [0] * len(shape), [1] * len(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            index[p.dim] = index[p.dim] * sizes[m] + coord[m]
            parts[p.dim] *= sizes[m]
    box = []
    for n, i, k in zip(shape, index, parts):
        if n % k:
            raise ValueError(f"dim of {n} split {k} ways is uneven: shape {tuple(shape)}, {tuple(placements)}")
        box.append((i * (n // k), (i + 1) * (n // k)))
    return tuple(box)


def is_dtensor(x) -> bool:
    """True for a ``DTensor`` (no DTensor exists before its module loads)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def place(host, mesh, sharding: NamedSharding, device):
    """A ``DTensor`` on ``mesh`` holding this rank's part of ``host`` (the
    whole array, as every rank reads it): the local block is cut and copied
    to ``device``, and no collective runs."""
    placements = sharding.placements()
    box = local_box(host.shape, mesh, placements)
    local = host[tuple(slice(a, b) for a, b in box)].to(device).contiguous()  # the block alone, not a view
    return _from_local(local, host.shape, mesh, placements)


def place_zeros(shape: Sequence[int], dtype, mesh, sharding: NamedSharding, device):
    """A zero ``DTensor`` of ``shape`` on ``mesh``: each rank allocates its
    own block only."""
    import torch

    placements = sharding.placements()
    box = local_box(shape, mesh, placements)
    return _from_local(torch.zeros([b - a for a, b in box], dtype=dtype, device=device), shape, mesh, placements)


def _from_local(local, shape: Sequence[int], mesh, placements):
    """The DTensor of global, contiguous ``shape`` whose block here is
    ``local`` (no collective: every rank passes its own block)."""
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=tuple(shape),
                              stride=tuple(reversed(stride)))


def gather(x):
    """The whole array of a ``DTensor`` as a plain tensor: ``to_local()``
    (the same storage, no collective) on a mesh whose every dim is 1,
    ``full_tensor()`` (all-gathers) otherwise. Anything else is returned as
    it is."""
    if not is_dtensor(x):
        return x
    if all(s == 1 for s in x.device_mesh.shape):
        return x.to_local()
    return x.full_tensor()


def gather_tree(tree):
    return tree_map(gather, tree)


def constrain(x, axes: Sequence[Optional[str]]):
    """The activation rules under the ambient mesh: a ``DTensor`` is
    redistributed to the resolved placements; a plain tensor is returned as
    it is (eager PyTorch has no layout to propagate), and so is anything
    when no mesh is set."""
    mesh = _STATE.mesh
    if mesh is None or not is_dtensor(x):
        return x
    spec = resolve_pspec(axes, x.shape, mesh, _STATE.act_rules)
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements())

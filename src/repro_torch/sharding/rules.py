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

Local blocks, for a step that computes on shards (``sharding.comm``):
``Shard`` holds a rank's block of a leaf with its whole shape and spec, and
gathers it over chosen mesh dims (``Shard.gathered``: FSDP's gather of one
weight at its use; in a train step, with its gradient reduce-scattered into
the block's fp32 master, ``Shard.master``); ``shard_tree`` takes a
``DTensor`` tree's blocks,
``cut_tree`` cuts whole arrays; ``constrain(comm=...)`` / ``relayout`` move
a local block between two specs, and ``graft_block`` writes a prefix of one
sharded array into another.
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


def constrain(x, axes: Sequence[Optional[str]], *, comm=None, layout: Optional[PartitionSpec] = None):
    """The activation rules. With ``comm`` (a sharded step, ``sharding.
    comm``), ``x`` is a rank's local block laid out as ``layout`` and comes
    back as its block of the resolved spec (``relayout``). Otherwise under
    the ambient mesh a ``DTensor`` is redistributed to the resolved
    placements; a plain tensor is returned as it is (eager PyTorch has no
    layout to propagate), and so is anything when no mesh is set."""
    if comm is not None:
        layout = layout if layout is not None else PartitionSpec()
        shape = global_shape(x.shape, layout, comm)
        return relayout(x, layout, resolve_pspec(axes, shape, comm_mesh(comm), _STATE.act_rules), comm)
    mesh = _STATE.mesh
    if mesh is None or not is_dtensor(x):
        return x
    spec = resolve_pspec(axes, x.shape, mesh, _STATE.act_rules)
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements())


# -- local blocks (the sharded step's view of a leaf) ------------------------


def comm_mesh(comm) -> MeshShape:
    """The dim names and sizes of a ``Comm``'s mesh, for ``resolve_pspec``."""
    return MeshShape(tuple(comm.sizes), tuple(comm.sizes.values()))


def spec_dims(spec: PartitionSpec, axis: int) -> tuple:
    """The mesh dims ``spec`` splits tensor ``axis`` over (``()``: whole)."""
    return _entry_names(spec[axis]) if axis < len(spec) else ()


def global_shape(local_shape: Sequence[int], spec: PartitionSpec, comm) -> tuple:
    """The whole array's shape of a block laid out as ``spec``."""
    return tuple(n * math.prod(comm.size(ax) for ax in spec_dims(spec, a)) for a, n in enumerate(local_shape))


def block_index(shape: Sequence[int], spec: PartitionSpec, comm) -> tuple:
    """This rank's block of an array of ``shape`` under ``spec``, as one
    slice a dim (a dim split over several mesh dims is split in mesh-dim
    order)."""
    index = []
    for a, n in enumerate(shape):
        names = spec_dims(spec, a)
        parts = math.prod(comm.size(ax) for ax in names)
        if n % parts:
            raise ValueError(f"dim of {n} split {parts} ways is uneven: shape {tuple(shape)}, {spec}")
        i = 0
        for ax in names:
            i = i * comm.size(ax) + comm.index(ax)
        index.append(slice(i * (n // parts), (i + 1) * (n // parts)))
    return tuple(index)


def block_of(whole, spec: PartitionSpec, comm):
    """This rank's block of a whole array under ``spec`` (a view,
    ``block_index``)."""
    return whole[block_index(whole.shape, spec, comm)]


def gather_axis(x, axis: int, names: Sequence[str], comm):
    """The block ``x``, split on tensor ``axis`` over mesh dims ``names`` (in
    mesh order), all-gathered over each of them: the innermost first."""
    for ax in reversed(tuple(names)):
        x = comm.all_gather(x, ax, axis)
    return x


def relayout(x, src: PartitionSpec, dst: PartitionSpec, comm):
    """A local block laid out as ``src`` as its block under ``dst``: each
    tensor dim is all-gathered over the mesh dims ``src`` splits it on and
    ``dst`` does not, then cut for those ``dst`` adds (no collective)."""
    if tuple(spec_dims(src, a) for a in range(x.dim())) == tuple(spec_dims(dst, a) for a in range(x.dim())):
        return x
    for a in range(x.dim()):
        if spec_dims(src, a) != spec_dims(dst, a) and spec_dims(src, a):
            x = gather_axis(x, a, spec_dims(src, a), comm)
    cut = PartitionSpec(*(spec_dims(dst, a) if spec_dims(src, a) != spec_dims(dst, a) else None for a in range(x.dim())))
    return block_of(x, cut, comm)


@dataclass(frozen=True)
class Shard:
    """One leaf as a sharded step holds it: this rank's block (``local``), the
    leaf's whole ``shape`` and its ``spec``. In a train step ``local`` is the
    block's compute-dtype copy and ``master`` the fp32 block the gradient
    lands in (a tensor that requires grad); elsewhere ``master`` is None."""
    local: Any
    shape: tuple
    spec: PartitionSpec
    master: Any = None

    def split(self, axis: int) -> tuple:
        """The mesh dims tensor ``axis`` is split over (``()``: whole)."""
        return spec_dims(self.spec, axis)

    def gathered(self, comm, over: Sequence[str] = ("data", "model")):
        """The block all-gathered over the mesh dims in ``over``, one tensor
        dim at a time (the others stay split). With a ``master``, the
        gradient of the result goes to it (``sharding.comm.GatherAtUse``):
        reduce-scattered over ``data`` (the data ranks use the weight on
        their own rows; a leaf ``data`` does not split is all-reduced over it
        instead), and cut back to the rank's block over ``model`` (every
        ``model`` rank uses a weight gathered over ``model`` alike)."""
        x = self.local
        if self.master is None:
            for a in range(x.dim()):
                names = tuple(ax for ax in self.split(a) if ax in over)
                if names:
                    x = gather_axis(x, a, names, comm)
            return x
        from repro_torch.sharding.comm import GatherAtUse

        steps = tuple((a, ax, "sum" if ax == "data" else "slice") for a in range(x.dim())
                      for ax in reversed(self.split(a)) if ax in over and comm.size(ax) > 1)
        split_data = any("data" in self.split(a) for a in range(x.dim()))
        reduce_dims = ("data",) if "data" in over and not split_data and comm.size("data") > 1 else ()
        return GatherAtUse.apply(self.master, x, comm, steps, reduce_dims)

    def start(self, axis: int, comm) -> int:
        """Where this rank's block starts along tensor ``axis`` of the whole."""
        i = 0
        for ax in self.split(axis):
            i = i * comm.size(ax) + comm.index(ax)
        return i * self.local.shape[axis]

    def __getitem__(self, i: int) -> "Shard":
        """Group ``i`` of a stacked leaf (its leading dim is never split)."""
        if self.split(0):
            raise ValueError(f"the stacked dim of {self.shape} is split: {self.spec}")
        return Shard(self.local[i], self.shape[1:], PartitionSpec(*self.spec[1:]),
                     None if self.master is None else self.master[i])


def spec_of(x) -> PartitionSpec:
    """A ``DTensor``'s placements as a spec over its mesh's dim names."""
    from torch.distributed.tensor import Shard as DShard

    names = x.device_mesh.mesh_dim_names
    entries: list = [()] * x.dim()
    for name, p in zip(names, x.placements):
        if isinstance(p, DShard):
            entries[p.dim] = entries[p.dim] + (name,)
    out = [None if not e else e[0] if len(e) == 1 else e for e in entries]
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def shard_tree(tree):
    """``Shard`` leaves of a tree of ``DTensor``s (the local blocks, no copy)."""
    return tree_map(lambda x: Shard(x.to_local(), tuple(x.shape), spec_of(x)), tree)


def cut_tree(tree, specs, comm):
    """``Shard`` leaves of this rank's blocks of a tree of whole arrays,
    each cut by its spec in ``specs`` (a matching tree of ``PartitionSpec``)."""
    if isinstance(tree, dict):
        return {k: cut_tree(v, specs[k], comm) for k, v in tree.items()}
    return Shard(block_of(tree, specs, comm), tuple(tree.shape), specs)


def act_specs(axes_tree, shapes_tree, comm) -> Any:
    """The activation rules' spec of every leaf of a tree (its logical axes in
    ``axes_tree``, its whole shape from ``shapes_tree``'s leaves)."""
    if isinstance(axes_tree, dict):
        return {k: act_specs(v, shapes_tree[k], comm) for k, v in axes_tree.items()}
    return resolve_pspec(axes_tree, tuple(shapes_tree.shape), comm_mesh(comm), _STATE.act_rules)


def graft_block(big, big_spec: PartitionSpec, big_shape: Sequence[int], small, small_spec: PartitionSpec,
                small_shape: Sequence[int], comm) -> None:
    """``serving.engine.graft_prefix`` on blocks: write the whole array of
    ``small`` (a block under ``small_spec``) into the whole array of ``big``
    (a block under ``big_spec``) as a prefix, zeros after it, each rank into
    its own block in place. A dim where the two agree in size and split is
    copied block to block; any other is all-gathered whole over the dims
    that split ``small`` and cut at ``big``'s block. A prefix longer than
    ``big`` raises ValueError, as ``graft_prefix`` does."""
    if any(s > b for s, b in zip(small_shape, big_shape)):
        raise ValueError(f"a prefill cache of shape {tuple(small_shape)} does not fit the decode cache "
                         f"{tuple(big_shape)}: the prompt is longer than a rolling window")
    src, dst = [], []
    for a in range(big.dim()):
        if big_shape[a] == small_shape[a] and spec_dims(big_spec, a) == spec_dims(small_spec, a):
            src.append(slice(None))
            dst.append(slice(None))
            continue
        if spec_dims(small_spec, a):
            small = gather_axis(small, a, spec_dims(small_spec, a), comm)
        i = 0
        for ax in spec_dims(big_spec, a):
            i = i * comm.size(ax) + comm.index(ax)
        lo, n = i * big.shape[a], big.shape[a]
        hi = min(lo + n, small_shape[a])
        src.append(slice(lo, max(lo, hi)))
        dst.append(slice(0, max(0, hi - lo)))
    if tuple(big.shape) != tuple(small.shape) or any(s != slice(None) for s in src):
        big.zero_()
    big[tuple(dst)] = small[tuple(src)]

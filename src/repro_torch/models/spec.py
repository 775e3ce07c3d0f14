"""Parameter-spec machinery: a model is defined once as a nested dict of
``ParamSpec`` leaves, from which we derive concrete initialization, abstract
(``meta``-device) parameters for the analyzer, logical axes, and FaaSLight
access annotations (``repro.models.spec`` counterpart).

Initialization draws from one explicit ``torch.Generator`` leaf by leaf in
path order; it does not reproduce ``jax.random`` numbers (weights shared
with the reference travel through an artifact or ``convert.params_from_numpy``).
It can keep one block of each leaf (a rank's, under a mesh): every number is
drawn as for the whole tree, one layer slice at a time, and only the block's
are kept.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import torch

from repro_torch.utils.tree import flatten_with_paths, tree_from_flat, tree_map

Axes = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Axes  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | lru_a
    scale: float = 1.0
    dtype: torch.dtype = torch.float32
    # FaaSLight access annotation: dense | rows:<axis> | routed | modal:<name>
    access: str = "dense"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device, dtype, index: Optional[tuple] = None) -> torch.Tensor:
    """The leaf, or its block ``index`` (one slice a dim) with the numbers the
    whole leaf would hold there."""
    whole = index is None
    index = tuple(slice(None) for _ in spec.shape) if whole else index
    block = tuple(len(range(*ix.indices(n))) for ix, n in zip(index, spec.shape))
    if spec.init == "zeros":
        return torch.zeros(block, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(block, dtype=dtype, device=device)
    if spec.init == "lru_a":
        # RG-LRU recurrence parameter Λ (Griffin init): a² ~ U[0.9, 0.999],
        # Λ such that sigmoid(Λ) = a^(1/c), c = 8 — the reference's formula
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32, device=device) * (0.999 - 0.9) + 0.9
        root = torch.sqrt(u) ** (1 / 8.0)
        lam = (torch.log(root) - torch.log1p(-root)).to(dtype)
        return lam if whole else lam[index].clone()
    if spec.init != "normal":
        raise NotImplementedError(f"init {spec.init!r} is not ported")
    # fan-in scaled normal; stacking prepends layer dims, so fan-in is shape[-2]
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else 1
    std = spec.scale / max(math.sqrt(fan_in), 1.0)
    out = torch.empty(block, dtype=dtype, device=device)
    # draw in fp32 one layer slice at a time: a full-width stacked expert
    # table would otherwise need a 4-byte copy of the whole leaf; a slice
    # outside the block is drawn (the generator moves on) and dropped
    lead, tail = spec.shape[:-2], spec.shape[-2:] if len(spec.shape) >= 2 else spec.shape
    kept = out.view(-1, *block[len(lead):])
    k = 0
    for i in range(math.prod(lead)):
        draw = torch.randn(tail, generator=gen, dtype=torch.float32, device=device)
        at = [(i // math.prod(lead[a + 1:])) % n for a, n in enumerate(lead)]
        if all(j in range(*ix.indices(n)) for j, ix, n in zip(at, index, lead)):
            kept[k].copy_(draw[index[len(lead):]].mul_(std))
            k += 1
    return out


def init_params(spec_tree: Any, gen: torch.Generator, *, device, dtype_override=None,
                blocks: Optional[dict] = None) -> dict:
    """Every leaf drawn from ``gen`` in path order; with ``blocks`` (path ->
    one slice a dim), only that block of each leaf (``_init_leaf``)."""
    out = {}
    for path, spec in flatten_with_paths(spec_tree):
        dt = dtype_override if dtype_override is not None else spec.dtype
        out[path] = _init_leaf(spec, gen, device, dt, None if blocks is None else blocks[path])
    return tree_from_flat(out)


def abstract_params(spec_tree: Any, dtype_override=None) -> dict:
    """Shape/dtype-only parameters on the ``meta`` device (nothing allocated)."""
    out = {}
    for path, spec in flatten_with_paths(spec_tree):
        dt = dtype_override if dtype_override is not None else spec.dtype
        out[path] = torch.empty(spec.shape, dtype=dt, device="meta")
    return tree_from_flat(out)


def access_annotations(spec_tree: Any) -> dict[str, str]:
    """dotted-path -> access kind, for the FaaSLight partitioner."""
    return {p: s.access for p, s in flatten_with_paths(spec_tree)}


def stack_specs(spec_tree: Any, n: int, axis_name: Optional[str] = "layers") -> Any:
    """Prepend a stacking dim of size ``n`` to every spec leaf."""
    return tree_map(
        lambda s: replace(s, shape=(n,) + s.shape, axes=(axis_name,) + s.axes), spec_tree
    )

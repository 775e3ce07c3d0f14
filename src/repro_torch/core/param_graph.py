"""Call-graph construction: traced dataflow → parameter-leaf reachability
(``repro.core.param_graph`` counterpart).

The reference traces each entry to a jaxpr and runs backward liveness from
its outputs to its parameter inputs. The port traces each entry with
``make_fx`` under a ``FakeTensorMode`` — every tensor is a shape/dtype stand-
in, so nothing is allocated or computed — and runs the same backward
liveness over the resulting flat aten graph, from the output node to the
parameter placeholders. Python control flow (the loop over layer groups) is
unrolled by tracing, so no sub-graph recursion is needed. An op that mutates
one of its inputs is treated as live, the reference's conservative rule for
operations it cannot see through.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from repro_torch.utils.tree import leaf_paths


@dataclass
class ReachabilityReport:
    """``reachable[path]`` is the set of entry names whose backward slice
    contains the leaf; an empty set marks it statically optional."""

    entry_names: list[str]
    reachable: dict[str, set] = field(default_factory=dict)
    n_nodes: dict[str, int] = field(default_factory=dict)

    @property
    def indispensable(self) -> set:
        return {p for p, s in self.reachable.items() if s}

    @property
    def statically_optional(self) -> set:
        return {p for p, s in self.reachable.items() if not s}

    def reaching(self, path: str) -> set:
        return self.reachable.get(path, set())


def _is_mutating(node: torch.fx.Node) -> bool:
    schema = getattr(node.target, "_schema", None)
    return schema is not None and schema.is_mutable


def live_placeholders(gm: torch.fx.GraphModule) -> list[bool]:
    """Backward liveness: which placeholders feed the graph's outputs."""
    live: set = set()
    for node in reversed(gm.graph.nodes):
        if node.op == "output" or node in live or _is_mutating(node):
            live.update(node.all_input_nodes)
    return [n in live for n in gm.graph.nodes if n.op == "placeholder"]


def entry_param_liveness(fn: Callable, params_abstract: Any, args: tuple) -> tuple[dict[str, bool], int]:
    """dotted-path -> is-live for one entry, plus the traced graph's size.
    ``params_abstract`` and ``args`` hold ``meta`` tensors; they are traced
    as fake CPU tensors of the same shapes and dtypes."""
    mode = FakeTensorMode()
    with mode:
        fake = pytree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), (params_abstract, args))
    params, fargs = fake

    def entry(params, *args):  # a plain function: make_fx miscounts bound methods
        return fn(params, *args)

    gm = make_fx(entry, tracing_mode="fake")(params, *fargs)
    live = live_placeholders(gm)

    # placeholders follow pytree order of (params, *args); map the params'
    # share back to dotted paths through the same flattening
    keypaths, _ = pytree.tree_flatten_with_path(params)
    paths = [".".join(str(k.key) for k in kp) for kp, _ in keypaths]
    if len(live) != len(paths) + len(pytree.tree_leaves(fargs)):
        raise RuntimeError("traced graph's inputs do not match the entry's arguments")
    return dict(zip(paths, live[: len(paths)])), len(gm.graph.nodes)


def build_reachability(entries: Iterable, params_abstract: Any) -> ReachabilityReport:
    """Union of per-entry backward slices over the registered entries."""
    report = ReachabilityReport(entry_names=[],
                                reachable={p: set() for p in leaf_paths(params_abstract)})
    for ep in entries:
        liveness, n_nodes = entry_param_liveness(ep.fn, params_abstract, ep.args)
        report.entry_names.append(ep.name)
        report.n_nodes[ep.name] = n_nodes
        for p, alive in liveness.items():
            if alive:
                report.reachable[p].add(ep.name)
    return report

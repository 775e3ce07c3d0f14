"""Dotted-path utilities over nested dicts of tensors.

Parameter trees are nested ``dict``s (no ``nn.Module`` state) so that every
leaf has the reference's canonical dotted path, e.g. ``"groups.u0.attn.wq"``
— the unit at which reachability is computed and at which the optional
store keys its entries. Paths and their order match ``repro.utils.tree``
(dict keys sorted at every level, as ``jax.tree_util`` flattens).
"""

from __future__ import annotations

from typing import Any, Mapping


def flatten_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """``[(dotted_path, leaf), ...]`` with dict keys sorted at every level
    (the reference's flatten order). Non-dict nodes are leaves."""
    out: list[tuple[str, Any]] = []
    _flatten_into(tree, "", out)
    return out


def _flatten_into(node: Any, prefix: str, out: list) -> None:
    # module-level recursion: a recursive closure would form a reference
    # cycle that keeps every flattened tensor alive until the cyclic GC runs
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten_into(node[k], f"{prefix}.{k}" if prefix else str(k), out)
    else:
        out.append((prefix, node))


def leaf_paths(tree: Any) -> list[str]:
    return [p for p, _ in flatten_with_paths(tree)]


def tree_from_flat(flat: Mapping[str, Any]) -> dict:
    """Rebuild a nested dict from dotted paths (integer-looking segments stay
    string keys: parameter trees only hold dicts)."""
    out: dict = {}
    for path, leaf in flat.items():
        parts = path.split(".")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return out


def tree_map(fn, tree: Any) -> Any:
    """Map ``fn(leaf)`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)

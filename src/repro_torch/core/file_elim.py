"""① Optional File Elimination — artifact-collection pruning
(``repro.core.file_elim`` counterpart).

Collections a serving entry can never consume (optimizer state, EMA
shadows, rng and data-pipeline state, metrics) are dropped from the serving
artifact, and leftover temp/backup files next to it are removed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Iterable

from repro_torch.utils.tree import flatten_with_paths

SERVING_OPTIONAL_COLLECTIONS: tuple[str, ...] = ("opt_state", "ema", "rng", "data_state", "metrics")
OPTIONAL_FILE_PATTERNS: tuple[str, ...] = (".tmp", ".bak", ".lock", ".partial")


def tree_bytes(tree: Any) -> int:
    """Total bytes across tensor leaves (meta tensors included)."""
    return sum(t.numel() * t.element_size() for _, t in flatten_with_paths(tree))


@dataclass
class EliminationReport:
    kept_collections: list = field(default_factory=list)
    dropped_collections: dict = field(default_factory=dict)  # name -> bytes

    @property
    def dropped_bytes(self) -> int:
        return sum(self.dropped_collections.values())


def eliminate_collections(
    artifact: dict,
    *,
    for_training: bool = False,
    optional: Iterable[str] = SERVING_OPTIONAL_COLLECTIONS,
) -> tuple[dict, EliminationReport]:
    """Split a full checkpoint tree ({"params": …, "opt_state": …}) into
    (serving artifact, report). Training deployments drop nothing."""
    report = EliminationReport()
    if for_training:
        report.kept_collections = list(artifact)
        return artifact, report
    optional = set(optional)
    kept = {}
    for name, coll in artifact.items():
        if name in optional:
            report.dropped_collections[name] = tree_bytes(coll)
        else:
            kept[name] = coll
            report.kept_collections.append(name)
    return kept, report


def eliminate_files(ckpt_dir: str, patterns: Iterable[str] = OPTIONAL_FILE_PATTERNS) -> list[str]:
    """Remove leftover temp/backup files in a directory. Returns removed paths."""
    removed = []
    if not os.path.isdir(ckpt_dir):
        return removed
    for name in os.listdir(ckpt_dir):
        if any(name.endswith(p) for p in patterns):
            path = os.path.join(ckpt_dir, name)
            try:
                os.remove(path)
                removed.append(path)
            except OSError:
                pass
    return removed

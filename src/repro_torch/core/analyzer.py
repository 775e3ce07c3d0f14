"""FaaSLight orchestration: application → tiered artifact
(``repro.core.analyzer`` counterpart).

``analyze()`` runs the Program Analyzer (entry recognition → reachability →
tier plan) on shape-only stand-ins, with no weights; ``build_artifact()``
runs the Code Generator: given real weights it writes

    <outdir>/
      tier0.bin, tier0.index.json  # indispensable weights, eager-loaded
      optional.blob                # tier-1 units, zlib kv store
      optional.blob.manifest.json
      artifact.json                # plan decisions + sizes

byte-identical to the reference's package for the same weights and level,
so either package serves the other's artifact. ``write_monolithic()`` writes
the paper's two baselines, byte-identical to the reference's too.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.checkpoint import tensorstore_lite as tsl
from repro_torch.core.entrypoints import DeploymentProfile, recognize_entries
from repro_torch.core.file_elim import EliminationReport, eliminate_collections, eliminate_files
from repro_torch.core.optional_store import OptionalStore, OptionalStoreWriter
from repro_torch.core.param_graph import ReachabilityReport, build_reachability
from repro_torch.core.partition import TierPlan, Unit, build_tier_plan
from repro_torch.models.zoo import Model
from repro_torch.utils.tree import flatten_with_paths


@dataclass
class AnalysisResult:
    plan: TierPlan
    reach: ReachabilityReport
    elim: EliminationReport
    profile: DeploymentProfile

    def summary(self) -> dict:
        s = self.plan.summary()
        s["dropped_collections_bytes"] = self.elim.dropped_bytes
        s["entries"] = self.reach.entry_names
        return s


def analyze(
    model: Model,
    profile: DeploymentProfile,
    *,
    collections: Optional[dict] = None,
    hot_units_stats: Optional[dict] = None,
    trace_B: int = 1,
    trace_S: int = 64,
) -> AnalysisResult:
    """The full Program Analyzer pass (shape-only; no weights).
    ``collections`` is the full checkpoint tree; only its keys matter."""
    abstract = model.abstract()
    collections = collections if collections is not None else {"params": abstract}
    _, elim = eliminate_collections(collections, for_training=profile.is_training)
    entries = recognize_entries(model, profile, B=trace_B, S=trace_S)
    reach = build_reachability(entries, abstract)
    plan = build_tier_plan(abstract, model.access(), reach, profile,
                           axes=model.axes(), hot_units_stats=hot_units_stats)
    return AnalysisResult(plan=plan, reach=reach, elim=elim, profile=profile)


def _slice_unit(t: torch.Tensor, unit: Unit) -> torch.Tensor:
    for i in unit.sel:
        t = t[i]
    if unit.rows is not None:
        lo, hi = unit.rows
        t = t[lo:hi]
    return t


def build_artifact(
    params: Any,
    result: AnalysisResult,
    outdir: str,
    *,
    compress_level: int = 6,
) -> dict:
    """Write the two-tier package; returns the artifact metadata. Parameters
    may live on any device; units are copied to the host one at a time and
    compressed in a thread pool (same bytes as one thread)."""
    os.makedirs(outdir, exist_ok=True)
    eliminate_files(outdir)
    plan = result.plan
    flat = dict(flatten_with_paths(params))

    tier0 = {p: flat[p] for p, d in plan.decisions.items() if d.tier == 0}
    tsl.write_bundle(os.path.join(outdir, "tier0"), tier0)

    def tier1_units():
        for path, dec in plan.decisions.items():
            if dec.tier == 1:
                for unit in dec.units:
                    yield unit.key, _slice_unit(flat[path], unit).cpu()

    blob_path = os.path.join(outdir, "optional.blob")
    with OptionalStoreWriter(blob_path, level=compress_level) as w:
        w.add_all(tier1_units())

    store = OptionalStore(blob_path)
    meta = {
        "profile": result.profile.name,
        "entries": result.reach.entry_names,
        "tier0_bytes": plan.tier0_bytes,
        "tier1_raw_bytes": store.raw_bytes,
        "tier1_compressed_bytes": store.compressed_bytes,
        "decisions": {
            p: {
                "tier": d.tier,
                "granularity": d.granularity,
                "reason": d.reason,
                "nbytes": d.nbytes,
                "units": [u.key for u in d.units],
                "resident_units": list(d.resident_units),
            }
            for p, d in plan.decisions.items()
        },
    }
    store.close()
    meta_path = os.path.join(outdir, "artifact.json")
    tmpm = meta_path + ".partial"
    with open(tmpm, "w") as f:
        json.dump(meta, f)
    os.replace(tmpm, meta_path)
    return meta


def write_monolithic(collections: dict, outdir: str, *, pruned: bool = False) -> str:
    """The paper's *before* (full checkpoint) / *after1* (collection-pruned)
    baselines as single uncompressed bundles, ``<outdir>/before`` or
    ``<outdir>/after1``; each leaf is written as ``<collection>.<path>``.
    Returns the bundle's ``.bin`` path."""
    os.makedirs(outdir, exist_ok=True)
    if pruned:
        collections, _ = eliminate_collections(collections)
    flat = {f"{coll}.{path}": leaf
            for coll, tree in collections.items() for path, leaf in flatten_with_paths(tree)}
    prefix = os.path.join(outdir, "after1" if pruned else "before")
    tsl.write_bundle(prefix, flat)
    return prefix + ".bin"

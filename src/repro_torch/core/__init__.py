"""FaaSLight core: Program Analyzer (entry recognition, parameter
reachability, tier partitioning) and Code Generator (optional store,
on-demand loader, artifact builder)."""

from repro_torch.core.analyzer import AnalysisResult, analyze, build_artifact
from repro_torch.core.entrypoints import DeploymentProfile, recognize_entries
from repro_torch.core.file_elim import eliminate_collections, eliminate_files
from repro_torch.core.on_demand import AccessTrace, LoadEvent, LoaderStats, ResidencyManager, TieredParams
from repro_torch.core.optional_store import (
    CorruptFrameError,
    OptionalStore,
    OptionalStoreWriter,
    StoreError,
    StoreSkewError,
    TornFrameError,
    write_store,
)
from repro_torch.core.param_graph import ReachabilityReport, build_reachability, entry_param_liveness
from repro_torch.core.partition import TierDecision, TierPlan, Unit, build_tier_plan

__all__ = [
    "AnalysisResult",
    "analyze",
    "build_artifact",
    "DeploymentProfile",
    "recognize_entries",
    "eliminate_collections",
    "eliminate_files",
    "AccessTrace",
    "LoadEvent",
    "LoaderStats",
    "ResidencyManager",
    "TieredParams",
    "OptionalStore",
    "OptionalStoreWriter",
    "write_store",
    "StoreError",
    "TornFrameError",
    "CorruptFrameError",
    "StoreSkewError",
    "ReachabilityReport",
    "build_reachability",
    "entry_param_liveness",
    "TierDecision",
    "TierPlan",
    "Unit",
    "build_tier_plan",
]

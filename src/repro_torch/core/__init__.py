"""FaaSLight core: Program Analyzer (entry recognition, parameter
reachability, tier partitioning) and Code Generator (optional store,
on-demand loader and prefetcher, artifact builder), profile-guided
re-tiering offline and online (``RetierDaemon``), the host arbiter
(``HostArbiter``: N models under one device budget), warm server snapshots
and the fleet controller (``FleetController``: N replicas, one learned hot
set)."""

from repro_torch.core.analyzer import AnalysisResult, analyze, build_artifact, write_monolithic
from repro_torch.core.arbiter import HostArbiter, HostArbiterStats
from repro_torch.core.entrypoints import (
    SERVING_MULTIMODAL_PROFILE,
    SERVING_PROFILE,
    TRAINING_PROFILE,
    DeploymentProfile,
    recognize_entries,
)
from repro_torch.core.file_elim import eliminate_collections, eliminate_files
from repro_torch.core.fleet import FleetController, FleetStats
from repro_torch.core.on_demand import AccessTrace, LoadEvent, LoaderStats, ResidencyManager, TieredParams
from repro_torch.core.optional_store import (
    CorruptFrameError,
    OptionalStore,
    OptionalStoreWriter,
    ReadStats,
    StoreError,
    StoreSkewError,
    TornFrameError,
    write_store,
)
from repro_torch.core.param_graph import ReachabilityReport, build_reachability, entry_param_liveness
from repro_torch.core.partition import TierDecision, TierPlan, Unit, build_tier_plan
from repro_torch.core.prefetch import Prefetcher, PrefetchStats, TransitionPredictor, merge_hints
from repro_torch.core.retier import (
    RetierReport,
    apply_overlay,
    check_tier0_superset,
    coaccess_order,
    replan_from_trace,
    required_tier0,
    residency_overlay,
    retier_artifact,
)
from repro_torch.core.retier_daemon import RetierDaemon, RetierDaemonStats
from repro_torch.core.snapshot import (
    SNAPSHOT_VERSION,
    artifact_fingerprint,
    capture as capture_server_snapshot,
    restore as restore_server_snapshot,
)

__all__ = [
    "AnalysisResult",
    "analyze",
    "build_artifact",
    "write_monolithic",
    "DeploymentProfile",
    "SERVING_PROFILE",
    "SERVING_MULTIMODAL_PROFILE",
    "TRAINING_PROFILE",
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
    "ReadStats",
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
    "Prefetcher",
    "PrefetchStats",
    "TransitionPredictor",
    "merge_hints",
    "RetierReport",
    "required_tier0",
    "check_tier0_superset",
    "replan_from_trace",
    "residency_overlay",
    "apply_overlay",
    "coaccess_order",
    "retier_artifact",
    "RetierDaemon",
    "RetierDaemonStats",
    "HostArbiter",
    "HostArbiterStats",
    "FleetController",
    "FleetStats",
    "SNAPSHOT_VERSION",
    "artifact_fingerprint",
    "capture_server_snapshot",
    "restore_server_snapshot",
]

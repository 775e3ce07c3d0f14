"""Serving: the cold-start manager (before / after1 / after2) with its
compiled entries (CUDA graphs on the card), the batched generation engine
with on-demand fault-in and prefetch hints, the continuous-batching
scheduler, and the paged KV pool."""

from repro_torch.serving.cold_start import (
    RESIDENCY_PRESETS,
    ColdStartReport,
    ColdStartServer,
    EagerEntry,
    GraphEntry,
    cold_start,
)
from repro_torch.serving.engine import MAX_FAULT_RETRIES, GenerationEngine, RequestStats
from repro_torch.serving.paged_kv import PagePool, PagePoolStats
from repro_torch.serving.scheduler import (
    AdmissionPolicy,
    ContinuousBatchingScheduler,
    FIFOAdmission,
    Request,
    RequestQueue,
    SchedulerStats,
    SLOAdmission,
)

__all__ = [
    "RESIDENCY_PRESETS",
    "ColdStartReport",
    "ColdStartServer",
    "EagerEntry",
    "GraphEntry",
    "cold_start",
    "GenerationEngine",
    "MAX_FAULT_RETRIES",
    "RequestStats",
    "PagePool",
    "PagePoolStats",
    "AdmissionPolicy",
    "ContinuousBatchingScheduler",
    "FIFOAdmission",
    "Request",
    "RequestQueue",
    "SchedulerStats",
    "SLOAdmission",
]

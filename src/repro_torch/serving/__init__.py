"""Serving: the cold-start manager (before / after1 / after2), the batched
generation engine with on-demand fault-in and prefetch hints, and the paged
KV pool."""

from repro_torch.serving.cold_start import RESIDENCY_PRESETS, ColdStartReport, ColdStartServer, cold_start
from repro_torch.serving.engine import MAX_FAULT_RETRIES, GenerationEngine, RequestStats
from repro_torch.serving.paged_kv import PagePool, PagePoolStats

__all__ = [
    "RESIDENCY_PRESETS",
    "ColdStartReport",
    "ColdStartServer",
    "cold_start",
    "GenerationEngine",
    "MAX_FAULT_RETRIES",
    "RequestStats",
    "PagePool",
    "PagePoolStats",
]

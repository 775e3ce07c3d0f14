"""Cold-start manager: artifact → serving-ready state, after2 mode
(``repro.serving.cold_start`` counterpart).

Phases, as in the reference:

  read    — storage → host RAM: the tier-0 bundle, the optional store opened
  upload  — host → device: tier-0 leaves copied up, tier-1 leaves allocated
            as full-shape zeros on the device, the hot set preloaded
  compile — the warm set's first run on the device (one prefill and one
            decode step per warm shape, synchronized): the analogue of the
            reference's XLA compile of its warm entries

Residency policies (``RESIDENCY_PRESETS``) set the tier-1 device budget as a
fraction of tier-1 bytes: strict 25%, full unlimited. The reference's third
preset, stats (50% with an asynchronous prefetcher), is refused: the port
has no prefetcher yet, and without one it would load other units, from
other sources, than the reference does. The reference's full preset turns
its prefetcher on too; the port serves it without one, which the tests hold
equal to the reference's LoadEvents and tokens (on their fixtures the first
prefill faults every tier-1 unit, so the reference's prefetcher finds
nothing left to load).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.checkpoint import tensorstore_lite as tsl
from repro_torch.core.analyzer import AnalysisResult
from repro_torch.core.on_demand import TieredParams
from repro_torch.core.optional_store import OptionalStore
from repro_torch.models.zoo import Model
from repro_torch.utils.tree import flatten_with_paths, tree_from_flat

# residency policy -> tier-1 budget fraction (None = unlimited)
RESIDENCY_PRESETS: dict = {
    "strict": 0.25,
    "full": None,
}


@dataclass
class ColdStartReport:
    mode: str
    read_s: float = 0.0
    upload_s: float = 0.0
    compile_s: float = 0.0
    bytes_read: int = 0
    bytes_uploaded: int = 0

    @property
    def total_s(self) -> float:
        return self.read_s + self.upload_s + self.compile_s

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "read_s": self.read_s,
            "upload_s": self.upload_s,
            "compile_s": self.compile_s,
            "total_s": self.total_s,
            "bytes_read": self.bytes_read,
            "bytes_uploaded": self.bytes_uploaded,
        }


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ColdStartServer:
    """A cold-started model server: the tiered live params and the store."""

    def __init__(self, model: Model, report: ColdStartReport, tiered: TieredParams,
                 store: OptionalStore):
        self.model = model
        self.report = report
        self.tiered = tiered
        self.store = store

    def close(self) -> None:
        if self.store is not None:
            self.store.close()
            self.store = None

    def __enter__(self) -> "ColdStartServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def live_params(self) -> Any:
        return self.tiered.tree()


def cold_start(
    model: Model,
    artifact_dir: str,
    result: AnalysisResult,
    *,
    mode: str = "after2",
    residency: Optional[str] = None,  # RESIDENCY_PRESETS name
    device_budget_bytes: Optional[int] = None,  # overrides the preset budget
    warm_shapes: tuple = ((1, 64),),  # (B, S) pairs run once at cold start
    compile_warm_set: bool = True,
    trace: bool = False,  # attach an AccessTrace to the tiered params
    device="cuda",
) -> ColdStartServer:
    """Run one timed after2 cold start from ``artifact_dir`` with the plan in
    ``result``."""
    if mode != "after2":
        raise ValueError(f"mode {mode!r} is not ported; the port serves after2 artifacts")
    if residency == "stats":  # the reference's stats preset runs its prefetcher (repro.core.prefetch)
        raise ValueError("residency policy 'stats' needs the prefetcher, which is not ported yet")
    if residency is not None and residency not in RESIDENCY_PRESETS:
        raise ValueError(f"unknown residency policy {residency!r}; want one of {sorted(RESIDENCY_PRESETS)}")
    device = torch.device(device)
    report = ColdStartReport(mode=mode)
    plan = result.plan

    t0 = time.perf_counter()
    tier0 = tsl.read_bundle(os.path.join(artifact_dir, "tier0"))
    store = OptionalStore(os.path.join(artifact_dir, "optional.blob"))
    report.bytes_read = sum(t.numel() * t.element_size() for t in tier0.values())
    t1 = time.perf_counter()
    live_flat = {}
    for path, leaf in flatten_with_paths(model.abstract()):
        if plan.decisions[path].tier == 0:
            live_flat[path] = tier0.pop(path).to(device)
        else:
            # the rewritten stub: zeros of the full shape, on the device
            live_flat[path] = torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    tree = tree_from_flat(live_flat)
    _synchronize(device)

    budget = device_budget_bytes
    if residency is not None and budget is None and RESIDENCY_PRESETS[residency] is not None:
        budget = int(RESIDENCY_PRESETS[residency] * plan.tier1_bytes)
        # never below two of the largest units (one incoming + one pinned)
        max_unit = max((e.rsize for e in store.entries.values()), default=0)
        budget = max(budget, 2 * max_unit)
    tiered = TieredParams(tree, plan, store, device_budget_bytes=budget)
    if trace:
        tiered.start_trace()
    # preload the hot set (the paper's offline-profiled module-init list)
    hot = [k for d in plan.decisions.values() for k in d.resident_units]
    moved = tiered.ensure(hot, source="preload") if hot else 0
    _synchronize(device)
    t2 = time.perf_counter()
    report.read_s, report.upload_s = t1 - t0, t2 - t1
    report.bytes_uploaded = report.bytes_read + moved
    server = ColdStartServer(model, report, tiered, store)

    if compile_warm_set:
        t3 = time.perf_counter()
        params = server.live_params()
        with torch.inference_mode():
            for B, S in warm_shapes:
                tokens = torch.zeros((B, S), dtype=torch.int64, device=device)
                model.prefill(params, {"tokens": tokens})
                batch = {"tokens": tokens[:, :1], "pos": torch.zeros(B, dtype=torch.int64, device=device)}
                model.decode_step(params, model.init_cache(B, S, device=device), batch)
        _synchronize(device)
        report.compile_s = time.perf_counter() - t3
    return server

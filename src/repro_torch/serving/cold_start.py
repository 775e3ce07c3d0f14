"""Cold-start manager: artifact → serving-ready state, with the paper's three
variants measured end to end (``repro.serving.cold_start`` counterpart).

Phases, as in the reference:

  read    — storage → host RAM (the monolithic bundle, or the tier-0 bundle
            and the optional store opened)
  upload  — host → device: leaves copied up, tier-1 leaves allocated as
            full-shape zeros on the device, the hot set preloaded
  compile — the warm set's first run on the device (one prefill and one
            decode step per warm shape, synchronized): the analogue of the
            reference's XLA compile of its warm entries

Modes:
  before — monolithic bundle: every collection read, the params uploaded
  after1 — collection-pruned bundle (① Optional File Elimination applied)
  after2 — two-tier artifact: tier-0 read and uploaded, tier-1 placeholders,
           hot units preloaded; misses fault in at request time

Residency policies (``RESIDENCY_PRESETS``, after2 only) — tier-1 device
budget as a fraction of tier-1 bytes, and whether the prefetcher runs:
  strict — 25%, no prefetch
  stats  — 50%, prefetch driven by the engine's hints
  full   — unlimited, prefetch
An explicit ``device_budget_bytes`` overrides the preset's budget, and
``prefetch=`` its prefetch default.
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
from repro_torch.core.prefetch import Prefetcher, TransitionPredictor
from repro_torch.models.zoo import Model
from repro_torch.utils.tree import flatten_with_paths, tree_from_flat

# residency policy -> (tier-1 budget fraction or None = unlimited, prefetch enabled)
RESIDENCY_PRESETS: dict = {
    "strict": (0.25, False),
    "stats": (0.5, True),
    "full": (None, True),
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
    """A cold-started model server: the live params (tiered in after2), the
    optional store and the prefetcher."""

    def __init__(self, model: Model, params: Any, report: ColdStartReport, *,
                 tiered: Optional[TieredParams] = None, store: Optional[OptionalStore] = None,
                 prefetcher: Optional[Prefetcher] = None, artifact_dir: Optional[str] = None):
        self.model = model
        self.params = params
        self.report = report
        self.tiered = tiered
        self.store = store
        self.prefetcher = prefetcher
        self.artifact_dir = artifact_dir

    def close(self) -> None:
        """Stop the prefetcher's threads, then close the store."""
        try:
            if self.prefetcher is not None:
                self.prefetcher.stop()
                self.prefetcher = None
        finally:
            if self.store is not None:
                self.store.close()
                self.store = None

    def __enter__(self) -> "ColdStartServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def live_params(self) -> Any:
        return self.tiered.tree() if self.tiered is not None else self.params


def cold_start(
    model: Model,
    artifact_dir: str,
    result: Optional[AnalysisResult] = None,
    *,
    mode: str = "after2",
    residency: Optional[str] = None,  # RESIDENCY_PRESETS name (after2 only)
    device_budget_bytes: Optional[int] = None,  # overrides the preset budget
    prefetch: Optional[bool] = None,  # overrides the preset's prefetch default
    prefetch_batch_units: int = 8,
    predictor: Optional[TransitionPredictor] = None,  # profile-trained prefetch
    warm_shapes: tuple = ((1, 64),),  # (B, S) pairs run once at cold start
    compile_warm_set: bool = True,
    trace: bool = False,  # attach an AccessTrace to the tiered params
    device="cuda",
) -> ColdStartServer:
    """Run one timed cold start from ``artifact_dir``. ``result`` (the plan)
    is required for after2; before/after1 read ``<artifact_dir>/<mode>``, as
    ``core.analyzer.write_monolithic`` writes it."""
    if residency is not None and residency not in RESIDENCY_PRESETS:
        raise ValueError(f"unknown residency policy {residency!r}; want one of {sorted(RESIDENCY_PRESETS)}")
    device = torch.device(device)
    report = ColdStartReport(mode=mode)

    if mode in ("before", "after1"):
        t0 = time.perf_counter()
        flat = tsl.read_bundle(os.path.join(artifact_dir, mode))  # every byte moves
        report.bytes_read = sum(t.numel() * t.element_size() for t in flat.values())
        t1 = time.perf_counter()
        # upload the params collection only (the others have no device-side
        # consumer at serving time, but their bytes were read)
        pflat = {p[len("params."):]: t for p, t in flat.items() if p.startswith("params.")}
        del flat
        report.bytes_uploaded = sum(t.numel() * t.element_size() for t in pflat.values())
        params = tree_from_flat({p: t.to(device) for p, t in pflat.items()})
        del pflat
        _synchronize(device)
        t2 = time.perf_counter()
        report.read_s, report.upload_s = t1 - t0, t2 - t1
        server = ColdStartServer(model, params, report, artifact_dir=artifact_dir)
    elif mode == "after2":
        if result is None:
            raise ValueError("after2 cold start needs the AnalysisResult (plan)")
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

        budget, want_prefetch = device_budget_bytes, prefetch
        if residency is not None:
            frac, preset_prefetch = RESIDENCY_PRESETS[residency]
            if budget is None and frac is not None:
                budget = int(frac * plan.tier1_bytes)
                # never below two of the largest units (one incoming + one pinned)
                max_unit = max((e.rsize for e in store.entries.values()), default=0)
                budget = max(budget, 2 * max_unit)
            if want_prefetch is None:
                want_prefetch = preset_prefetch
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
        prefetcher = (Prefetcher(tiered, batch_units=prefetch_batch_units, predictor=predictor)
                      if want_prefetch else None)
        server = ColdStartServer(model, tree, report, tiered=tiered, store=store, prefetcher=prefetcher,
                                 artifact_dir=artifact_dir)
    else:
        raise ValueError(f"unknown mode {mode!r}; want before, after1 or after2")

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

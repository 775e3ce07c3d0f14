"""Collective-byte accounting and roofline terms of one dry-run cell
(``repro.utils.hlo`` counterpart).

The dry run (``launch/dryrun.py``) counts each cell with ``utils.hlocost``
(FLOPs, bytes and collectives, per device) and tracks its memory with
``torch.distributed._tools.mem_tracker.MemTracker``; this module turns those
counts into the reference's record fields and its three-term roofline.

Hardware model: one NVIDIA H100 SXM5, from NVIDIA's H100 datasheet (dense,
no sparsity):
  peak bf16 compute : 989 TFLOP/s per card
  HBM3 bandwidth    : 3.35 TB/s per card
  NVLink 4          : 900 GB/s per card, both directions together, so
                      450 GB/s per direction: the rate at which one card's
                      share of a collective leaves it
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional

PEAK_FLOPS = 989e12  # bf16 FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
NVLINK_BW = 450e9  # bytes/s per card and direction
HBM_BYTES = 80 * 10**9  # device memory per card


@dataclass
class CollectiveStats:
    """Per-collective-kind byte totals of one counted call (result bytes, the
    standard proxy for traffic volume per participant)."""

    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


def collective_stats(cost) -> CollectiveStats:
    """The collectives of an ``hlocost.HloCost``."""
    return CollectiveStats(dict(cost.collective_by_kind), dict(cost.collective_count))


@dataclass
class Roofline:
    """Three-term roofline for one (arch, shape, mesh) cell.

    All terms are *seconds for the whole step on the whole mesh*, i.e. the
    per-card serial time assuming perfect overlap within each term.
    """

    arch: str
    shape: str
    mesh: str
    num_chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    bytes_per_device: float = 0.0
    collective_detail: dict = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.num_chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.num_chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        # collective_bytes is already per-participant volume (result bytes);
        # each card moves its share over its NVLink
        return self.collective_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """model FLOPs / counted FLOPs: how much counted compute is 'useful'."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute term / max term: 1.0 means compute-bound at peak."""
        b = self.bound_s
        return self.compute_s / b if b else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s, collective_s=self.collective_s,
                 dominant=self.dominant, useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def roofline_of(rec: dict) -> Roofline:
    """The roofline of a dry-run record (``launch.dryrun.run_cell``)."""
    mem = rec.get("memory", {})
    return Roofline(rec["arch"], rec["shape"], rec["mesh"], rec["num_chips"], rec["hlo_flops"], rec["hlo_bytes"],
                    rec["collective_bytes"], rec["model_flops"],
                    bytes_per_device=mem.get("argument_size_in_bytes", 0) + mem.get("temp_size_in_bytes", 0),
                    collective_detail=rec.get("collectives", {}).get("bytes", {}))


def extract_cost(cost) -> tuple[float, float]:
    """(flops, bytes) of an ``hlocost.HloCost``."""
    return float(cost.flops), float(cost.bytes)


def extract_memory(tracker, *, argument_bytes: int, output_bytes: int, placed_bytes: Optional[int] = None) -> dict:
    """Bytes-per-device figures in ``memory_analysis()``'s names, from a
    ``MemTracker`` that tracked the step (its arguments registered with
    ``track_external``): the local bytes of the arguments the step reads,
    the outputs' local bytes, and the tracked peak less every placed
    argument (``placed_bytes``, default ``argument_bytes``) as temporaries."""
    peak = max((snap["Total"] for snap in tracker.get_tracker_snapshot("peak").values()), default=0)
    placed = argument_bytes if placed_bytes is None else placed_bytes
    return {"argument_size_in_bytes": int(argument_bytes), "output_size_in_bytes": int(output_bytes),
            "temp_size_in_bytes": max(0, int(peak) - int(placed)), "peak_size_in_bytes": int(peak)}


def dense_model_flops(num_params: int, tokens: int) -> float:
    """6·N·D rule of thumb for a train step; callers pass active params for
    MoE and divide by 3 for inference (2·N·D)."""
    return 6.0 * num_params * tokens

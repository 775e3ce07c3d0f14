"""③ Optional Function Generation — the tier-0 / tier-1 split
(``repro.core.partition`` counterpart; the same decisions, unit keys and
byte counts).

Combines the exact graph-level reachability (param_graph) with the model's
access annotations (ParamSpec.access) and the deployment profile into a
per-leaf ``TierDecision`` (DESIGN.md §4). The strategy mirrors §4 of the
paper exactly:

  * *aggressive identification*: any leaf whose bytes can be deferred is
    deferred — unreachable leaves, modal leaves outside the served
    modalities, routed expert tables, cold vocab row-groups;
  * *conservative backstop*: nothing is deleted — every tier-1 unit lives in
    the compressed optional store and is faulted in on first use, so a
    misprediction costs one fetch, never a crash.

Granularity (the paper's function-level unit): whole leaves for dense /
modal leaves; per-expert slices for ``routed`` tables; row-groups for
``rows:N`` tables. The paper's "don't rewrite a nested function whose parent
is already optional" dedup appears here as: units are defined on the leaf
level only — a leaf is exactly one unit set, never nested.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.core.entrypoints import DeploymentProfile
from repro_torch.core.param_graph import ReachabilityReport
from repro_torch.utils.tree import flatten_with_paths


@dataclass(frozen=True)
class Unit:
    """One on-demand loadable unit of a tier-1 leaf.

    ``sel`` is an integer index prefix into the leaf (e.g. ``(layer,
    expert)`` for a scan-stacked expert table, ``(expert,)`` unstacked);
    ``rows`` is a half-open row range on the axis after the prefix.
    ``nbytes`` is the raw (uncompressed) device cost of the unit — the
    quantity the residency budget charges/credits (DESIGN.md §8).
    """

    key: str          # "<path>" | "<path>#l<i>e<j>" | "<path>#rg<i>"
    path: str
    sel: tuple = ()
    rows: Optional[tuple] = None  # (row_start, row_end)
    nbytes: int = 0


@dataclass(frozen=True)
class TierDecision:
    path: str
    tier: int  # 0 = resident at cold start, 1 = on-demand
    granularity: str  # "leaf" | "expert" | "rows"
    reason: str
    nbytes: int
    units: tuple = ()  # tier-1 only
    resident_units: tuple = ()  # tier-1 units preloaded at cold start (hot set)


@dataclass
class TierPlan:
    decisions: dict  # path -> TierDecision
    profile: DeploymentProfile
    entry_names: list

    # -- summary ------------------------------------------------------------
    @property
    def tier0_bytes(self) -> int:
        return sum(d.nbytes for d in self.decisions.values() if d.tier == 0)

    @property
    def tier1_bytes(self) -> int:
        return sum(d.nbytes for d in self.decisions.values() if d.tier == 1)

    @property
    def total_bytes(self) -> int:
        return self.tier0_bytes + self.tier1_bytes

    @property
    def cold_resident_bytes(self) -> int:
        """Bytes uploaded at cold start: tier-0 + preloaded hot units."""
        total = self.tier0_bytes
        for d in self.decisions.values():
            if d.tier == 1 and d.units:
                per_unit = d.nbytes / len(d.units)
                total += int(per_unit * len(d.resident_units))
        return total

    @property
    def tier0_fraction(self) -> float:
        t = self.total_bytes
        return self.tier0_bytes / t if t else 1.0

    def units_for(self, path: str) -> tuple:
        return self.decisions[path].units

    def all_tier1_units(self) -> list[Unit]:
        out = []
        for d in self.decisions.values():
            out.extend(d.units)
        return out

    def summary(self) -> dict:
        n_t1 = sum(1 for d in self.decisions.values() if d.tier == 1)
        return {
            "profile": self.profile.name,
            "leaves": len(self.decisions),
            "tier1_leaves": n_t1,
            "tier0_bytes": self.tier0_bytes,
            "tier1_bytes": self.tier1_bytes,
            "cold_resident_bytes": self.cold_resident_bytes,
            "tier0_fraction": self.tier0_fraction,
            "units": len(self.all_tier1_units()),
        }


def _leaf_nbytes(leaf: Any) -> int:
    return leaf.numel() * leaf.element_size()


def _expert_units(path: str, shape: tuple, expert_axis: int, itemsize: int) -> tuple:
    """Per-expert units; for scan-stacked tables (axes = ("layers",
    "experts", …)) the unit is one (layer, expert) slice — the finest
    granularity a request's routing decision selects."""
    n_exp = shape[expert_axis]
    if expert_axis == 0:
        slice_bytes = math.prod(shape[1:]) * itemsize
        return tuple(
            Unit(f"{path}#e{e}", path, sel=(e,), nbytes=slice_bytes)
            for e in range(n_exp)
        )
    n_layers = shape[0]
    slice_bytes = math.prod(shape[2:]) * itemsize
    return tuple(
        Unit(f"{path}#l{l}e{e}", path, sel=(l, e), nbytes=slice_bytes)
        for l in range(n_layers)
        for e in range(n_exp)
    )


def _row_units(path: str, n_rows: int, group: int, row_nbytes: int) -> tuple:
    n_groups = math.ceil(n_rows / group)
    return tuple(
        Unit(
            f"{path}#rg{g}", path,
            rows=(g * group, min((g + 1) * group, n_rows)),
            nbytes=(min((g + 1) * group, n_rows) - g * group) * row_nbytes,
        )
        for g in range(n_groups)
    )


def build_tier_plan(
    abstract_params: Any,
    access: dict,
    reach: ReachabilityReport,
    profile: DeploymentProfile,
    *,
    axes: Optional[dict] = None,  # path -> logical axes tuple (for expert-axis lookup)
    hot_units_stats: Optional[dict] = None,  # key -> hotness weight (offline stats)
) -> TierPlan:
    """The classification pass. ``access`` is path -> ParamSpec.access."""
    axes = axes or {}
    decisions: dict[str, TierDecision] = {}
    served = set(reach.entry_names)

    for path, leaf in flatten_with_paths(abstract_params):
        nbytes = _leaf_nbytes(leaf)
        acc = access.get(path, "dense")
        reaching = reach.reaching(path) & served

        # 1. unreachable from every served entry — statically optional
        if not reaching:
            decisions[path] = TierDecision(
                path, 1, "leaf",
                "unreachable from served entries (static)", nbytes,
                units=(Unit(path, path, nbytes=nbytes),),
            )
            continue

        # 2. small leaves always resident (norms/biases — the paper's
        #    "magic functions": cheap, ubiquitous, never worth separating)
        if nbytes < profile.min_tier1_bytes:
            decisions[path] = TierDecision(path, 0, "leaf", "small leaf", nbytes)
            continue

        # 3. modal leaves: resident only if the modality is served hot
        if acc.startswith("modal:"):
            modality = acc.split(":", 1)[1]
            if modality in profile.modalities:
                decisions[path] = TierDecision(path, 0, "leaf", f"modal:{modality} served", nbytes)
            else:
                decisions[path] = TierDecision(
                    path, 1, "leaf", f"modal:{modality} not in profile", nbytes,
                    units=(Unit(path, path, nbytes=nbytes),),
                )
            continue

        # 4. routed expert tables: per-(layer,)expert units, stats-selected
        #    residents (``resident_experts`` is *per layer*)
        if acc == "routed":
            leaf_axes = axes.get(path, ())
            expert_axis = leaf_axes.index("experts") if "experts" in leaf_axes else 0
            n_exp = leaf.shape[expert_axis]
            if profile.resident_experts < 0:
                decisions[path] = TierDecision(path, 0, "expert", "baseline: all experts resident", nbytes)
                continue
            units = _expert_units(path, tuple(leaf.shape), expert_axis, leaf.element_size())
            n_res = min(profile.resident_experts, n_exp)
            # group units by layer prefix so each layer keeps n_res residents
            by_layer: dict = {}
            for u in units:
                by_layer.setdefault(u.sel[:-1], []).append(u)
            resident = []
            for layer_units in by_layer.values():
                if hot_units_stats:
                    layer_units = sorted(layer_units, key=lambda u: -hot_units_stats.get(u.key, 0.0))
                resident.extend(u.key for u in layer_units[:n_res])
            decisions[path] = TierDecision(
                path, 1, "expert", "routed expert table", nbytes,
                units=units, resident_units=tuple(resident),
            )
            continue

        # 5. row-indexed tables (embeddings): row-group units, hot fraction
        if acc.startswith("rows:"):
            n_rows = leaf.shape[int(acc.split(":")[1])]
            if profile.hot_vocab_fraction >= 1.0:
                decisions[path] = TierDecision(path, 0, "rows", "baseline: all rows resident", nbytes)
                continue
            units = _row_units(path, n_rows, profile.vocab_row_group, nbytes // n_rows)
            n_res = int(math.ceil(len(units) * profile.hot_vocab_fraction))
            if hot_units_stats:
                ranked = sorted(units, key=lambda u: -hot_units_stats.get(u.key, 0.0))
                resident = tuple(u.key for u in ranked[:n_res])
            else:
                resident = tuple(u.key for u in units[:n_res])
            decisions[path] = TierDecision(
                path, 1, "rows", "row-indexed table", nbytes,
                units=units, resident_units=resident,
            )
            continue

        # 6. densely consumed by a served entry — indispensable
        decisions[path] = TierDecision(path, 0, "leaf", f"dense, reached by {sorted(reaching)[:2]}", nbytes)

    return TierPlan(decisions=decisions, profile=profile, entry_names=list(reach.entry_names))

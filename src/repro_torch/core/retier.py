"""⑥ Profile-guided re-tiering, the offline half (``repro.core.retier``
counterpart: the same plans, reports and artifact bytes).

Static reachability can misjudge: a unit the analyzer deferred to tier-1 but
every request touches pays its fault on the first request after every cold
start. ``replan_from_trace`` rewrites the tier plan from one profiling run's
``AccessTrace``:

  * promote — tier-1 units the trace saw demand-faulted join the cold-start
    hot set (``TierDecision.resident_units``), hottest first under an
    optional ``max_promote_bytes``; a whole-leaf tier-1 decision whose one
    unit faulted moves to tier-0;
  * demote — preloaded units the trace never touched leave the hot set; a
    tier-0 leaf is demoted only when no served entry reaches it.

The safety invariant (``check_tier0_superset``): the new tier-0 holds every
entry-reachable leaf the old plan held there. A dense leaf has no runtime
fault detector (vocab rows are pre-faulted exactly, routed experts retried
from the usage masks), so a demoted one would compute on placeholder zeros.
Tier-0 demotion therefore never reads the trace, and the invariant is
checked again on the final plan.

``retier_artifact`` writes the replanned artifact beside the old one, in
``<out_dir>.partial``, and publishes it with ``checkpoint.manager.commit_dir``;
the source artifact is never touched. Units that stay tier-1 are copied as
their compressed frames (``OptionalStoreWriter.add_raw``: no decode, no
recompress); only a leaf that changes tier is decoded or encoded. With a
trace, the new blob is laid out in co-access order (``coaccess_order``).
The online half, which applies replanned hot sets to a running server, is
``core/retier_daemon.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.checkpoint import tensorstore_lite as tsl
from repro_torch.checkpoint.manager import commit_dir
from repro_torch.core.on_demand import AccessTrace
from repro_torch.core.optional_store import OptionalStore, OptionalStoreWriter
from repro_torch.core.param_graph import ReachabilityReport
from repro_torch.core.partition import TierDecision, TierPlan, Unit


@dataclass
class RetierReport:
    """What one profile → re-tier cycle changed, for logs and artifact.json."""

    promoted_resident: list = field(default_factory=list)  # units joining the hot set
    demoted_resident: list = field(default_factory=list)   # hot-set units dropped
    promoted_leaves: list = field(default_factory=list)    # whole leaves tier-1 → tier-0
    demoted_leaves: list = field(default_factory=list)     # whole leaves tier-0 → tier-1
    promoted_bytes: int = 0   # cold-start bytes added
    demoted_bytes: int = 0    # cold-start bytes shed
    budget_skipped: int = 0   # promotion candidates dropped by max_promote_bytes

    def summary(self) -> dict:
        return {
            "promoted_resident": len(self.promoted_resident),
            "demoted_resident": len(self.demoted_resident),
            "promoted_leaves": len(self.promoted_leaves),
            "demoted_leaves": len(self.demoted_leaves),
            "promoted_bytes": self.promoted_bytes,
            "demoted_bytes": self.demoted_bytes,
            "budget_skipped": self.budget_skipped,
        }


def required_tier0(plan: TierPlan, reach: ReachabilityReport) -> set:
    """The leaves re-tiering must never demote: tier-0 leaves some served
    entry reaches. A function of the plan and the static analysis only, so
    no trace can change it."""
    return {p for p, d in plan.decisions.items() if d.tier == 0 and reach.reaching(p)}


def check_tier0_superset(plan: TierPlan, required: set) -> None:
    """Raise unless every required leaf is tier-0 in ``plan``."""
    missing = sorted(p for p in required if plan.decisions[p].tier != 0)
    if missing:
        raise ValueError(f"re-tier invariant violated: entry-reachable leaves left tier-0: "
                         f"{missing[:5]}{'...' if len(missing) > 5 else ''}")


def replan_from_trace(
    plan: TierPlan,
    trace: AccessTrace,
    reach: ReachabilityReport,
    *,
    promote_min_faults: int = 1,
    max_promote_bytes: Optional[int] = None,
    promote_leaves: bool = True,
    demote_untouched_residents: bool = True,
) -> tuple[TierPlan, RetierReport]:
    """Rewrite the tier plan from one profiling run's access trace.

    Deterministic: candidates rank by (fault count desc, key). An empty trace
    (``batches == 0``) demotes nothing, so a misconfigured profiling run
    cannot wipe the offline hot set."""
    required = required_tier0(plan, reach)
    report = RetierReport()

    candidates: list[tuple[int, Unit, str]] = []  # (faults, unit, path)
    for path, dec in plan.decisions.items():
        if dec.tier != 1:
            continue
        resident = set(dec.resident_units)
        for u in dec.units:
            n = trace.faults.get(u.key, 0)
            if u.key not in resident and n >= max(1, promote_min_faults):
                candidates.append((n, u, path))
    candidates.sort(key=lambda c: (-c[0], c[1].key))

    promote: dict[str, set] = {}  # path -> unit keys joining the hot set
    spent = 0
    for n, u, path in candidates:
        if max_promote_bytes is not None and spent + u.nbytes > max_promote_bytes:
            report.budget_skipped += 1
            continue
        spent += u.nbytes
        promote.setdefault(path, set()).add(u.key)

    decisions: dict[str, TierDecision] = {}
    for path, dec in plan.decisions.items():
        if dec.tier == 0:
            # static only: no trace can pull a reachable dense leaf out
            if path not in required and reach.reaching(path) == set():
                decisions[path] = TierDecision(path, 1, "leaf", "re-tier: unreachable from served entries",
                                               dec.nbytes, units=(Unit(path, path, nbytes=dec.nbytes),))
                report.demoted_leaves.append(path)
                report.demoted_bytes += dec.nbytes
            else:
                decisions[path] = dec
            continue

        added = promote.get(path, set())
        if promote_leaves and dec.granularity == "leaf" and len(dec.units) == 1 and dec.units[0].key in added:
            n = trace.faults.get(dec.units[0].key, 0)
            decisions[path] = TierDecision(path, 0, "leaf", f"re-tier: faulted {n}x in profile", dec.nbytes)
            report.promoted_leaves.append(path)
            report.promoted_bytes += dec.nbytes
            continue

        resident = list(dec.resident_units)
        by_key = {u.key: u for u in dec.units}
        if demote_untouched_residents and trace.batches > 0:
            kept, dropped = [], []
            for k in resident:
                (kept if trace.touches.get(k, 0) > 0 else dropped).append(k)
            resident = kept
            report.demoted_resident.extend(dropped)
            report.demoted_bytes += sum(by_key[k].nbytes for k in dropped if k in by_key)
        if added:
            ordered = sorted(added, key=lambda k: (-trace.faults.get(k, 0), k))
            resident = resident + [k for k in ordered if k not in resident]
            report.promoted_resident.extend(ordered)
            report.promoted_bytes += sum(by_key[k].nbytes for k in ordered if k in by_key)
        decisions[path] = dataclasses.replace(dec, resident_units=tuple(resident))

    new_plan = TierPlan(decisions=decisions, profile=plan.profile, entry_names=list(plan.entry_names))
    check_tier0_superset(new_plan, required)
    return new_plan, report


def residency_overlay(plan: TierPlan) -> dict[str, list[str]]:
    """A plan's residency state as plain JSON: tier-1 path → its hot-set unit
    keys, hottest first."""
    return {path: list(dec.resident_units) for path, dec in sorted(plan.decisions.items()) if dec.tier == 1}


def apply_overlay(plan: TierPlan, overlay: dict[str, list[str]]) -> TierPlan:
    """A NEW plan whose tier-1 hot sets are the overlay's, filtered to the
    unit keys each decision owns. Paths absent from the overlay and every
    tier-0 decision are untouched, so no tier ever flips."""
    decisions = dict(plan.decisions)
    for path, keys in overlay.items():
        dec = decisions.get(path)
        if dec is None or dec.tier != 1:
            continue
        owned = {u.key for u in dec.units}
        decisions[path] = dataclasses.replace(dec, resident_units=tuple(k for k in keys if k in owned))
    return TierPlan(decisions=decisions, profile=plan.profile, entry_names=list(plan.entry_names))


def coaccess_order(keys: list, pairs: dict) -> list:
    """Unit keys ordered by observed co-access: pairs taken strongest first
    (ties by the sorted key pair) chain the two keys' clusters together;
    clusters come out by first appearance in ``sorted(keys)``, and keys
    without a pair keep their sorted place. So the strongest pairs end up
    byte-adjacent in the blob."""
    keys = list(keys)
    keyset = set(keys)
    cluster_of: dict = {k: [k] for k in keys}
    ranked = sorted(((count, a, b) for (a, b), count in pairs.items()
                     if a in keyset and b in keyset and count > 0),
                    key=lambda t: (-t[0], t[1], t[2]))
    for _, a, b in ranked:
        ca, cb = cluster_of[a], cluster_of[b]
        if ca is cb:
            continue
        ca.extend(cb)
        for k in cb:
            cluster_of[k] = ca
    out: list = []
    seen: set = set()
    for k in sorted(keys):
        c = cluster_of[k]
        if id(c) not in seen:
            seen.add(id(c))
            out.extend(c)
    return out


def retier_artifact(
    artifact_dir: str,
    plan: TierPlan,
    *,
    out_dir: Optional[str] = None,
    report: Optional[RetierReport] = None,
    compress_level: int = 6,
    trace: Optional[AccessTrace] = None,
) -> dict:
    """Write the artifact of ``plan`` from the artifact in ``artifact_dir``,
    with no model weights: a promoted leaf's bytes leave the optional store
    for the tier-0 bundle, a demoted leaf's go the other way, and expert and
    row units stay where they are (only their hot-set membership, kept in
    artifact.json, changes). ``out_dir`` (default ``<artifact_dir>-retier``)
    must differ from ``artifact_dir``: the old files are read while the new
    ones are written, into ``<out_dir>.partial``, which ``commit_dir``
    publishes. Returns the new artifact.json meta.

    The old tier-0 bundle is mapped, not read, so each leaf's pages are
    touched only while it is copied. Units that stay tier-1 are copied as
    raw frames; ``meta["compaction"]`` counts them (``raw_copied``) and the
    frames encoded anew (``recompressed``, 0 for an unchanged plan). With a
    ``trace`` the blob is laid out in co-access order (its request pairs,
    else its batch pairs), else in the source store's offset order."""
    out_dir = out_dir if out_dir is not None else artifact_dir.rstrip("/") + "-retier"
    if os.path.abspath(out_dir) == os.path.abspath(artifact_dir):
        raise ValueError("retier_artifact reads artifact_dir while writing: out_dir must be a different directory")
    old_tier0 = tsl.read_bundle(os.path.join(artifact_dir, "tier0"), mmap=True)
    store = OptionalStore(os.path.join(artifact_dir, "optional.blob"))
    try:
        tmp = out_dir.rstrip("/") + ".partial"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        tier0: dict[str, torch.Tensor] = {}
        for path, dec in plan.decisions.items():
            if dec.tier != 0:
                continue
            if path in old_tier0:
                tier0[path] = old_tier0[path]
            elif path in store.entries:  # promoted whole leaf
                tier0[path] = store.fetch(path)
            else:
                raise KeyError(f"tier-0 leaf {path!r} found in neither the old bundle "
                               f"nor the optional store: artifact/plan mismatch")
        tsl.write_bundle(os.path.join(tmp, "tier0"), tier0)
        del tier0

        unit_src: dict[str, str] = {}  # unit key -> its leaf's path
        for path, dec in plan.decisions.items():
            if dec.tier == 1:
                for unit in dec.units:
                    unit_src[unit.key] = path
        t1_keys = sorted(unit_src, key=lambda k: store.entries[k].offset if k in store.entries else -1)
        layout = {"source": "source-order"}
        if trace is not None:
            pairs = trace.request_pairs or trace.pairs
            if pairs:
                t1_keys = coaccess_order(t1_keys, pairs)
                layout = {"source": "coaccess", "pairs": "request" if trace.request_pairs else "batch"}

        raw_copied = recompressed = 0
        with OptionalStoreWriter(os.path.join(tmp, "optional.blob"), level=compress_level, layout=layout) as w:
            for key in t1_keys:
                path = unit_src[key]
                if key in store.entries:  # stays tier-1: the frame moves verbatim
                    w.add_raw(key, store.read_raw(key), store.entries[key])
                    raw_copied += 1
                elif path in old_tier0:  # demoted whole leaf
                    w.add(key, old_tier0[path])
                    recompressed += 1
                else:
                    raise KeyError(f"tier-1 unit {key!r} found in neither the optional store "
                                   f"nor the old tier-0 bundle")

        new_store = OptionalStore(os.path.join(tmp, "optional.blob"))
        meta = {
            "profile": plan.profile.name,
            "entries": list(plan.entry_names),
            "tier0_bytes": plan.tier0_bytes,
            "tier1_raw_bytes": new_store.raw_bytes,
            "tier1_compressed_bytes": new_store.compressed_bytes,
            "retier": report.summary() if report is not None else {},
            "compaction": {"layout": layout, "raw_copied": raw_copied, "recompressed": recompressed},
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
        new_store.close()
        with open(os.path.join(tmp, "artifact.json"), "w") as f:
            json.dump(meta, f)

        commit_dir(tmp, out_dir)
        return meta
    finally:
        store.close()

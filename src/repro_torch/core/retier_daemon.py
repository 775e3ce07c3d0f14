"""⑦ Online re-tiering: the hot set adapts while the server runs
(``repro.core.retier_daemon`` counterpart).

Applying a re-tiered plan offline needs a restart, the very cold start
FaaSLight cuts. The ``RetierDaemon`` applies plan changes to the running
server instead:

    serve ──▶ live AccessTrace ──rotate on cadence──▶ decayed merge ──▶
    replan_from_trace ──▶ apply in place:
        promote  = preload through the Prefetcher (or a synchronous preload
                   between steps when there is no prefetcher)
        demote   = eviction (never pinned, LOADING or mid-step units)
    ... and retrain the TransitionPredictor from the merged trace;
    rewriting the artifact becomes an optional periodic compaction.

The daemon owns no thread. The serving loop calls ``maybe_tick()`` between
steps (the scheduler's ``step()`` boundary, after each of ``generate()``'s
steps), never inside one, so a tick never races a step's pinned working
set; in the port that also means no forward run holds ``TieredParams.gate``
while a tick's evictions and installs take it. Any thread may call
``tick()``; the daemon's state is behind one lock, and every change to the
loader goes through ``TieredParams``' locked API.

Safety rules, as the reference's:

  * the tier-0 ⊇ entry-reachable invariant is checked again with
    ``check_tier0_superset`` on EVERY plan application, against the required
    set computed once from the static analysis;
  * leaf tier promotion is off live (``promote_leaves=False``): a tier-1 →
    tier-0 flip changes the artifact layout, not the running tree; hot
    whole-leaf units are preloaded like any other promotion and move tiers
    at the next compaction;
  * an application only changes the hot-set membership of units the live
    loader owns;
  * demotion goes through ``TieredParams.evict``, which skips pinned,
    LOADING and cold units.

The fleet's hooks: ``pull_window()`` hands a controller this replica's
rotated trace window (folding it into the local history as a tick would),
and ``apply_plan()`` applies a plan replanned elsewhere under the same
rules, checking the tier-0 invariant here before any change, so a bad
remote plan is refused whole.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.on_demand import AccessTrace, TieredParams
from repro_torch.core.prefetch import Prefetcher, TransitionPredictor
from repro_torch.core.retier import (
    RetierReport,
    check_tier0_superset,
    replan_from_trace,
    required_tier0,
    retier_artifact,
)


@dataclass
class RetierDaemonStats:
    """One daemon's lifetime accounting (printed by the launcher, asserted
    by the tests and chip_smoke)."""

    ticks: int = 0              # cadence firings (incl. skipped ones)
    skipped_empty: int = 0      # ticks with fewer than min_batches new batches
    errors: int = 0             # ticks that raised and were absorbed
    applies: int = 0            # ticks that applied a replanned hot set
    invariant_checks: int = 0   # tier-0 superset re-verifications (== applies)
    promoted_units: int = 0     # hot-set joins queued for preload
    demoted_units: int = 0      # hot-set drops submitted for eviction
    evicted_units: int = 0      # demotions that actually freed bytes
    evicted_bytes: int = 0
    preload_bytes: int = 0      # synchronous (no-prefetcher) preload traffic
    predictor_refreshes: int = 0
    compactions: int = 0        # periodic artifact rewrites (completed)
    compact_errors: int = 0     # background compactions that failed (absorbed)
    compact_skipped_inflight: int = 0  # cadence hits while one was running
    compact_wall_s: float = 0.0  # total worker-thread compaction wall time
    max_tick_s: float = 0.0     # slowest tick observed — the serve-path cost
    pulls: int = 0              # fleet window pulls
    remote_applies: int = 0     # fleet plans applied via apply_plan()

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class RetierDaemon:
    """Applies profile-guided re-tiering to a live ``TieredParams``.

    ``maybe_tick()`` fires after ``interval_steps`` serving steps or
    ``interval_s`` wall-clock seconds, whichever comes first. Each tick
    rotates the live trace (``TieredParams.rotate_trace``), folds the
    finished window into the decayed history (``AccessTrace.merge``),
    replans against the merged trace, and applies the plan in
    place under the module's safety rules. With ``compact_every=N``
    every Nth application also rewrites the artifact out-of-place
    (``retier_artifact``) so the *next* cold start boots the adapted hot
    set — compaction is bookkeeping, not a serving event.
    """

    def __init__(
        self,
        tiered: TieredParams,
        reach,  # core.param_graph.ReachabilityReport
        *,
        prefetcher: Optional[Prefetcher] = None,
        interval_steps: int = 32,
        interval_s: Optional[float] = None,
        decay: float = 0.5,
        min_batches: int = 1,
        promote_min_faults: int = 1,
        max_promote_bytes: Optional[int] = None,
        refresh_predictor: bool = True,
        predictor_top_k: int = 8,
        compact_every: int = 0,
        artifact_dir: Optional[str] = None,
        compact_out_dir: Optional[str] = None,
    ):
        if interval_steps < 1:
            raise ValueError(f"interval_steps must be >= 1, got {interval_steps}")
        if not 0.0 <= decay <= 1.0:
            # fail HERE, not two ticks into serving when merge() first runs
            raise ValueError(f"decay must be in [0, 1], got {decay!r}")
        if compact_every and not artifact_dir:
            raise ValueError("compact_every needs artifact_dir to rewrite from")
        self.tiered = tiered
        self.reach = reach
        self.prefetcher = prefetcher
        self.interval_steps = interval_steps
        self.interval_s = interval_s
        self.decay = decay
        self.min_batches = max(1, min_batches)
        self.promote_min_faults = promote_min_faults
        self.max_promote_bytes = max_promote_bytes
        self.refresh_predictor = refresh_predictor
        self.predictor_top_k = predictor_top_k
        self.compact_every = compact_every
        self.artifact_dir = artifact_dir
        self.compact_out_dir = compact_out_dir
        self.stats = RetierDaemonStats()
        self.last_report: Optional[RetierReport] = None
        self.last_error: str = ""
        self.last_compaction: Optional[dict] = None  # meta of the last rewrite
        self.last_compact_error: str = ""
        self._lock = threading.Lock()
        # compaction worker state lives behind its OWN lock so the worker
        # thread never contends with (or deadlocks against) a serving tick
        # holding self._lock
        self._compact_lock = threading.Lock()
        self._compact_thread: Optional[threading.Thread] = None
        self._merged: Optional[AccessTrace] = None
        self._unpulled: Optional[AccessTrace] = None  # accumulated for the fleet
        self._steps_since = 0
        self._last_tick_t = time.monotonic()
        # the invariant's required set is a function of the ORIGINAL plan
        # and the static analysis only — computed once, so no
        # sequence of applications can erode what must stay tier-0
        self._required = required_tier0(tiered.plan, reach)
        if tiered.trace is None:
            tiered.start_trace(AccessTrace())

    # -- cadence ----------------------------------------------------------------
    def maybe_tick(self, steps: int = 1) -> Optional[RetierReport]:
        """Count serving steps; tick when the step or wall-clock interval
        elapses. Called between batches — NEVER inside a step (the daemon's
        contract; enforced by call-site placement in engine/scheduler).

        Never raises: re-tiering is bookkeeping, not a serving event — a
        failing tick (compaction I/O, a store read during a sync preload)
        is absorbed into ``stats.errors``/``last_error`` and serving
        continues. An invariant failure aborts before any mutation; a
        mid-apply I/O failure leaves only committed evictions/preloads,
        which the loader treats as ordinary (refault or warm hit)."""
        with self._lock:
            self._steps_since += steps
            due = self._steps_since >= self.interval_steps or (
                self.interval_s is not None
                and time.monotonic() - self._last_tick_t >= self.interval_s
            )
            if not due:
                return None
            return self._tick_absorbed()

    def tick(self) -> Optional[RetierReport]:
        """Force one re-tier cycle now (tests, shutdown flushes). Same
        never-raises contract as ``maybe_tick``."""
        with self._lock:
            return self._tick_absorbed()

    def _tick_absorbed(self) -> Optional[RetierReport]:
        t0 = time.monotonic()
        try:
            return self._tick_locked()
        except Exception as e:  # degrade, don't kill the serving loop
            self.stats.errors += 1
            self.last_error = repr(e)
            return None
        finally:
            # the serve-path cost of a tick — with compaction off-thread
            # this stays flat even while an artifact rewrites
            self.stats.max_tick_s = max(
                self.stats.max_tick_s, time.monotonic() - t0)

    @property
    def merged_trace(self) -> Optional[AccessTrace]:
        """The decayed cross-window history the last replan saw."""
        with self._lock:
            return self._merged

    def trace_snapshot(self) -> AccessTrace:
        """History + the still-open live window, merged the same way the
        next tick would — what ``--profile-out`` saves when the daemon is
        on (the raw live window alone would miss everything already
        folded into the history)."""
        live = self.tiered.trace_snapshot()
        with self._lock:
            if self._merged is None:
                return live if live is not None else AccessTrace()
            if live is None or not live.batches:
                return self._merged
            return self._merged.merge(live, decay=self.decay)

    # -- one cycle ---------------------------------------------------------------
    def _tick_locked(self) -> Optional[RetierReport]:
        self.stats.ticks += 1
        self._steps_since = 0
        self._last_tick_t = time.monotonic()
        window = self.tiered.rotate_trace()
        if window is None:
            self.stats.skipped_empty += 1
            return None
        self._accumulate_unpulled(window)
        if window.batches < self.min_batches:
            # too little signal to replan on, but don't throw it away:
            # fold it in undecayed so slow traffic still accumulates
            self.stats.skipped_empty += 1
            if window.batches:
                self._merged = (
                    window if self._merged is None
                    else self._merged.merge(window, decay=1.0)
                )
            return None
        self._merged = (
            window if self._merged is None
            else self._merged.merge(window, decay=self.decay)
        )
        new_plan, report = replan_from_trace(
            self.tiered.plan,
            self._merged,
            self.reach,
            promote_min_faults=self.promote_min_faults,
            max_promote_bytes=self.max_promote_bytes,
            promote_leaves=False,  # tier flips wait for compaction
        )
        self._apply(new_plan)
        self.last_report = report
        arb = getattr(self.tiered, "arbiter", None)
        if arb is not None:
            # host-governance feedback: hand the arbiter
            # this tenant's decayed heat for victim scoring, and fold the
            # tick's observed refault/overshoot deltas into share tuning
            arb.note_trace(self.tiered, self._merged)
            arb.observe_tick(self.tiered)
        return report

    # -- fleet hooks -------------------------------------------
    def _accumulate_unpulled(self, window: AccessTrace) -> None:
        """Every rotated window (tick OR pull) also lands — undecayed,
        plain-sum — in the since-last-pull accumulator, so the fleet's
        ``pull_window`` sees everything this replica observed regardless
        of how its local tick cadence happened to chop the trace up. The
        undecayed sum keeps the pulled windows commutative across
        replicas."""
        if not window.batches:
            return
        self._unpulled = (
            window if self._unpulled is None
            else self._unpulled.merge(window, decay=1.0)
        )

    def pull_window(self) -> Optional[AccessTrace]:
        """Rotate the live trace and hand the controller EVERYTHING this
        replica observed since the last pull (rotated window + any
        windows local ticks already consumed). The live window is ALSO
        folded into the local decayed history — exactly as a tick would —
        so ``trace_snapshot``/``--profile-out`` keep working, federated
        or not. Returns ``None`` when nothing new was observed (the
        controller skips this replica for the cycle)."""
        with self._lock:
            self.stats.pulls += 1
            window = self.tiered.rotate_trace()
            if window is not None and window.batches:
                self._accumulate_unpulled(window)
                self._merged = (
                    window if self._merged is None
                    else self._merged.merge(window, decay=self.decay)
                )
            out, self._unpulled = self._unpulled, None
            return out

    def apply_plan(
        self,
        new_plan,
        *,
        trace: Optional[AccessTrace] = None,
        sync_preload: bool = False,
    ) -> dict:
        """Apply a plan replanned ELSEWHERE (a ``FleetController``) under
        the same safety rules as a local tick.

        Unlike ``tick()`` this RAISES on a tier-0 superset violation —
        strictly before any mutation — so the controller can quarantine a
        bad plan/replica without this replica's loader ever changing
        state. ``trace`` (the federated history) refreshes the predictor
        in place of the local history; ``sync_preload=True`` forces
        promotions through a synchronous between-batches preload even
        when a prefetcher is attached — the warm-bootstrap path, where
        the replica must be resident BEFORE admitting traffic."""
        with self._lock:
            n_promote, n_demote = self._apply(
                new_plan, sync_preload=sync_preload, refresh_from=trace
            )
            self.stats.remote_applies += 1
            return {"promoted": n_promote, "demoted": n_demote}

    def _apply(
        self, new_plan, *, sync_preload: bool = False, refresh_from=None
    ) -> tuple[int, int]:
        """Apply a replanned hot set to the running loader, in place."""
        # rule 1: re-prove the invariant on EVERY application
        check_tier0_superset(new_plan, self._required)
        self.stats.invariant_checks += 1

        tiered = self.tiered
        owned = tiered._all_units
        promote: list[str] = []
        demote: list[str] = []
        for path, nd in new_plan.decisions.items():
            od = tiered.plan.decisions.get(path)
            if od is None or od.tier != 1 or nd.tier != 1:
                continue  # tier flips are compaction-only (rule 2)
            old_res, new_res = set(od.resident_units), set(nd.resident_units)
            # replan orders promotions hottest-first; preserve that order
            promote.extend(
                k for k in nd.resident_units if k not in old_res and k in owned
            )
            demote.extend(
                k for k in od.resident_units if k not in new_res and k in owned
            )

        # demote FIRST: freed budget makes room for the incoming preloads
        if demote:
            evictions0 = tiered.stats.evictions
            freed = tiered.evict(demote)  # skips pinned/LOADING/cold
            self.stats.demoted_units += len(demote)
            self.stats.evicted_units += tiered.stats.evictions - evictions0
            self.stats.evicted_bytes += freed
        budget = tiered.residency.budget_bytes
        sync_path = sync_preload or self.prefetcher is None
        if promote and budget and sync_path:
            # budget-fit trim for the SYNCHRONOUS preload path only:
            # preloading past the budget would LRU-churn out the very units
            # just loaded (the replan ranks promotions but can't know this
            # replica's budget — under federation the controller doesn't
            # either). Rank globally hottest-first by trace heat
            # (the per-decision diff above concatenates paths in plan
            # order), keep the prefix that fits the post-demotion headroom;
            # the tail stays demand-faultable. Async hints need neither the
            # sort nor the trim: the queue is loaded in order under LRU, so
            # what persists is its suffix, and interleaved demand faults
            # keep re-claiming what the workload actually needs.
            heat_src = refresh_from if refresh_from is not None else self._merged
            if heat_src is not None:
                heat = {
                    k: heat_src.touches.get(k, 0) + heat_src.faults.get(k, 0)
                    for k in promote
                }
                promote.sort(key=lambda k: -heat[k])  # stable: ties keep plan order
            resident = tiered.resident_keys
            headroom = budget - tiered.resident_bytes
            kept = []
            for k in promote:
                if k in resident:
                    kept.append(k)
                    continue
                nb = tiered.unit_charge(k)
                if nb <= headroom:
                    headroom -= nb
                    kept.append(k)
            promote = kept
        if promote:
            self.stats.promoted_units += len(promote)
            if self.prefetcher is not None and not sync_preload:
                # promotions ride the prefetch queue: claimed COLD→LOADING,
                # loaded off the serving thread, hit-accounted like any hint
                self.prefetcher.hint(promote)
            else:
                # no prefetcher (strict deployments) or a warm bootstrap:
                # preload synchronously HERE, between batches — bytes move,
                # but never inside a step and never on a request's fault path
                self.stats.preload_bytes += tiered.ensure(promote, source="preload")

        tiered.plan = new_plan
        self.stats.applies += 1

        src = refresh_from if refresh_from is not None else self._merged
        if self.refresh_predictor and self.prefetcher is not None and src is not None:
            # per-request transitions are coincidence-free; fall
            # back to batch transitions when no scheduler attribution exists
            if src.request_transitions or src.transitions:
                self.prefetcher.predictor = TransitionPredictor.from_trace(
                    src, top_k=self.predictor_top_k, prefer_request=True)
                self.stats.predictor_refreshes += 1

        if self.compact_every and self.stats.applies % self.compact_every == 0:
            self._compact_async()
        return len(promote), len(demote)

    # -- background compaction ---------------------------------
    def _compact_async(self) -> bool:
        """Kick one artifact rewrite on a worker thread. Serve-path guard:
        at most one in flight — a cadence hit while one runs is counted
        and dropped, never queued (the next cadence hit retries with a
        fresher plan anyway). The tick returns immediately; failures land
        in ``stats.compact_errors``/``last_compact_error`` exactly as tick
        failures land in ``stats.errors``. Called under ``self._lock``."""
        with self._compact_lock:
            if self._compact_thread is not None and self._compact_thread.is_alive():
                self.stats.compact_skipped_inflight += 1
                return False
            # snapshot plan/report/trace NOW, under the tick lock — the live
            # plan may change while the worker writes, and the rewrite must
            # be a consistent point-in-time artifact
            plan, rep, trace = self.tiered.plan, self.last_report, self._merged
            t = threading.Thread(
                target=self._compact_bg, args=(plan, rep, trace),
                name="retier-compact", daemon=True,
            )
            self._compact_thread = t
            t.start()
            return True

    def _compact_bg(self, plan, report, trace) -> None:
        t0 = time.monotonic()
        try:
            out = self.compact_out_dir or self.artifact_dir.rstrip("/") + "-compact"
            meta = retier_artifact(
                self.artifact_dir, plan, out_dir=out, report=report, trace=trace
            )
            with self._compact_lock:
                self.stats.compactions += 1
                self.last_compaction = meta
        except Exception as e:  # absorbed: compaction is bookkeeping
            with self._compact_lock:
                self.stats.compact_errors += 1
                self.last_compact_error = repr(e)
        finally:
            with self._compact_lock:
                self.stats.compact_wall_s += time.monotonic() - t0

    def join_compaction(self, timeout: Optional[float] = None) -> bool:
        """Wait for an in-flight background compaction (shutdown flushes,
        tests, benchmarks). Returns True when none is running afterwards."""
        with self._compact_lock:
            t = self._compact_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def compact(self) -> dict:
        """Rewrite the artifact from the CURRENT live plan so the next cold
        start boots the adapted hot set, synchronously (tests, shutdown
        flushes — the periodic cadence uses ``_compact_async`` instead).
        Out-of-place + rename-committed (``retier_artifact``); the running
        server never re-reads it."""
        if not self.artifact_dir:
            raise ValueError("no artifact_dir configured for compaction")
        out = self.compact_out_dir or self.artifact_dir.rstrip("/") + "-compact"
        t0 = time.monotonic()
        meta = retier_artifact(
            self.artifact_dir, self.tiered.plan, out_dir=out,
            report=self.last_report, trace=self._merged,
        )
        with self._compact_lock:
            self.stats.compactions += 1
            self.stats.compact_wall_s += time.monotonic() - t0
            self.last_compaction = meta
        return meta

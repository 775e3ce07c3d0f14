"""⑨ Fleet federation: traces pooled across replicas and a learned pre-warm
(``repro.core.fleet`` counterpart).

A ``RetierDaemon`` adapts ONE replica from its own traffic, so N replicas
behind a load balancer each pay the whole exploration cost of a shift in
the workload: every replica faults on the new hot set before its own daemon
learns it. The ``FleetController`` pools what the replicas observe:

    replica daemons ──pull_window()──▶ the windows of ONE sync cycle
        ──AccessTrace.merge_all (plain sum, commutative)──▶ combined
        ──history.merge(combined, decay)──▶ fleet history
        ──replan ONCE from the base plan──▶ fleet plan
        ──residency_overlay──▶ {tier-1 path: hot unit keys}
        ──apply_overlay + RetierDaemon.apply_plan──▶ every replica

so a shift that ANY replica sees pre-warms ALL of them, and each replica's
own safety rules still hold: each re-proves the tier-0 ⊇ entry-reachable
invariant itself before it changes anything (the controller is not
trusted), promotions ride the prefetcher or a synchronous preload between
requests, demotions respect pins.

The contract, as the reference's:

  * **order-independent**: the windows of one cycle are combined by an
    undecayed, commutative sum (``AccessTrace.merge_all``) BEFORE the one
    decayed fold into the history, so the fleet plan cannot depend on the
    order the replicas are polled in;
  * **overlay, not plan**: what crosses the replica boundary is the
    residency overlay (plain ``{path: [unit key, ...]}``), applied to each
    replica's OWN plan through ``apply_overlay``: no tier flips remotely,
    unit keys a replica does not own are ignored, and the state serializes;
  * **failure-isolated**: a replica whose pull fails or whose push is
    refused (an invariant violation, an I/O error) is recorded and skipped;
    the cycle completes for every other replica, and the failing replica's
    loader is untouched (``apply_plan`` checks before it changes anything);
  * **warm bootstrap**: ``snapshot()`` captures the history and the overlay
    as JSON; a late joiner registered against it applies the fleet plan
    with a SYNCHRONOUS preload inside ``register()``, resident before it
    admits traffic instead of faulting its way to the fleet's hot set.

Locks and threads. The order is the fleet's lock, then a daemon's lock
(``apply_plan`` / ``pull_window``), then the host arbiter's lock, then a
tenant's ``TieredParams.gate``, then its residency lock: the same order a
daemon's tick takes from its own lock down. ``sync()`` and ``register()``
run between requests, never inside a step: a push evicts and installs under
``gate``, which a forward run holds. Under the scheduler they are called
from the thread that owns the serving loop, as the daemons' ticks are. On
the card a push installs in place into the tensors the captured graphs
read, so nothing is captured again.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from repro_torch.core import snapshot as server_snapshot_mod
from repro_torch.core.on_demand import AccessTrace
from repro_torch.core.retier import apply_overlay, replan_from_trace, residency_overlay


@dataclass
class FleetStats:
    """The controller's lifetime accounting (printed by the launcher,
    asserted by the tests and chip_smoke)."""

    syncs: int = 0              # sync() cycles run
    pulls: int = 0              # per-replica window pulls attempted
    pull_failures: int = 0      # pulls that raised (replica skipped)
    empty_windows: int = 0      # pulls that returned no new batches
    replans: int = 0            # cycles that produced a fresh fleet plan
    pushes: int = 0             # per-replica plan applications that held
    push_failures: int = 0      # refused or failed applications (isolated)
    bootstraps: int = 0         # late joiners warm-started at register()
    bootstrap_failures: int = 0

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class FleetController:
    """Federates N ``RetierDaemon``s into one learned hot set.

    Passive, as the daemons it drives: it owns no thread, and ``sync()`` is
    called from whatever loop coordinates the replicas (the ``--fleet``
    launcher, a test). Its state is behind one lock; every change to a
    replica goes through ``RetierDaemon.apply_plan``, which takes the
    daemon's lock and re-proves the tier-0 invariant before touching the
    loader.

    The fleet's state is small and portable: the decayed fleet history (an
    ``AccessTrace``) and the last residency overlay. ``snapshot()`` /
    ``restore()`` round-trip exactly that, byte for byte.
    """

    SNAPSHOT_VERSION = 1

    def __init__(self, *, decay: float = 0.5, promote_min_faults: int = 1,
                 max_promote_bytes: Optional[int] = None, sync_preload: bool = False):
        if not 0.0 <= decay <= 1.0:
            raise ValueError(f"decay must be in [0, 1], got {decay!r}")
        self.decay = decay
        self.promote_min_faults = promote_min_faults
        self.max_promote_bytes = max_promote_bytes
        # sync_preload=True loads every push's promotions synchronously
        # inside sync(), between requests, instead of queueing prefetch
        # hints: residency is settled after each cycle, at the cost of sync()
        # waiting on tier-1 reads
        self.sync_preload = sync_preload
        self.stats = FleetStats()
        self._lock = threading.Lock()
        self._replicas: dict[str, object] = {}  # name -> RetierDaemon
        self._history: Optional[AccessTrace] = None
        self._overlay: Optional[dict[str, list[str]]] = None
        # every replan starts from the FIRST registered replica's plan and
        # static analysis, with the controller's own last overlay as the
        # resident set (see ``sync``), never from a replica's drifting plan
        self._base_plan = None
        self._reach = None
        self._min_budget: Optional[int] = None  # the tightest replica budget seen
        # a warmed replica's server snapshot, restored onto late joiners at
        # register(): the bootstrap fast path that skips faulting the hot set
        self._server_snapshot: Optional[dict] = None
        self.last_errors: dict[str, str] = {}

    # -- membership --------------------------------------------------------------
    @property
    def replicas(self) -> list[str]:
        with self._lock:
            return sorted(self._replicas)

    def register(self, name: str, daemon, *, server_snapshot: Optional[dict] = None) -> bool:
        """Add a replica's daemon to the fleet. The first registration gives
        the base plan and the reachability the controller replans from.

        Two warm bootstraps run here, the fast one first: a server snapshot
        (passed in, or offered earlier by a warmed replica) replays a donor's
        resident set, LRU order and predictor onto the joiner; then, if the
        fleet has learned an overlay, the fleet plan is applied with a
        synchronous preload. Returns True when either left the replica warm.
        A bootstrap failure is absorbed (``stats`` / ``last_errors``): the
        replica still joins, cold, as if it were not federated."""
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            self._replicas[name] = daemon
            if self._base_plan is None:
                self._base_plan = daemon.tiered.plan
                self._reach = daemon.reach
            b = daemon.tiered.residency.budget_bytes
            if b and (self._min_budget is None or b < self._min_budget):
                # the fleet plans for its tightest replica: an overlay that
                # budget cannot hold would churn that replica's LRU
                self._min_budget = b
            warmed = False
            snap = server_snapshot if server_snapshot is not None else self._server_snapshot
            if snap is not None:
                try:
                    rep = server_snapshot_mod.restore(
                        daemon.tiered, snap, prefetcher=getattr(daemon, "prefetcher", None),
                        artifact_dir=getattr(daemon, "artifact_dir", None),
                        strict=False)  # another artifact: a cold join, not a crash
                    if rep["restored"]:
                        self.stats.bootstraps += 1
                        warmed = True
                except Exception as e:
                    self.stats.bootstrap_failures += 1
                    self.last_errors[name] = repr(e)
            if self._overlay is None:
                return warmed
            try:
                plan = apply_overlay(daemon.tiered.plan, self._overlay)
                daemon.apply_plan(plan, trace=self._history, sync_preload=True)
                self.stats.bootstraps += 1
                return True
            except Exception as e:  # a cold join is a degraded mode, not a crash
                self.stats.bootstrap_failures += 1
                self.last_errors[name] = repr(e)
                return warmed

    def offer_server_snapshot(self, snap: Optional[dict]) -> None:
        """Keep a warmed replica's server snapshot (``ColdStartServer.
        snapshot()``) for every later ``register()`` to restore from;
        ``None`` clears it. The version is checked here, so a bad document
        fails now and not inside some later join."""
        if snap is not None:
            version = snap.get("version")
            if version != server_snapshot_mod.SNAPSHOT_VERSION:
                raise ValueError(f"unsupported server snapshot version {version!r} "
                                 f"(expected {server_snapshot_mod.SNAPSHOT_VERSION})")
        with self._lock:
            self._server_snapshot = snap

    def unregister(self, name: str) -> None:
        """Drop a replica (drained or crashed). What it contributed stays in
        the decayed history."""
        with self._lock:
            self._replicas.pop(name, None)

    # -- one federation cycle ----------------------------------------------------
    def sync(self) -> dict:
        """Run one pull → merge → replan → push cycle; returns a summary.

        Never raises for one replica's trouble: a failing pull or push is
        recorded (``stats``, ``last_errors``, the summary's ``failed`` map)
        and the cycle goes on for the rest of the fleet."""
        with self._lock:
            self.stats.syncs += 1
            summary: dict = {
                "pulled": 0, "windows": 0, "replanned": False,
                "pushed": [], "bootstrapped": [], "failed": {},
                "promoted": 0, "demoted": 0,
            }
            if not self._replicas:
                return summary

            # 1. one window a replica, each failure isolated
            windows = []
            for name, daemon in self._replicas.items():
                self.stats.pulls += 1
                summary["pulled"] += 1
                try:
                    w = daemon.pull_window()
                except Exception as e:
                    self.stats.pull_failures += 1
                    self.last_errors[name] = repr(e)
                    summary["failed"][name] = f"pull: {e!r}"
                    continue
                if w is None:
                    self.stats.empty_windows += 1
                else:
                    windows.append(w)
            summary["windows"] = len(windows)

            # 2. a commutative combine, then ONE decayed fold
            if windows:
                combined = AccessTrace.merge_all(windows)
                self._history = (combined if self._history is None
                                 else self._history.merge(combined, decay=self.decay))

            # 3. replan ONCE against the fleet history, from the base plan
            # carrying the previous overlay. From the bare base plan, staying
            # resident would need ongoing faults, and a pre-warm exists to
            # stop them: warmed units would lose their decayed fault evidence,
            # drop out of the overlay, be demoted, fault, and be admitted again.
            # With the previous overlay as the resident set a fault admits a
            # unit and decayed touches keep it; it drops out once the fleet
            # stops touching it.
            if self._history is None or not self._history.batches:
                return summary
            replan_base = (self._base_plan if self._overlay is None
                           else apply_overlay(self._base_plan, self._overlay))
            new_plan, _report = replan_from_trace(
                replan_base, self._history, self._reach,
                promote_min_faults=self.promote_min_faults,
                max_promote_bytes=self.max_promote_bytes,
                promote_leaves=False)  # tier flips are local only
            self._overlay = self._trim_overlay(residency_overlay(new_plan), new_plan, self._history)
            self.stats.replans += 1
            summary["replanned"] = True

            # 4. push to every replica, as an overlay on ITS plan
            for name, daemon in self._replicas.items():
                try:
                    plan = apply_overlay(daemon.tiered.plan, self._overlay)
                    res = daemon.apply_plan(plan, trace=self._history, sync_preload=self.sync_preload)
                except Exception as e:
                    self.stats.push_failures += 1
                    self.last_errors[name] = repr(e)
                    summary["failed"][name] = f"push: {e!r}"
                    continue
                self.stats.pushes += 1
                summary["pushed"].append(name)
                summary["promoted"] += res["promoted"]
                summary["demoted"] += res["demoted"]
            return summary

    def _trim_overlay(self, overlay: dict[str, list[str]], plan, history: AccessTrace) -> dict[str, list[str]]:
        """Fit the overlay to the fleet's tightest replica budget, keeping the
        hottest units by pooled touch + fault heat, ties by key. The replan
        promotes all the history justifies; the budget is each replica's,
        which the replan cannot see, so the cap is applied here. Each path
        keeps the replan's order among its survivors. No budget registered:
        nothing to trim."""
        cap = self._min_budget
        if not cap:
            return overlay
        sizes = {u.key: u.nbytes for dec in plan.decisions.values() if dec.tier == 1 for u in dec.units}

        def heat(k: str) -> float:
            return history.touches.get(k, 0) + history.faults.get(k, 0)

        ranked = sorted(((p, k) for p, ks in overlay.items() for k in ks), key=lambda pk: (-heat(pk[1]), pk[1]))
        kept: set[str] = set()
        total = 0
        for _, k in ranked:
            nb = sizes.get(k, 0)
            if total + nb <= cap:
                kept.add(k)
                total += nb
        return {p: [k for k in ks if k in kept] for p, ks in overlay.items()}

    # -- warm bootstrap ----------------------------------------------------------
    def snapshot(self) -> dict:
        """The fleet's learned state as a plain-JSON dict: the decayed history
        (canonical numbers, so it round-trips byte for byte) and the last
        pushed overlay. No plans, unit objects or replica handles: a
        controller in another process can ``restore`` it and warm replicas
        it has never met."""
        with self._lock:
            return {
                "version": self.SNAPSHOT_VERSION,
                "decay": self.decay,
                "promote_min_faults": self.promote_min_faults,
                "max_promote_bytes": self.max_promote_bytes,
                "sync_preload": self.sync_preload,
                "history": None if self._history is None else self._history.to_dict(),
                "overlay": None if self._overlay is None else {
                    p: list(ks) for p, ks in sorted(self._overlay.items())},
                # the server-snapshot fast path; absent in older documents
                "server_snapshot": self._server_snapshot,
            }

    @classmethod
    def restore(cls, snap: dict) -> "FleetController":
        """A controller rebuilt from ``snapshot()``'s output. Replicas are not
        restored: they ``register`` again, and any that joins while the
        restored overlay is set is warm-bootstrapped."""
        version = snap.get("version")
        if version != cls.SNAPSHOT_VERSION:
            raise ValueError(f"unsupported fleet snapshot version {version!r} (expected {cls.SNAPSHOT_VERSION})")
        fc = cls(decay=snap["decay"], promote_min_faults=snap["promote_min_faults"],
                 max_promote_bytes=snap["max_promote_bytes"], sync_preload=snap.get("sync_preload", False))
        if snap.get("history") is not None:
            fc._history = AccessTrace.from_dict(snap["history"])
        if snap.get("overlay") is not None:
            fc._overlay = {p: list(ks) for p, ks in snap["overlay"].items()}
        fc._server_snapshot = snap.get("server_snapshot")
        return fc

    # -- introspection -----------------------------------------------------------
    @property
    def history(self) -> Optional[AccessTrace]:
        """The decayed pooled history the last replan saw."""
        with self._lock:
            return self._history

    @property
    def overlay(self) -> Optional[dict[str, list[str]]]:
        """The last pushed residency overlay (a copy)."""
        with self._lock:
            if self._overlay is None:
                return None
            return {p: list(ks) for p, ks in self._overlay.items()}

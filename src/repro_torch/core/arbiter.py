"""⑧ Host-level residency arbiter: N models under one device budget
(``repro.core.arbiter`` counterpart).

Many functions packed on one host, each loading only what it needs: a
per-model budget knows nothing of its neighbours, so the ``HostArbiter``
owns ONE host-wide budget and N registered tenants, and every make-room
decision is made across all of them:

    register(name, tiered, share, floor)  ── the tenant joins the pool; its
        private budget is off (restored at unregister)
    make_room(requester, incoming)        ── called by a tenant's install
        path before it takes its gate; victims come from every tenant
    rebalance()                           ── called after pin releases and
        by the re-tiering daemon; reclaims a transient overshoot

Victims are every tenant's RESIDENT, unpinned units (LOADING and pinned
keys of every tenant are excluded: selection goes through each tenant's
locked ``eviction_candidates`` / ``evict``), coldest first by

    (heat(key) x normalized_share, -utilization, tenant, lru_stamp, key)

where ``heat`` is the decayed trace touch count (the live window plus the
daemon's merged history when one is attached) and ``utilization =
resident / share_bytes``. A tenant's ``floor_bytes`` is never crossed (the
floors must fit the budget; ``register`` checks). The ``RetierDaemon``
feeds each tick's refault and overshoot deltas back through
``observe_tick``; shares drift toward the pressure-proportional split,
bounded below and renormalized so their sum never changes.

Lock order: the arbiter's lock, then a tenant's ``gate``, then that
tenant's residency lock. Arbiter entry points are called with no tenant
lock held (``TieredParams`` calls ``make_room`` before taking its gate and
``rebalance`` after dropping it), and holding the arbiter lock across a
global eviction serializes concurrent make-room calls, which keeps the byte
bookkeeping exact.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.on_demand import AccessTrace, TieredParams

# decayed pressure below this is stale noise, not demand: zero it so the
# share split can relax back to the registration baseline
_RATE_FLOOR = 1e-2


@dataclass
class HostArbiterStats:
    """Lifetime accounting (printed by the launcher, asserted by tests and chip_smoke)."""

    registered: int = 0
    unregistered: int = 0
    rebalances: int = 0        # make_room/rebalance calls that had work to do
    evictions: int = 0         # victims the arbiter evicted (all tenants)
    evicted_bytes: int = 0
    cross_evictions: int = 0   # victim owner != requesting tenant
    overshoots: int = 0        # make-room calls that could not free enough
    floor_skips: int = 0       # candidates passed over to respect a floor
    share_updates: int = 0     # feedback-driven share retunings
    headroom_denials: int = 0  # speculative prefetch gates closed

    def to_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class Tenant:
    """One registered model instance under the host budget."""

    name: str
    tiered: TieredParams
    share: float               # relative budget weight (feedback-tunable)
    base_share: float          # the registration share; shares drift back
    floor_bytes: int           # arbiter eviction never crosses this
    saved_budget: Optional[int]  # tenant's private budget, restored at exit
    history: Optional[AccessTrace] = None  # daemon's decay-merged heat
    overshoots: int = 0        # make-room shortfalls charged to this tenant
    last_refaults: int = 0     # feedback deltas (observe_tick)
    last_overshoots: int = 0
    refault_rate: float = 0.0  # decayed per-tick rates
    overshoot_rate: float = 0.0


class HostArbiter:
    """One host-wide device-bytes budget shared by N ``TieredParams``.

    See the module docstring for the victim rule, share feedback, and the
    lock-ordering contract. All public methods are thread-safe and must
    be called with no tenant lock held.
    """

    def __init__(
        self,
        budget_bytes: int,
        *,
        feedback_gain: float = 0.2,
        feedback_decay: float = 0.5,
        min_share_frac: float = 0.05,
    ):
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be positive, got {budget_bytes}")
        if not 0.0 <= feedback_gain <= 1.0:
            raise ValueError(f"feedback_gain must be in [0, 1], got {feedback_gain!r}")
        if not 0.0 <= feedback_decay <= 1.0:
            raise ValueError(f"feedback_decay must be in [0, 1], got {feedback_decay!r}")
        self.budget_bytes = budget_bytes
        self.feedback_gain = feedback_gain
        self.feedback_decay = feedback_decay
        self.min_share_frac = min_share_frac
        self.stats = HostArbiterStats()
        self._lock = threading.RLock()
        self._tenants: dict[str, Tenant] = {}
        self._by_id: dict[int, Tenant] = {}  # id(tiered) -> Tenant

    # -- registry ---------------------------------------------------------------
    def register(
        self,
        name: str,
        tiered: TieredParams,
        *,
        share: float = 1.0,
        floor_bytes: int = 0,
    ) -> Tenant:
        """Adopt one ``TieredParams`` into the host pool.

        The tenant's private ``budget_bytes`` is disabled (its own
        ``_evict_to_fit``/``_evict_to_budget`` become no-ops) and every
        install/release on it routes through this arbiter instead — the
        ownership inversion. Restored by ``unregister``.
        """
        if share <= 0:
            raise ValueError(f"share must be positive, got {share!r}")
        if floor_bytes < 0:
            raise ValueError(f"floor_bytes must be >= 0, got {floor_bytes}")
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            if tiered.arbiter is not None:
                raise ValueError(
                    f"TieredParams already governed by an arbiter "
                    f"(tenant {tiered.tenant_name!r})"
                )
            floors = sum(t.floor_bytes for t in self._tenants.values()) + floor_bytes
            if floors > self.budget_bytes:
                raise ValueError(
                    f"per-tenant floors ({floors}B) exceed the host budget "
                    f"({self.budget_bytes}B) — floors must be jointly satisfiable"
                )
            tenant = Tenant(
                name=name,
                tiered=tiered,
                share=share,
                base_share=share,
                floor_bytes=floor_bytes,
                saved_budget=tiered.residency.budget_bytes,
            )
            self._tenants[name] = tenant
            self._by_id[id(tiered)] = tenant
            tiered.residency.budget_bytes = None  # host governance from here on
            tiered.arbiter = self
            tiered.tenant_name = name
            self.stats.registered += 1
            return tenant

    def unregister(self, name: str) -> None:
        """Detach a tenant: its private budget is restored and its bytes
        stop counting against the host. Resident units stay resident —
        the tenant's own ``_evict_to_budget`` reclaims any excess on its
        next release."""
        with self._lock:
            tenant = self._tenants.pop(name, None)
            if tenant is None:
                raise KeyError(f"unknown tenant {name!r}")
            self._by_id.pop(id(tenant.tiered), None)
            tenant.tiered.arbiter = None
            tenant.tiered.tenant_name = ""
            tenant.tiered.residency.budget_bytes = tenant.saved_budget
            self.stats.unregistered += 1

    @property
    def tenants(self) -> dict:
        with self._lock:
            return dict(self._tenants)

    def tenant_of(self, tiered: TieredParams) -> Optional[Tenant]:
        with self._lock:
            return self._by_id.get(id(tiered))

    # -- queries ----------------------------------------------------------------
    def total_resident_bytes(self) -> int:
        with self._lock:
            return sum(t.tiered.resident_bytes for t in self._tenants.values())

    def shares(self) -> dict:
        with self._lock:
            return {n: t.share for n, t in self._tenants.items()}

    def share_bytes(self, name: str) -> int:
        """A tenant's share-resolved slice of the host budget (informational
        — shares weight the victim rule; they are not hard partitions)."""
        with self._lock:
            return self._share_bytes(self._tenants[name])

    def _share_bytes(self, tenant: Tenant) -> int:
        total = sum(t.share for t in self._tenants.values())
        return int(self.budget_bytes * tenant.share / total) if total else 0

    # -- the cross-model make-room path ----------------------------------------
    def make_room(self, requester: Optional[TieredParams], incoming_nbytes: int) -> int:
        """Free host budget for ``incoming_nbytes`` about to land in
        ``requester`` (None = pure rebalance). MUST be called with no
        tenant lock held. Victims are chosen across every tenant by the
        victim rule; returns bytes actually freed. If pins + floors make
        the target unreachable the shortfall is recorded (host overshoot
        + the requesting tenant's feedback counter) and the install
        proceeds anyway — correctness over budget, as in the single-tenant
        state machine."""
        with self._lock:
            need = (
                sum(t.tiered.resident_bytes for t in self._tenants.values())
                + incoming_nbytes
                - self.budget_bytes
            )
            if need <= 0:
                return 0
            self.stats.rebalances += 1
            freed = self._evict_global(need, requester)
            if freed < need:
                self.stats.overshoots += 1
                if requester is not None:
                    t = self._by_id.get(id(requester))
                    if t is not None:
                        t.overshoots += 1
            return freed

    def rebalance(self) -> int:
        """Reclaim any transient overshoot (called after pin releases and
        by daemon ticks). Cheap when the host is already under budget."""
        return self.make_room(None, 0)

    def _evict_global(self, need: int, requester: Optional[TieredParams]) -> int:
        """One coldest-first pass over every tenant's evictable units.
        Caller holds the arbiter lock (and no tenant lock)."""
        total_share = sum(t.share for t in self._tenants.values()) or 1.0
        cands: list[tuple[tuple, Tenant, str, int]] = []
        floor_room: dict[str, int] = {}
        for t in self._tenants.values():
            share_b = max(1, self._share_bytes(t))
            resident = t.tiered.resident_bytes
            floor_room[t.name] = resident - t.floor_bytes
            utilization = resident / share_b
            heat = self._heat(t)
            norm_share = t.share / total_share
            for key, nbytes, stamp in t.tiered.eviction_candidates():
                score = (heat.get(key, 0) * norm_share, -utilization,
                         t.name, stamp, key)
                cands.append((score, t, key, nbytes))
        cands.sort(key=lambda c: c[0])

        freed = 0
        for _, t, key, nbytes in cands:
            if freed >= need:
                break
            if floor_room[t.name] - nbytes < 0:
                self.stats.floor_skips += 1
                continue
            got = t.tiered.evict([key])  # re-checks pinned/LOADING under t's lock
            if not got:
                continue  # raced: pinned or evicted since the snapshot
            floor_room[t.name] -= got
            freed += got
            self.stats.evictions += 1
            self.stats.evicted_bytes += got
            if requester is not None and t.tiered is not requester:
                self.stats.cross_evictions += 1
        return freed

    def _heat(self, tenant: Tenant) -> dict:
        """Decayed trace-derived touch counts: the daemon's decay-merged
        history (when attached via ``note_trace``) plus the live window."""
        heat: dict = {}
        if tenant.history is not None:
            heat.update(tenant.history.touches)
        snap = tenant.tiered.trace_snapshot()  # locked copy; None if tracing off
        if snap is not None:
            for k, v in snap.touches.items():
                heat[k] = heat.get(k, 0) + v
        return heat

    # -- daemon feedback ----------------------------------------------------------
    def note_trace(self, tiered: TieredParams, merged: Optional[AccessTrace]) -> None:
        """Hand the arbiter a tenant's decay-merged trace history — the
        daemon calls this each tick so victim selection sees decayed heat
        even after the live window was rotated away."""
        with self._lock:
            t = self._by_id.get(id(tiered))
            if t is not None:
                t.history = merged

    def observe_tick(self, tiered: TieredParams) -> None:
        """Fold one daemon tick's observed refault/overshoot deltas into
        the tenant's decayed pressure rates, then retune shares toward the
        pressure-proportional split (bounded below by ``min_share_frac``
        of the total, renormalized so the share sum never changes)."""
        with self._lock:
            t = self._by_id.get(id(tiered))
            if t is None:
                return
            refaults = t.tiered.stats.refaults
            d_refault = refaults - t.last_refaults
            t.last_refaults = refaults
            d_over = t.overshoots - t.last_overshoots
            t.last_overshoots = t.overshoots
            t.refault_rate = self.feedback_decay * t.refault_rate + d_refault
            t.overshoot_rate = self.feedback_decay * t.overshoot_rate + d_over
            # geometric decay never reaches zero on its own: floor stale
            # pressure so quiet tenants stop steering the split
            if t.refault_rate < _RATE_FLOOR:
                t.refault_rate = 0.0
            if t.overshoot_rate < _RATE_FLOOR:
                t.overshoot_rate = 0.0
            self._retune_shares()

    def _retune_shares(self) -> None:
        tenants = list(self._tenants.values())
        if len(tenants) < 2:
            return
        pressure = {t.name: t.refault_rate + t.overshoot_rate for t in tenants}
        total_p = sum(pressure.values())
        total_share = sum(t.share for t in tenants)
        gain = self.feedback_gain
        lo = self.min_share_frac * total_share
        if total_p <= 0:
            # at rest the split relaxes back to the registration shares
            if all(t.share == t.base_share for t in tenants):
                return
            for t in tenants:
                t.share = max(lo, (1.0 - gain) * t.share + gain * t.base_share)
        else:
            for t in tenants:
                target = (pressure[t.name] / total_p) * total_share
                t.share = max(lo, (1.0 - gain) * t.share + gain * target)
        scale = total_share / sum(t.share for t in tenants)
        for t in tenants:
            t.share *= scale
        self.stats.share_updates += 1

    # -- speculative-load gate ---------------------------------------------------
    def prefetch_headroom(self, tiered: TieredParams, nbytes: int = 0) -> bool:
        """Should a *speculative* load for this tenant proceed? True while
        the host has free budget, or while the tenant sits under its
        share-resolved slice (its installs then displace over-share
        co-tenants, which is the victim rule working as intended). False
        means a prefetch would force evictions purely to stage a guess —
        the ``Prefetcher`` drops the hint instead."""
        with self._lock:
            t = self._by_id.get(id(tiered))
            if t is None:
                return True
            total = sum(x.tiered.resident_bytes for x in self._tenants.values())
            if total + nbytes <= self.budget_bytes:
                return True
            ok = tiered.resident_bytes + nbytes <= self._share_bytes(t)
            if not ok:
                self.stats.headroom_denials += 1
            return ok

    # -- audit -------------------------------------------------------------------
    def audit(self) -> dict:
        """Cross-check every tenant's byte bookkeeping (charged bytes ==
        sum of per-key charges over the resident set) and report host
        totals. Raises AssertionError on any inconsistency — the property
        and stress tests call this after every settling point."""
        with self._lock:
            total = 0
            pinned = 0
            per_tenant = {}
            for t in self._tenants.values():
                tp = t.tiered
                with tp._lock:
                    res = tp.residency
                    charged = res.charged_bytes()
                    assert charged == res.resident_bytes, (
                        f"{t.name}: charged {charged} != accounted {res.resident_bytes}"
                    )
                    pb = sum(
                        res._nbytes.get(k, 0)
                        for k in res._lru
                        if res.pins_of(k) > 0
                    )
                total += charged
                pinned += pb
                per_tenant[t.name] = {
                    "resident_bytes": charged,
                    "pinned_bytes": pb,
                    "floor_bytes": t.floor_bytes,
                    "share": t.share,
                }
            return {
                "budget_bytes": self.budget_bytes,
                "resident_bytes": total,
                "pinned_bytes": pinned,
                "over_budget": max(0, total - self.budget_bytes),
                "tenants": per_tenant,
            }

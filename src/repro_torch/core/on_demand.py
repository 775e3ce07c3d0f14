"""④ On-demand loading — the ``rewrite_template`` analogue
(``repro.core.on_demand`` counterpart, without prefetch hooks or a host
arbiter).

Tier-1 leaves start as zero-filled device tensors of full shape (the
"rewritten stub": identical shapes, so every step runs the same code as the
fully loaded model); ``TieredParams.ensure`` faults real bytes in unit by
unit when a request needs them. A misprediction is a latency event, never a
failure.

Residency is a per-unit state machine (``ResidencyManager``)::

    COLD ──ensure()──▶ LOADING ──install──▶ RESIDENT
      ▲                                        │
      └────────── evict (LRU, unpinned) ◀──────┘

under a device-bytes budget. The reference rebuilds a whole leaf per install
(``.at[].set``); the port writes in place — ``leaf[sel].copy_(host)`` to
fault in and ``leaf[sel].zero_()`` to evict — so a fault never holds a
second copy of a multi-GB expert table. The unit order, the ``LoadEvent``
key/byte sequence and the budget arithmetic are the reference's.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, Optional

import torch

from repro_torch.core.optional_store import OptionalStore
from repro_torch.core.partition import TierPlan, Unit
from repro_torch.utils.tree import flatten_with_paths

COLD = "cold"          # placeholder zeros on device; bytes not charged
LOADING = "loading"    # a read/decode/upload is in flight; never evictable
RESIDENT = "resident"  # real bytes on device; charged against the budget

# frames read per vectored pass; decoded concurrently (zlib releases the
# GIL), installed in offset order
CHUNK = 32
DECODE_WORKERS = max(1, min(8, os.cpu_count() or 1))


@dataclass
class LoadEvent:
    key: str
    nbytes: int
    fetch_s: float
    upload_s: float
    t: float = 0.0          # monotonic completion time
    source: str = "fault"   # "fault" | "preload"
    phase: str = ""         # request phase at load time ("prefill" | "decode" | "")


class AccessTrace:
    """Demand-access telemetry: per-unit touches and faults, per-phase fault
    counts, co-access pairs and batch→batch transitions of every request-path
    ``ensure`` batch (the first-order tables of the reference's schema;
    serialized in its sorted JSON form)."""

    VERSION = 3

    def __init__(self, *, max_assoc_batch: int = 64):
        self.max_assoc_batch = max_assoc_batch
        self.batches = 0
        self.touches: dict[str, int] = {}
        self.faults: dict[str, int] = {}
        self.phases: dict[str, dict[str, int]] = {}
        self.pairs: dict[tuple, int] = {}  # (a, b) with a < b
        self.transitions: dict[str, dict[str, int]] = {}
        self._last_batch: list[str] = []

    def record(self, keys: Iterable[str], cold: Iterable[str], phase: str = "") -> None:
        """Record one demand batch (caller holds the loader's lock)."""
        keys, cold = list(keys), list(cold)
        if not keys:
            return
        self.batches += 1
        for k in keys:
            self.touches[k] = self.touches.get(k, 0) + 1
        for k in cold:
            self.faults[k] = self.faults.get(k, 0) + 1
            by_phase = self.phases.setdefault(k, {})
            by_phase[phase] = by_phase.get(phase, 0) + 1
        if len(keys) > self.max_assoc_batch:
            self._last_batch = []
            return
        for i, a in enumerate(keys):
            for b in keys[i + 1:]:
                if a != b:
                    pair = (a, b) if a < b else (b, a)
                    self.pairs[pair] = self.pairs.get(pair, 0) + 1
        cur = set(keys)
        for a in self._last_batch:
            succ = [b for b in cur if b != a]
            if succ:
                nxt = self.transitions.setdefault(a, {})
                for b in succ:
                    nxt[b] = nxt.get(b, 0) + 1
        self._last_batch = keys

    def to_dict(self) -> dict:
        return {
            "version": self.VERSION,
            "batches": self.batches,
            "touches": {k: self.touches[k] for k in sorted(self.touches)},
            "faults": {k: self.faults[k] for k in sorted(self.faults)},
            "phases": {k: {p: v[p] for p in sorted(v)} for k, v in sorted(self.phases.items())},
            "pairs": [[a, b, self.pairs[(a, b)]] for a, b in sorted(self.pairs)],
            "transitions": {
                k: {n: v[n] for n in sorted(v)} for k, v in sorted(self.transitions.items())
            },
        }


@dataclass
class LoaderStats:
    events: list = field(default_factory=list)
    misses: int = 0          # synchronous request-path loads
    hits: int = 0            # already-resident touches
    evictions: int = 0
    evicted_bytes: int = 0
    refaults: int = 0        # loads of a previously-evicted unit



class ResidencyManager:
    """Per-unit residency state machine + device-bytes budget accounting.

    All mutation happens under the owner's lock. LRU order is an
    ``OrderedDict`` over RESIDENT keys stamped by a logical clock (one tick
    per ensure batch); eviction walks oldest stamp first, ties by key,
    skipping pinned units.
    """

    def __init__(self, lock: threading.RLock, *, budget_bytes: Optional[int] = None):
        self._lock = lock
        self.budget_bytes = budget_bytes
        self._state: dict[str, str] = {}
        self._nbytes: dict[str, int] = {}
        self._pins: dict[str, int] = {}
        self._clock = 0
        self._stamp: dict[str, int] = {}
        self._lru: OrderedDict[str, None] = OrderedDict()
        self._evicted_once: set[str] = set()
        self.resident_bytes = 0
        self.max_resident_bytes = 0  # high-water mark
        self.overshoot_events = 0    # installs that couldn't make room

    def state_of(self, key: str) -> str:
        return self._state.get(key, COLD)

    def is_resident(self, key: str) -> bool:
        return self._state.get(key) == RESIDENT

    @property
    def resident_keys(self) -> set:
        with self._lock:
            return set(self._lru)

    def advance_clock(self) -> int:
        self._clock += 1
        return self._clock

    # -- transitions (caller holds the lock) ----------------------------------
    def begin_load(self, key: str) -> bool:
        """COLD → LOADING; False if the key is not COLD."""
        if self._state.get(key, COLD) != COLD:
            return False
        self._state[key] = LOADING
        return True

    def commit_load(self, key: str, nbytes: int) -> None:
        """LOADING → RESIDENT: charge the budget, make the key MRU."""
        if self._state.get(key) != LOADING:
            raise RuntimeError(f"commit of {key!r} in state {self._state.get(key)}")
        self._state[key] = RESIDENT
        self._nbytes[key] = nbytes
        self._lru[key] = None
        self._lru.move_to_end(key)
        self._stamp[key] = self._clock
        self.resident_bytes += nbytes
        self.max_resident_bytes = max(self.max_resident_bytes, self.resident_bytes)

    def abort_load(self, key: str) -> None:
        """LOADING → COLD (the read or decode failed)."""
        if self._state.get(key) == LOADING:
            self._state[key] = COLD

    def touch(self, key: str) -> None:
        if key in self._lru:
            self._lru.move_to_end(key)
            self._stamp[key] = self._clock

    def pin(self, keys: Iterable[str]) -> None:
        for k in keys:
            self._pins[k] = self._pins.get(k, 0) + 1

    def release(self, keys: Iterable[str]) -> None:
        for k in keys:
            n = self._pins.get(k, 0) - 1
            if n <= 0:
                self._pins.pop(k, None)
            else:
                self._pins[k] = n

    def select_victims(self, need_bytes: int) -> list[str]:
        """Oldest-first unpinned RESIDENT keys freeing ≥ need_bytes (best effort)."""
        victims, freed = [], 0
        for k in sorted(self._lru, key=lambda k: (self._stamp.get(k, 0), k)):
            if freed >= need_bytes:
                break
            if self._pins.get(k, 0) > 0:
                continue
            victims.append(k)
            freed += self._nbytes.get(k, 0)
        return victims

    def evict_commit(self, key: str) -> int:
        """RESIDENT → COLD after the slice was zeroed; credits bytes."""
        if self._state.get(key) != RESIDENT or self._pins.get(key, 0):
            raise RuntimeError(f"evict of {key!r}: not an unpinned resident")
        nb = self._nbytes.pop(key, 0)
        self._state[key] = COLD
        self._lru.pop(key, None)
        self._stamp.pop(key, None)
        self._evicted_once.add(key)
        self.resident_bytes -= nb
        return nb

    def was_evicted(self, key: str) -> bool:
        return key in self._evicted_once


class TieredParams:
    """The live parameter tree of a cold-started server.

    tier-0 leaves hold real weights from cold start; tier-1 leaves are
    full-shape placeholder zeros filled in place per unit (experts: one
    ``(layer, expert)`` slice; rows: a row range; whole leaf). ``tree()``
    returns the same dict of tensors throughout — installs never replace a
    leaf. ``device_budget_bytes`` bounds the RESIDENT tier-1 bytes.
    """

    def __init__(self, tree: dict, plan: TierPlan, store: OptionalStore, *,
                 device_budget_bytes: Optional[int] = None):
        self._tree = tree
        self._flat = dict(flatten_with_paths(tree))
        self.plan = plan
        self.store = store
        self.stats = LoaderStats()
        self.trace: Optional[AccessTrace] = None
        self._phase = ""
        self._lock = threading.RLock()
        # one loader at a time (this slice has no prefetcher): a key is never
        # seen LOADING by a second ensure(), so nobody waits on another's read
        self._ensure_lock = threading.Lock()
        self.residency = ResidencyManager(self._lock, budget_bytes=device_budget_bytes)
        self._all_units: dict[str, Unit] = {
            u.key: u for d in plan.decisions.values() for u in d.units
        }

    # -- telemetry -------------------------------------------------------------
    def start_trace(self) -> AccessTrace:
        """Record every later request-path ``ensure`` batch into a new trace."""
        with self._lock:
            self.trace = AccessTrace()
            return self.trace

    def set_phase(self, phase: str) -> None:
        """Tag subsequent loads/trace batches ("prefill" | "decode" | "")."""
        self._phase = phase

    # -- residency ----------------------------------------------------------
    def is_resident(self, key: str) -> bool:
        return self.residency.is_resident(key)

    @property
    def resident_keys(self) -> set:
        return self.residency.resident_keys

    def resident_fraction(self) -> float:
        n = len(self._all_units)
        return len(self.residency.resident_keys) / n if n else 1.0

    # -- the rewrite_template analogue ---------------------------------------
    def ensure(self, keys: Iterable[str], *, pin: bool = False, source: str = "fault") -> int:
        """Fault in the given unit keys; returns bytes moved (0 = warm hit).
        With ``pin=True`` the keys stay unevictable until ``release()``.
        Thread-safe: concurrent calls are serialized."""
        with self._ensure_lock:
            return self._ensure(list(dict.fromkeys(keys)), pin, source)

    def _ensure(self, keys: list[str], pin: bool, source: str) -> int:
        res = self.residency
        to_load: list[str] = []
        cold: list[str] = []
        with self._lock:
            res.advance_clock()  # one stamp per ensure batch
            for k in keys:
                if res.state_of(k) == RESIDENT:
                    res.touch(k)
                    self.stats.hits += 1
                else:
                    cold.append(k)
                    if res.begin_load(k):
                        to_load.append(k)
            if pin:
                res.pin(keys)
            if self.trace is not None and source == "fault":
                self.trace.record(keys, cold, self._phase)
        if not to_load:
            return 0

        moved = 0
        ordered = sorted(to_load, key=lambda k: self.store.entries[k].offset)
        for base in range(0, len(ordered), CHUNK):
            chunk = ordered[base:base + CHUNK]
            try:
                moved += self._load_chunk(chunk, source)
            except Exception:
                with self._lock:
                    # roll back every claim not yet installed, or it would
                    # sit in LOADING with no loader forever
                    for k in ordered[base:]:
                        res.abort_load(k)
                raise
        return moved

    def _load_chunk(self, chunk: list[str], source: str) -> int:
        """Read one chunk's frames (one vectored pass), decode them
        concurrently, then evict-to-fit and install each in offset order."""
        res = self.residency
        tr0 = time.perf_counter()
        bufs = self.store.read_raw_many(chunk)
        t_read = time.perf_counter() - tr0
        decoded = self._decode_all(chunk, bufs)
        total_csize = sum(self.store.entries[k].csize for k in chunk) or 1
        moved = 0
        for key in chunk:
            host, decode_s = decoded.pop(key)
            # the chunk's read wall is split csize-proportionally
            fetch_s = decode_s + t_read * self.store.entries[key].csize / total_csize
            nbytes = host.numel() * host.element_size()
            with self._lock:
                t1 = time.perf_counter()
                self._evict_to_fit(nbytes)
                self._install(self._all_units[key], host)
                t2 = time.perf_counter()
                res.commit_load(key, nbytes)
                if res.was_evicted(key):
                    self.stats.refaults += 1
                if source == "fault":
                    self.stats.misses += 1
                self.stats.events.append(LoadEvent(
                    key, nbytes, fetch_s, t2 - t1, t=time.monotonic(),
                    source=source, phase=self._phase))
            moved += nbytes
        return moved

    def _decode_all(self, chunk: list[str], bufs: dict[str, bytes]) -> dict:
        """key -> (host tensor, decode seconds), decoded concurrently."""

        def one(key: str):
            t0 = time.perf_counter()
            t = self.store.decode(key, bufs[key])
            return t, time.perf_counter() - t0

        if len(chunk) == 1 or DECODE_WORKERS == 1:
            return {k: one(k) for k in chunk}
        with ThreadPoolExecutor(min(DECODE_WORKERS, len(chunk))) as ex:
            return dict(zip(chunk, ex.map(one, chunk)))

    def release(self, keys: Iterable[str]) -> None:
        """Unpin keys pinned by ``ensure(pin=True)``; over-budget residency
        left by pinned installs is reclaimed here (LRU first)."""
        with self._lock:
            self.residency.release(keys)
            self._evict_to_budget()

    def _evict_to_budget(self) -> None:
        res = self.residency
        if res.budget_bytes is None:
            return
        need = res.resident_bytes - res.budget_bytes
        if need > 0:
            for k in res.select_victims(need):
                self._evict_one(k)

    def _evict_to_fit(self, incoming_nbytes: int) -> None:
        """Evict LRU unpinned units until the incoming bytes fit the budget.
        If nothing is evictable the install proceeds and is counted as an
        overshoot (correctness over budget)."""
        res = self.residency
        budget = res.budget_bytes
        if budget is None:
            return
        need = res.resident_bytes + incoming_nbytes - budget
        if need <= 0:
            return
        for k in res.select_victims(need):
            self._evict_one(k)
        if res.resident_bytes + incoming_nbytes > budget:
            res.overshoot_events += 1

    def _evict_one(self, key: str) -> int:
        self._unit_view(self._all_units[key]).zero_()
        nb = self.residency.evict_commit(key)
        self.stats.evictions += 1
        self.stats.evicted_bytes += nb
        return nb

    # -- installation (in place) ----------------------------------------------
    def _unit_view(self, unit: Unit) -> torch.Tensor:
        view = self._flat[unit.path]
        for i in unit.sel:
            view = view[i]
        if unit.rows is not None:
            view = view[unit.rows[0]:unit.rows[1]]
        return view

    def _install(self, unit: Unit, host: torch.Tensor) -> None:
        view = self._unit_view(unit)
        if view.shape != host.shape:
            raise ValueError(f"unit {unit.key!r}: stored shape {tuple(host.shape)} "
                             f"!= leaf slice {tuple(view.shape)}")
        view.copy_(host)

    # -- access ----------------------------------------------------------------
    def tree(self) -> dict:
        return self._tree

    def leaf(self, path: str) -> torch.Tensor:
        return self._flat[path]

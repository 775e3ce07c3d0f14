"""④ On-demand loading — the ``rewrite_template`` analogue
(``repro.core.on_demand`` counterpart).

Tier-1 leaves start as zero-filled device tensors of full shape (the
"rewritten stub": identical shapes, so every step runs the same code as the
fully loaded model); ``TieredParams.ensure`` faults real bytes in unit by
unit when a request needs them. A misprediction is a latency event, never a
failure.

Residency is a per-unit state machine (``ResidencyManager``)::

    COLD ──ensure()/prefetch──▶ LOADING ──install──▶ RESIDENT
      ▲                                                 │
      └───────────── evict (LRU, unpinned) ◀────────────┘

under a device-bytes budget. A demand ``ensure`` that finds a key LOADING
under another loader (the prefetcher, ``core/prefetch.py``) waits for it
instead of reading it twice, and takes the load over if that loader aborts.

The reference rebuilds a whole leaf per install (``.at[].set``), so a step
holds an immutable snapshot of the tree; the port writes in place —
``leaf[sel].copy_(host)`` to fault in and ``leaf[sel].zero_()`` to evict — so
a fault never holds a second copy of a multi-GB expert table. In place, an
install or eviction from the prefetcher's thread would tear a forward run in
flight (some layers reading zeros, others real bytes), and a commit between
a run and its miss check would make a run computed on placeholder zeros look
complete. ``TieredParams.gate`` closes both: every write to the live tree
takes it, and the engine holds it for each forward run from launch until the
run's outputs are on the device and its misses are read. The gate is never
held while waiting on a LOADING key (the loader that must finish it needs
the gate), and it is always taken before the residency lock.

Under a host arbiter (``core/arbiter.py``) the lock order is: the arbiter's
lock, then a tenant's ``gate``, then that tenant's residency lock. The
arbiter's victim pass evicts other tenants' units through ``evict``, which
takes their gate, so nothing enters the arbiter (``make_room``,
``rebalance``, ``prefetch_headroom``, ``note_trace``, ``observe_tick``)
while it holds any tenant's gate or residency lock: an install calls
``make_room`` before it takes ``gate``, ``release`` calls ``rebalance``
after it has dropped both, and the prefetcher's threads follow the same
rule.

The unit order, the ``LoadEvent`` key/byte sequence and the budget
arithmetic are the reference's.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

import torch
import torch.distributed as dist

from repro_torch.core.optional_store import OptionalStore, ReadStats
from repro_torch.core.partition import TierPlan, Unit
from repro_torch.sharding.rules import is_dtensor, local_box
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
    source: str = "fault"   # "fault" | "prefetch" | "preload"
    phase: str = ""         # request phase at load time ("prefill" | "decode" | "")


class AccessTrace:
    """Demand-access telemetry: schema v3 of ``repro.core.on_demand.AccessTrace``,
    recorded and serialized as the reference does, so the same accesses give
    the same JSON and a trace saved by either package loads in the other.

    Per request-path ``ensure`` batch (``record``): per-unit ``touches`` and
    ``faults``, per-phase fault counts (``phases``), co-access ``pairs`` and
    batch→next-batch ``transitions``; the same transitions split by the
    current batch's phase (``phase_transitions``), and second-order ones
    (``transitions2[(a2, a1)][b]``: ``a2`` from two batches back, ``a1`` from
    the last). Pairs and transitions skip batches over ``max_assoc_batch``
    keys, the second-order table batches over ``max_order2_batch``, and no
    empty successor dict is left behind. The scheduler attributes each
    request's own accesses (``record_request``) into ``request_pairs`` and
    ``request_transitions``.

    A trace is one observation window: ``merge(newer, decay=)`` folds a newer
    window onto a decayed copy of this one, ``merge_all`` sums same-tick
    windows in any order. v1 and v2 documents still load; merging across
    versions raises."""

    VERSION = 3

    def __init__(self, *, max_assoc_batch: int = 64, max_order2_batch: int = 8):
        self.version = self.VERSION
        self.max_assoc_batch = max_assoc_batch
        self.max_order2_batch = max_order2_batch
        self.batches = 0
        self.touches: dict[str, int] = {}
        self.faults: dict[str, int] = {}
        self.phases: dict[str, dict[str, int]] = {}
        self.pairs: dict[tuple, int] = {}  # (a, b) with a < b
        self.transitions: dict[str, dict[str, int]] = {}
        self.request_pairs: dict[tuple, int] = {}  # same-request co-access
        self.request_transitions: dict[str, dict[str, int]] = {}
        self.phase_transitions: dict[str, dict[str, dict[str, int]]] = {}
        self.transitions2: dict[tuple, dict[str, int]] = {}  # (a2, a1) -> {b: n}
        self._last_batch: list[str] = []
        self._last2_batch: list[str] = []  # the batch before _last_batch
        self._last_by_request: dict[int, list[str]] = {}

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
            self._last_batch, self._last2_batch = [], []
            return
        for i, a in enumerate(keys):
            for b in keys[i + 1:]:
                if a != b:
                    pair = (a, b) if a < b else (b, a)
                    self.pairs[pair] = self.pairs.get(pair, 0) + 1
        cur = set(keys)
        by_phase = self.phase_transitions.setdefault(phase, {})
        for a in self._last_batch:
            succ = [b for b in cur if b != a]
            if succ:
                nxt = self.transitions.setdefault(a, {})
                pnxt = by_phase.setdefault(a, {})
                for b in succ:
                    nxt[b] = nxt.get(b, 0) + 1
                    pnxt[b] = pnxt.get(b, 0) + 1
        if not by_phase:
            del self.phase_transitions[phase]
        cap2 = self.max_order2_batch
        if len(keys) <= cap2 and 0 < len(self._last_batch) <= cap2 and 0 < len(self._last2_batch) <= cap2:
            for a2 in self._last2_batch:
                for a1 in self._last_batch:
                    succ = [b for b in cur if b != a1 and b != a2]
                    if succ:
                        nxt2 = self.transitions2.setdefault((a2, a1), {})
                        for b in succ:
                            nxt2[b] = nxt2.get(b, 0) + 1
        self._last2_batch, self._last_batch = self._last_batch, keys

    def record_request(self, rid: int, keys: Iterable[str]) -> None:
        """Record the units ONE request accessed this step. Unlike ``record``
        (the scheduler's unioned batch), these pairs and step→step
        transitions are same-request by construction. Caller holds the
        loader's lock."""
        keys = list(dict.fromkeys(keys))
        if not keys or len(keys) > self.max_assoc_batch:
            self._last_by_request.pop(rid, None)
            return
        for i, a in enumerate(keys):
            for b in keys[i + 1:]:
                pair = (a, b) if a < b else (b, a)
                self.request_pairs[pair] = self.request_pairs.get(pair, 0) + 1
        cur = set(keys)
        for a in self._last_by_request.get(rid, ()):
            succ = [b for b in cur if b != a]
            if succ:
                nxt = self.request_transitions.setdefault(a, {})
                for b in succ:
                    nxt[b] = nxt.get(b, 0) + 1
        self._last_by_request[rid] = keys

    def end_request(self, rid: int) -> None:
        """Drop one request's chain state, so its last step never links to
        the next request that reuses the slot."""
        self._last_by_request.pop(rid, None)

    # -- window merging ----------------------------------------------------------
    def merge(self, newer: "AccessTrace", *, decay: float = 1.0, prune_below: float = 0.5) -> "AccessTrace":
        """A NEW trace: every count here scaled by ``decay`` (0 ≤ decay ≤ 1),
        plus the newer window's; entries below ``prune_below`` dropped.
        Integral results store as ints, so a ``decay=1`` merge of int windows
        round-trips byte-identically. Neither input is mutated, and the result
        carries no chain state. Raises on a schema-version mismatch and on
        ``newer is self``."""
        if newer is self:
            raise ValueError("cannot merge an AccessTrace into itself (aliasing); "
                             "merge a rotated window or a snapshot copy instead")
        if not 0.0 <= decay <= 1.0:
            raise ValueError(f"decay must be in [0, 1], got {decay!r}")
        if self.version != newer.version:
            raise ValueError(f"cannot merge AccessTrace schema v{self.version} with v{newer.version}")

        def norm(v):
            return int(v) if isinstance(v, float) and v.is_integer() else v

        def counts(old: dict, new: dict) -> dict:
            out: dict = {}
            for k, v in old.items():
                sv = v if decay == 1 else v * decay
                if sv >= prune_below:
                    out[k] = norm(sv)
            for k, v in new.items():
                out[k] = norm(out.get(k, 0) + v)
            return {k: v for k, v in out.items() if v >= prune_below}

        def nested(old: dict, new: dict) -> dict:
            sub = {k: counts(old.get(k, {}), new.get(k, {})) for k in set(old) | set(new)}
            return {k: v for k, v in sub.items() if v}

        merged = AccessTrace(max_assoc_batch=max(self.max_assoc_batch, newer.max_assoc_batch),
                             max_order2_batch=max(self.max_order2_batch, newer.max_order2_batch))
        merged.batches = norm((self.batches if decay == 1 else self.batches * decay) + newer.batches)
        merged.touches = counts(self.touches, newer.touches)
        merged.faults = counts(self.faults, newer.faults)
        merged.phases = nested(self.phases, newer.phases)
        merged.pairs = counts(self.pairs, newer.pairs)
        merged.transitions = nested(self.transitions, newer.transitions)
        merged.request_pairs = counts(self.request_pairs, newer.request_pairs)
        merged.request_transitions = nested(self.request_transitions, newer.request_transitions)
        merged.phase_transitions = {
            ph: sub for ph in set(self.phase_transitions) | set(newer.phase_transitions)
            if (sub := nested(self.phase_transitions.get(ph, {}), newer.phase_transitions.get(ph, {})))
        }
        merged.transitions2 = nested(self.transitions2, newer.transitions2)
        return merged

    @classmethod
    def merge_all(cls, windows, *, prune_below: float = 0.5) -> "AccessTrace":
        """The plain sum (``decay=1``) of a list of windows: commutative and
        associative, so the result does not depend on their order. No
        windows give an empty trace."""
        out = cls()
        for w in windows:
            out = out.merge(w, decay=1.0, prune_below=prune_below)
        return out

    # -- serialization (deterministic; the --profile-out format) -----------------
    def to_dict(self) -> dict:
        def table(t: dict) -> dict:
            return {k: {n: v[n] for n in sorted(v)} for k, v in sorted(t.items())}

        return {
            "version": self.version,
            "batches": self.batches,
            "touches": {k: self.touches[k] for k in sorted(self.touches)},
            "faults": {k: self.faults[k] for k in sorted(self.faults)},
            "phases": table(self.phases),
            "pairs": [[a, b, self.pairs[(a, b)]] for a, b in sorted(self.pairs)],
            "transitions": table(self.transitions),
            "request_pairs": [[a, b, self.request_pairs[(a, b)]] for a, b in sorted(self.request_pairs)],
            "request_transitions": table(self.request_transitions),
            "phase_transitions": {ph: table(t) for ph, t in sorted(self.phase_transitions.items())},
            # tuple keys flatten to sorted [a2, a1, b, n] rows
            "transitions2": [[a2, a1, b, v[b]] for (a2, a1), v in sorted(self.transitions2.items())
                             for b in sorted(v)],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "AccessTrace":
        """Load a v1, v2 or v3 document (tables an older version lacks start
        empty); any other version raises. Counts stay as parsed, so save →
        load → save is byte-identical."""
        if d.get("version") not in (1, 2, cls.VERSION):
            raise ValueError(f"unsupported AccessTrace version {d.get('version')!r}")
        t = cls()
        t.batches = d.get("batches", 0)
        t.touches = dict(d.get("touches", {}))
        t.faults = dict(d.get("faults", {}))
        t.phases = {k: dict(v) for k, v in d.get("phases", {}).items()}
        t.pairs = {(a, b): n for a, b, n in d.get("pairs", [])}
        t.transitions = {k: dict(v) for k, v in d.get("transitions", {}).items()}
        t.request_pairs = {(a, b): n for a, b, n in d.get("request_pairs", [])}
        t.request_transitions = {k: dict(v) for k, v in d.get("request_transitions", {}).items()}
        t.phase_transitions = {ph: {k: dict(v) for k, v in tbl.items()}
                               for ph, tbl in d.get("phase_transitions", {}).items()}
        for a2, a1, b, n in d.get("transitions2", []):
            t.transitions2.setdefault((a2, a1), {})[b] = n
        return t

    @classmethod
    def from_json(cls, s: str) -> "AccessTrace":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        """Atomic write: ``<path>.partial``, then rename."""
        tmp = path + ".partial"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "AccessTrace":
        with open(path) as f:
            return cls.from_dict(json.load(f))


@dataclass
class LoaderStats:
    events: list = field(default_factory=list)
    misses: int = 0          # synchronous request-path loads
    hits: int = 0            # already-resident touches
    prefetch_hits: int = 0   # first demand touch of a prefetch-loaded unit
    prefetch_waits: int = 0  # demand overlapped an in-flight prefetch load
    evictions: int = 0
    evicted_bytes: int = 0
    refaults: int = 0        # loads of a previously-evicted unit
    stalls: list = field(default_factory=list)  # per-ensure miss-stall seconds
    preads_issued: int = 0     # pread syscalls the demand path issued
    frames_fetched: int = 0    # store frames those reads delivered
    coalesced_bytes: int = 0   # payload bytes arriving via multi-frame preads

    @property
    def total_miss_bytes(self) -> int:
        return sum(e.nbytes for e in self.events if e.source != "prefetch")

    @property
    def request_fault_bytes(self) -> int:
        """Bytes moved synchronously on the request path (source "fault")."""
        return sum(e.nbytes for e in self.events if e.source == "fault")

    @property
    def total_loaded_bytes(self) -> int:
        return sum(e.nbytes for e in self.events)

    @property
    def prefetch_hit_rate(self) -> float:
        """Of demand-touched cold units, the fraction the prefetcher hid."""
        n = self.prefetch_hits + self.prefetch_waits + self.misses
        return (self.prefetch_hits + self.prefetch_waits) / n if n else 0.0

    def stall_percentile(self, q: float) -> float:
        if not self.stalls:
            return 0.0
        return float(np.percentile(np.asarray(self.stalls), q))

    def _add_reads(self, rs: ReadStats) -> None:
        self.preads_issued += rs.preads
        self.frames_fetched += rs.frames
        self.coalesced_bytes += rs.coalesced_bytes


class ResidencyManager:
    """Per-unit residency state machine + device-bytes budget accounting.

    All mutation happens under the owner's lock; a condition on that lock
    lets a demand load wait for an in-flight prefetch load. LRU order is an
    ``OrderedDict`` over RESIDENT keys stamped by a logical clock (one tick
    per ensure batch); eviction walks oldest stamp first, ties by key,
    skipping pinned units.
    """

    def __init__(self, lock: threading.RLock, *, budget_bytes: Optional[int] = None):
        self._lock = lock
        self.cv = threading.Condition(lock)
        self.budget_bytes = budget_bytes
        self._state: dict[str, str] = {}
        self._nbytes: dict[str, int] = {}
        self._pins: dict[str, int] = {}
        self._clock = 0
        self._stamp: dict[str, int] = {}
        self._lru: OrderedDict[str, None] = OrderedDict()
        self._loaders: dict[str, str] = {}   # LOADING key -> claimant source
        self._sources: dict[str, str] = {}   # RESIDENT key -> load source
        self._unclaimed_prefetch: set[str] = set()  # prefetched, not yet demanded
        self._evicted_once: set[str] = set()
        self.resident_bytes = 0
        self.max_resident_bytes = 0  # high-water mark
        self.overshoot_events = 0    # installs that couldn't make room

    def charged_bytes(self) -> int:
        """The per-key charges summed over the RESIDENT set: the audit's
        cross-check of ``resident_bytes`` (caller holds the lock)."""
        return sum(self._nbytes.get(k, 0) for k in self._lru)

    def state_of(self, key: str) -> str:
        return self._state.get(key, COLD)

    def is_resident(self, key: str) -> bool:
        return self._state.get(key) == RESIDENT

    @property
    def resident_keys(self) -> set:
        with self._lock:
            return set(self._lru)

    def pins_of(self, key: str) -> int:
        return self._pins.get(key, 0)

    def loader_of(self, key: str) -> str:
        """Source that owns an in-flight LOADING key ("" if none)."""
        return self._loaders.get(key, "")

    def advance_clock(self) -> int:
        self._clock += 1
        return self._clock

    # -- transitions (caller holds the lock) ----------------------------------
    def begin_load(self, key: str, source: str) -> bool:
        """COLD → LOADING; False if the key is not COLD (the caller skips or
        waits). The claimant that got True owns the read."""
        if self._state.get(key, COLD) != COLD:
            return False
        self._state[key] = LOADING
        self._loaders[key] = source
        return True

    def commit_load(self, key: str, nbytes: int, source: str) -> None:
        """LOADING → RESIDENT: charge the budget, make the key MRU."""
        if self._state.get(key) != LOADING:
            raise RuntimeError(f"commit of {key!r} in state {self._state.get(key)}")
        self._state[key] = RESIDENT
        self._nbytes[key] = nbytes
        self._sources[key] = source
        self._loaders.pop(key, None)
        self._lru[key] = None
        self._lru.move_to_end(key)
        self._stamp[key] = self._clock
        if source == "prefetch":
            self._unclaimed_prefetch.add(key)
        self.resident_bytes += nbytes
        self.max_resident_bytes = max(self.max_resident_bytes, self.resident_bytes)
        self.cv.notify_all()

    def abort_load(self, key: str) -> None:
        """LOADING → COLD (the read or decode failed, or the prefetcher stopped)."""
        if self._state.get(key) == LOADING:
            self._state[key] = COLD
            self._loaders.pop(key, None)
            self.cv.notify_all()

    def touch(self, key: str, *, claim_prefetch: bool = True) -> str:
        """Refresh LRU recency. With ``claim_prefetch`` (demand touches)
        returns "prefetch" exactly once per prefetch-loaded unit, the
        hit-accounting credit; hint touches pass False."""
        if key in self._lru:
            self._lru.move_to_end(key)
            self._stamp[key] = self._clock
        if claim_prefetch and key in self._unclaimed_prefetch:
            self._unclaimed_prefetch.discard(key)
            return "prefetch"
        return ""

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
        self._sources.pop(key, None)
        self._unclaimed_prefetch.discard(key)
        self._evicted_once.add(key)
        self.resident_bytes -= nb
        return nb

    def was_evicted(self, key: str) -> bool:
        return key in self._evicted_once

    def wait_resident(self, key: str, timeout: float = 30.0) -> bool:
        """Block until ``key`` leaves LOADING (caller holds the lock through
        the condition). True if it became RESIDENT; False on abort/timeout."""
        deadline = time.monotonic() + timeout
        while self._state.get(key) == LOADING:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            self.cv.wait(remaining)
        return self._state.get(key) == RESIDENT


class TieredParams:
    """The live parameter tree of a cold-started server.

    tier-0 leaves hold real weights from cold start; tier-1 leaves are
    full-shape placeholder zeros filled in place per unit (experts: one
    ``(layer, expert)`` slice; rows: a row range; whole leaf). ``tree()``
    returns the same dict of tensors throughout — installs never replace a
    leaf. ``device_budget_bytes`` bounds the RESIDENT tier-1 bytes.
    ``gate`` serializes writes to the tree with the engine's forward runs
    (see the module docstring).

    Under a mesh the leaves are ``DTensor``s and ``shard_divisors`` maps a
    leaf's path to its shard count (``sharding.spec_shard_divisor``). A unit
    then charges the budget and the arbiter ``ceil(nbytes / divisor)``, its
    bytes per device, while the IO statistics (the return of ``ensure``,
    ``LoadEvent``, fault bytes) keep raw host bytes. An install or eviction
    writes only the part of its unit inside this rank's shard, into the
    DTensor's local tensor (``_unit_slices``): a unit outside the shard
    writes nothing here. A DTensor is never written through a slice of
    itself.
    """

    def __init__(self, tree: dict, plan: TierPlan, store: OptionalStore, *,
                 device_budget_bytes: Optional[int] = None, shard_divisors: Optional[dict] = None):
        self._tree = tree
        self._leaves = dict(flatten_with_paths(tree))
        # what installs write into: a DTensor's local shard, with the global
        # (start, stop) of each of its dims where the shard is not the whole leaf
        self._flat, self._box = dict(self._leaves), {}
        self._mesh = None  # set when the leaves span more than one rank (``missing``)
        for path, leaf in self._leaves.items():
            if is_dtensor(leaf):
                self._flat[path] = leaf.to_local()
                if leaf.device_mesh.size() > 1:
                    self._mesh = leaf.device_mesh
                box = local_box(leaf.shape, leaf.device_mesh, leaf.placements)
                if any((a, b) != (0, n) for (a, b), n in zip(box, leaf.shape)):
                    self._box[path] = box
        self._shard_div: dict[str, int] = dict(shard_divisors or {})
        self.plan = plan
        self.store = store
        self.stats = LoaderStats()
        self.trace: Optional[AccessTrace] = None
        self._phase = ""
        self._lock = threading.RLock()
        self.gate = threading.Lock()
        self.residency = ResidencyManager(self._lock, budget_bytes=device_budget_bytes)
        # set by a ``HostArbiter`` that registers this instance: its private
        # budget is then off and every install makes room through the arbiter
        self.arbiter = None
        self.tenant_name = ""
        self._all_units: dict[str, Unit] = {
            u.key: u for d in plan.decisions.values() for u in d.units
        }

    # -- telemetry -------------------------------------------------------------
    def start_trace(self, trace: Optional[AccessTrace] = None) -> AccessTrace:
        """Record every later request-path ``ensure`` batch into ``trace``
        (a new one by default). Returns the trace."""
        with self._lock:
            self.trace = trace if trace is not None else AccessTrace()
            return self.trace

    def rotate_trace(self, fresh: Optional[AccessTrace] = None) -> Optional[AccessTrace]:
        """Swap in a fresh trace and return the finished window (None if
        tracing was never started); the window is no longer written to."""
        with self._lock:
            old = self.trace
            if old is not None:
                self.trace = fresh if fresh is not None else AccessTrace(max_assoc_batch=old.max_assoc_batch)
            return old

    def trace_snapshot(self) -> Optional[AccessTrace]:
        """A consistent copy of the live trace (None if tracing is off)."""
        with self._lock:
            return AccessTrace.from_dict(self.trace.to_dict()) if self.trace else None

    def set_phase(self, phase: str) -> None:
        """Tag subsequent loads/trace batches ("prefill" | "decode" | "")."""
        self._phase = phase

    def record_request(self, rid: int, keys: Iterable[str]) -> None:
        """Attribute one request's step accesses in the live trace (the
        scheduler's per-request profile). No-op without a trace."""
        with self._lock:
            if self.trace is not None:
                self.trace.record_request(rid, keys)

    def end_request(self, rid: int) -> None:
        with self._lock:
            if self.trace is not None:
                self.trace.end_request(rid)

    # -- residency ----------------------------------------------------------
    def is_resident(self, key: str) -> bool:
        return self.residency.is_resident(key)

    def missing(self, keys: list) -> list:
        """The keys a forward run just read as placeholders: those not
        RESIDENT here, or, when the leaves span several ranks, not RESIDENT
        on some rank (an all-reduce over the mesh), since a run gathers every
        rank's shard. Every rank passes the same keys (its run's outputs are
        the same) and gets the same list back, so all retry together."""
        flags = [not self.residency.is_resident(k) for k in keys]
        if self._mesh is not None and keys:
            t = torch.tensor(flags, dtype=torch.int32, device=self._flat[next(iter(self._flat))].device)
            for dim in range(self._mesh.ndim):  # the max over each dim in turn is the mesh's
                dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._mesh.get_group(dim))
            flags = t.tolist()
        return [k for k, f in zip(keys, flags) if f]

    @property
    def resident_keys(self) -> set:
        return self.residency.resident_keys

    @property
    def resident_bytes(self) -> int:
        return self.residency.resident_bytes

    def resident_fraction(self) -> float:
        n = len(self._all_units)
        return len(self.residency.resident_keys) / n if n else 1.0

    def unit_charge(self, key: str, nbytes: Optional[int] = None) -> int:
        """Device-budget charge of one unit: its bytes (``nbytes`` if given,
        else ``Unit.nbytes``, else its frame's raw size) divided by the
        owning leaf's shard divisor, rounded up so a charge is never free.
        The bytes themselves where the leaf is replicated or no mesh is
        attached."""
        u = self._all_units.get(key)
        nb = nbytes
        if nb is None:
            e = self.store.entries.get(key) if self.store is not None else None
            nb = u.nbytes if u is not None and u.nbytes else e.rsize if e is not None else 0
        div = self._shard_div.get(u.path, 1) if u is not None else 1
        return nb if div <= 1 else -(-nb // div)

    # -- the rewrite_template analogue ---------------------------------------
    def ensure(self, keys: Iterable[str], *, pin: bool = False, source: str = "fault") -> int:
        """Fault in the given unit keys; returns bytes moved (0 = warm hit).
        Claims COLD keys, reads and decodes them off the lock, evicts to fit
        and installs, and waits out keys another loader (the prefetcher)
        owns. With ``pin=True`` the keys stay unevictable until
        ``release()``. Thread-safe; never call it holding ``gate``."""
        keys = list(dict.fromkeys(keys))
        t_start = time.perf_counter()
        res = self.residency
        to_load: list[str] = []
        wait_for: list[tuple[str, str]] = []  # (key, in-flight loader source)
        cold: list[str] = []
        with self._lock:
            res.advance_clock()  # one stamp per ensure batch
            for k in keys:
                st = res.state_of(k)
                if st == RESIDENT:
                    if res.touch(k) == "prefetch":
                        self.stats.prefetch_hits += 1
                    else:
                        self.stats.hits += 1
                elif st == LOADING:
                    cold.append(k)
                    wait_for.append((k, res.loader_of(k)))
                else:
                    cold.append(k)
                    if res.begin_load(k, source):
                        to_load.append(k)
            if pin:
                res.pin(keys)
            if self.trace is not None and source == "fault":
                self.trace.record(keys, cold, self._phase)
        if not to_load and not wait_for:
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

        if wait_for:
            with self._lock:
                for k, loader in wait_for:
                    while not res.is_resident(k):
                        if res.begin_load(k, source):
                            # the other loader aborted: take the load over
                            self._lock.release()
                            try:
                                moved += self._load_one(k, source)
                            finally:
                                self._lock.acquire()
                            break
                        if not res.wait_resident(k) and res.state_of(k) == LOADING:
                            # never return with the key cold: the caller
                            # would compute on placeholder zeros
                            raise RuntimeError(f"timed out waiting for in-flight load of {k!r}")
                        # COLD after an abort: loop back and try to claim
                    else:
                        res.touch(k)
                        if loader == "prefetch":
                            self.stats.prefetch_waits += 1
        if source == "fault":  # miss-stall percentiles are request-path only
            self.stats.stalls.append(time.perf_counter() - t_start)
        return moved

    def _load_chunk(self, chunk: list[str], source: str) -> int:
        """Read one chunk's frames (one vectored pass), decode them
        concurrently, then evict-to-fit and install each in offset order."""
        tr0 = time.perf_counter()
        rs = ReadStats()
        bufs = self.store.read_raw_many(chunk, stats=rs)
        t_read = time.perf_counter() - tr0
        self.stats._add_reads(rs)
        decoded = self._decode_all(chunk, bufs)
        total_csize = sum(self.store.entries[k].csize for k in chunk) or 1
        moved = 0
        for key in chunk:
            host, decode_s = decoded.pop(key)
            # the chunk's read wall is split csize-proportionally
            fetch_s = decode_s + t_read * self.store.entries[key].csize / total_csize
            moved += self._commit(key, host, fetch_s, source)
        return moved

    def _load_one(self, key: str, source: str) -> int:
        """Synchronous load of one already-claimed key (the takeover path)."""
        try:
            t0 = time.perf_counter()
            rs = ReadStats()
            host = self.store.decode(key, self.store.read_raw(key, stats=rs))
            fetch_s = time.perf_counter() - t0
        except Exception:
            with self._lock:
                self.residency.abort_load(key)
            raise
        self.stats._add_reads(rs)
        return self._commit(key, host, fetch_s, source)

    def _commit(self, key: str, host: torch.Tensor, fetch_s: float, source: str) -> int:
        """Evict to fit, install one claimed unit and commit it RESIDENT."""
        res = self.residency
        nbytes = host.numel() * host.element_size()
        charge = self.unit_charge(key, nbytes)
        if self.arbiter is not None:
            # cross-tenant make-room before the gate (the arbiter's lock comes first)
            self.arbiter.make_room(self, charge)
        with self.gate, self._lock:
            t1 = time.perf_counter()
            self._evict_to_fit(charge)
            self._install(self._all_units[key], host)
            t2 = time.perf_counter()
            res.commit_load(key, charge, source)
            if res.was_evicted(key):
                self.stats.refaults += 1
            if source == "fault":  # preload is not a request-path miss
                self.stats.misses += 1
            self.stats.events.append(LoadEvent(
                key, nbytes, fetch_s, t2 - t1, t=time.monotonic(),
                source=source, phase=self._phase))
        return nbytes

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

    def ensure_all(self) -> int:
        """Load every tier-1 unit (degrades to the 'full' baseline)."""
        return self.ensure(list(self._all_units))

    def touch(self, keys: Iterable[str]) -> None:
        """Refresh LRU recency without demand-access accounting (predictive
        hints on already-resident units)."""
        with self._lock:
            self.residency.advance_clock()
            for k in keys:
                self.residency.touch(k, claim_prefetch=False)

    def release(self, keys: Iterable[str]) -> None:
        """Unpin keys pinned by ``ensure(pin=True)``; over-budget residency
        left by pinned installs is reclaimed here (LRU first)."""
        with self.gate, self._lock:
            self.residency.release(keys)
            self._evict_to_budget()
        if self.arbiter is not None:
            # host-wide reclaim once both locks are dropped (it may evict other tenants)
            self.arbiter.rebalance()

    # -- prefetch integration ---------------------------------------------------
    def claim_for_prefetch(self, key: str) -> bool:
        """COLD → LOADING on behalf of the prefetcher's reader thread."""
        if key not in self._all_units:
            return False
        with self._lock:
            return self.residency.begin_load(key, "prefetch")

    def abort_prefetch(self, key: str) -> None:
        with self._lock:
            self.residency.abort_load(key)

    def install_prefetched(self, key: str, host: torch.Tensor, fetch_s: float = 0.0) -> int:
        """Install one staged host tensor claimed via ``claim_for_prefetch``.
        Returns the bytes installed (0 if the claim is gone). The copy to the
        device has landed when this returns (a copy from pageable host
        memory synchronizes), so RESIDENT is committed only after it."""
        unit = self._all_units.get(key)
        if unit is None or self.residency.state_of(key) != LOADING:
            return 0
        nbytes = host.numel() * host.element_size()
        charge = self.unit_charge(key, nbytes)
        if self.arbiter is not None:
            self.arbiter.make_room(self, charge)
        with self.gate, self._lock:
            if self.residency.state_of(key) != LOADING:
                return 0
            self.residency.advance_clock()
            self._evict_to_fit(charge)
            t0 = time.perf_counter()
            self._install(unit, host)
            upload_s = time.perf_counter() - t0
            self.residency.commit_load(key, charge, "prefetch")
            self.stats.events.append(LoadEvent(
                key, nbytes, fetch_s, upload_s, t=time.monotonic(),
                source="prefetch", phase=self._phase))
        return nbytes

    # -- eviction ---------------------------------------------------------------
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
        view = self._unit_view(self._all_units[key])
        if view is not None:
            view.zero_()
        nb = self.residency.evict_commit(key)
        self.stats.evictions += 1
        self.stats.evicted_bytes += nb
        return nb

    def evict(self, keys: Iterable[str]) -> int:
        """Evict resident, unpinned units. Returns bytes freed."""
        freed = 0
        with self.gate, self._lock:
            for k in keys:
                if self.residency.is_resident(k) and self.residency.pins_of(k) == 0:
                    freed += self._evict_one(k)
        return freed

    def eviction_candidates(self) -> list:
        """``(key, nbytes, stamp)`` of every RESIDENT, unpinned unit, oldest
        stamp first: the host arbiter's view of this tenant's evictable pool.
        A snapshot: ``evict`` checks pins and state again under the lock."""
        with self._lock:
            res = self.residency
            return [(k, res._nbytes.get(k, 0), res._stamp.get(k, 0)) for k in res._lru if res.pins_of(k) == 0]

    # -- installation (in place, under the gate) ----------------------------------
    def _unit_slices(self, unit: Unit) -> Optional[tuple]:
        """``(leaf index, host index)``: where the unit lies in the tensor
        installs write (``_flat``) and which part of the unit's host tensor
        goes there. The unit is ``leaf[sel][r0:r1]``, so its host tensor's
        dims are the leaf's after ``sel``. Without a shard box the whole unit;
        in a shard, the rows and trailing dims inside the box, and None when
        none of the unit is."""
        box = self._box.get(unit.path)
        rows = () if unit.rows is None else (slice(*unit.rows),)
        if box is None:
            return tuple(unit.sel) + rows, ()
        leaf_idx, host_idx = [], []
        for d, i in enumerate(unit.sel):
            if not box[d][0] <= i < box[d][1]:
                return None
            leaf_idx.append(i - box[d][0])
        for d in range(len(unit.sel), len(box)):
            start, stop = box[d]
            r0, r1 = unit.rows if unit.rows is not None and d == len(unit.sel) else (0, None)
            lo, hi = max(r0, start), stop if r1 is None else min(r1, stop)
            if lo >= hi:
                return None
            leaf_idx.append(slice(lo - start, hi - start))
            host_idx.append(slice(lo - r0, hi - r0))
        return tuple(leaf_idx), tuple(host_idx)

    def _unit_view(self, unit: Unit) -> Optional[torch.Tensor]:
        """The part of the unit this rank holds, as a view of ``_flat``
        (None when it holds none)."""
        view = self._unit_slices(unit)
        return None if view is None else self._flat[unit.path][view[0]]

    def _install(self, unit: Unit, host: torch.Tensor) -> None:
        want = tuple(self._leaves[unit.path].shape[len(unit.sel):])
        if unit.rows is not None:
            want = (unit.rows[1] - unit.rows[0],) + want[1:]
        if tuple(host.shape) != want:
            raise ValueError(f"unit {unit.key!r}: stored shape {tuple(host.shape)} != leaf slice {want}")
        view = self._unit_slices(unit)
        if view is not None:
            self._flat[unit.path][view[0]].copy_(host[view[1]])

    # -- access ----------------------------------------------------------------
    def tree(self) -> dict:
        return self._tree

    def leaf(self, path: str) -> torch.Tensor:
        """The live leaf at ``path`` (a ``DTensor`` under a mesh)."""
        return self._leaves[path]

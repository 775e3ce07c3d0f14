"""⑤ Predictive prefetch — hiding the one-time fault latency
(``repro.core.prefetch`` counterpart).

The ``Prefetcher`` takes access hints from the serving engine (the experts a
step routed to, the row groups of the top-k candidate tokens of its logits)
and pulls tier-1 units from the ``OptionalStore`` off the request path:

    hint(keys) ──▶ [hint set] ──reader thread──▶ pread + zlib decode (host)
                                  │ bounded stage queue (depth 2)
                                  ▼
                   [stage queue] ──uploader thread──▶ in-place device install

The reader's vectored pread and zlib decode release the GIL; the uploader
installs through ``TieredParams.install_prefetched``, which takes the tiered
params' gate, so an install never lands inside one of the engine's forward
runs. The stage queue is bounded, so a slow device never lets host staging
grow without bound.

Claim protocol: the reader claims each key COLD→LOADING via
``claim_for_prefetch`` before touching the store; a demand ``ensure()`` that
wants a claimed key waits on the residency condition instead of reading it
twice, and eviction never selects a LOADING unit. On shutdown every
unfinished claim is aborted back to COLD so no waiter hangs.

With a ``TransitionPredictor`` (built from an ``AccessTrace``),
``observe(keys)`` hints the learned successors of each step's demand
accesses one step ahead of the engine's own hints.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Iterable, Optional

from repro_torch.core.on_demand import COLD, TieredParams
from repro_torch.core.optional_store import COALESCE_GAP, ReadStats, StoreError


def merge_hints(*hint_lists: Iterable[str]) -> list[str]:
    """Round-robin-merge per-slot hint lists into one deduped FIFO stream.

    The scheduler collects hints per active slot (each slot's list is
    ordered most-likely-first); a plain concatenation would let slot 0's
    long tail starve every other slot's best predictions, because the
    Prefetcher drains its hint set oldest-first. Interleaving
    (slot0[0], slot1[0], …, slot0[1], slot1[1], …) keeps the prefetch
    bandwidth fair across concurrent requests."""
    out: "OrderedDict[str, None]" = OrderedDict()
    iters = [iter(h) for h in hint_lists]
    while iters:
        survivors = []
        for it in iters:
            for k in it:
                out.setdefault(k, None)
                survivors.append(it)
                break
        iters = survivors
    return list(out)


def _rank(counts: dict, k: int) -> list[str]:
    """Top-``k`` keys by observed count, equal counts tie-broken by key —
    NEVER by dict insertion order, so an identical table built from a
    differently-ordered trace predicts in an identical order."""
    return [n for n, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:k]]


class TransitionPredictor:
    """Learned unit→next-unit model from a profiling run.

    Three stacked signals, consulted most-specific-first by ``follow``:

      * **second-order** — ``AccessTrace.transitions2``: successors of the
        *(two-batches-ago, previous-batch)* unit pair; a workload whose
        step t is ambiguous given step t−1 alone (shared prefix, divergent
        tails) disambiguates on the pair;
      * **phase-conditioned** — ``AccessTrace.phase_transitions``: separate
        successor tables for prefill and decode batches (a unit hot during
        prefill is often cold in decode); falls back to
      * **first-order global** — the original ``transitions`` table.

    Rankings come from observed counts with ties broken by key (see
    ``_rank``); per-key lists are round-robin-merged (``merge_hints``, the
    scheduler's per-slot fairness rule) so one unit's long tail cannot
    starve another's best prediction. Finally each predicted unit is
    **cluster-expanded** through its strongest co-access mates (from the
    coincidence-free ``request_pairs`` when present, else ``pairs``): one
    predicted hit pre-warms the whole cluster that historically loads
    together.
    """

    def __init__(
        self,
        transitions: dict,
        *,
        top_k: int = 8,
        phase_transitions: Optional[dict] = None,
        transitions2: Optional[dict] = None,
        pairs: Optional[dict] = None,
        cluster_size: int = 3,
        cluster_min_count: int = 2,
    ):
        self.top_k = max(1, top_k)
        self._table: dict[str, list[str]] = {
            key: _rank(counts, self.top_k)
            for key, counts in transitions.items()
            if counts
        }
        self._phase_tables: dict[str, dict[str, list[str]]] = {
            ph: {key: _rank(counts, self.top_k) for key, counts in tbl.items() if counts}
            for ph, tbl in (phase_transitions or {}).items()
        }
        self._table2: dict[tuple, list[str]] = {
            ctx: _rank(counts, self.top_k)
            for ctx, counts in (transitions2 or {}).items()
            if counts
        }
        # co-access clusters as bounded neighbour lists: for each unit, its
        # ``cluster_size`` strongest partners with pair count >=
        # ``cluster_min_count`` (a one-off coincidence is not a cluster)
        by_key: dict[str, dict[str, int]] = {}
        for (a, b), n in (pairs or {}).items():
            if n >= cluster_min_count:
                by_key.setdefault(a, {})[b] = n
                by_key.setdefault(b, {})[a] = n
        self._mates: dict[str, list[str]] = {
            k: _rank(partners, max(0, cluster_size))
            for k, partners in by_key.items()
        }

    @classmethod
    def from_trace(
        cls, trace, *, top_k: int = 8, prefer_request: bool = False,
        cluster_size: int = 3, cluster_min_count: int = 2,
    ) -> "TransitionPredictor":
        """``trace`` is a ``core.on_demand.AccessTrace`` (or anything with
        the same table attributes; absent ones default empty). With
        ``prefer_request`` the coincidence-free ``request_transitions`` /
        ``request_pairs`` take precedence over the batch-level tables when
        non-empty (scheduler-attributed traffic)."""
        table = trace.transitions
        pairs = getattr(trace, "pairs", None)
        if prefer_request:
            table = getattr(trace, "request_transitions", None) or table
            pairs = getattr(trace, "request_pairs", None) or pairs
        return cls(
            table,
            top_k=top_k,
            phase_transitions=getattr(trace, "phase_transitions", None),
            transitions2=getattr(trace, "transitions2", None),
            pairs=pairs,
            cluster_size=cluster_size,
            cluster_min_count=cluster_min_count,
        )

    def __len__(self) -> int:
        return len(self._table)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        """The *ranked* tables as a plain-JSON dict. Counts are already
        folded into rank order by __init__, so the round-trip preserves
        exactly what ``follow`` consults — deterministically (every key
        sorted)."""
        return {
            "top_k": self.top_k,
            "table": {k: list(v) for k, v in sorted(self._table.items())},
            "phase_tables": {
                ph: {k: list(v) for k, v in sorted(tbl.items())}
                for ph, tbl in sorted(self._phase_tables.items())
            },
            # tuple context keys flatten to [a2, a1, [succ...]] rows
            "table2": [
                [a2, a1, list(v)] for (a2, a1), v in sorted(self._table2.items())
            ],
            "mates": {k: list(v) for k, v in sorted(self._mates.items())},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TransitionPredictor":
        p = cls({}, top_k=d.get("top_k", 8))
        p._table = {k: list(v) for k, v in d.get("table", {}).items()}
        p._phase_tables = {
            ph: {k: list(v) for k, v in tbl.items()}
            for ph, tbl in d.get("phase_tables", {}).items()
        }
        p._table2 = {(a2, a1): list(v) for a2, a1, v in d.get("table2", [])}
        p._mates = {k: list(v) for k, v in d.get("mates", {}).items()}
        return p

    def successors(self, key: str, *, phase: str = "") -> list[str]:
        """First-order successors; with ``phase`` the phase-conditioned
        table is consulted first, falling back to the global one."""
        if phase:
            hit = self._phase_tables.get(phase, {}).get(key)
            if hit:
                return list(hit)
        return list(self._table.get(key, ()))

    def mates(self, key: str) -> list[str]:
        """The unit's co-access cluster (strongest partners first)."""
        return list(self._mates.get(key, ()))

    def follow(
        self, keys: Iterable[str], *, phase: str = "", prev: Iterable[str] = (),
    ) -> list[str]:
        """Ranked, deduped successor predictions for a set of observed
        units; the observed units themselves are never predicted. ``prev``
        is the previous observation batch — when given, second-order
        ``(prev_unit, cur_unit)`` context outranks first-order successors.
        Merge order follows the caller's key order (deduped), not a hash-
        randomized set, so identical runs prefetch in identical order."""
        ordered = list(dict.fromkeys(keys))
        seen = set(ordered)
        streams: list = []
        if prev and self._table2:
            prev_ordered = list(dict.fromkeys(prev))
            streams.extend(
                self._table2[(a2, a1)]
                for a2 in prev_ordered
                for a1 in ordered
                if (a2, a1) in self._table2
            )
        streams.extend(self.successors(k, phase=phase) for k in ordered)
        merged = [k for k in merge_hints(*streams) if k not in seen]
        if not self._mates:
            return merged
        # cluster expansion: a predicted unit drags its co-access mates in
        # behind it (they historically load together), never ahead of a
        # directly-predicted unit
        out = list(merged)
        have = seen | set(out)
        for k in merged:
            for m in self._mates.get(k, ()):
                if m not in have:
                    out.append(m)
                    have.add(m)
        return out


@dataclass
class PrefetchStats:
    hints: int = 0             # keys offered via hint()
    enqueued: int = 0          # keys accepted (cold + not already queued)
    loaded_units: int = 0
    loaded_bytes: int = 0
    skipped_resident: int = 0  # hints dropped because already resident/queued
    skipped_headroom: int = 0  # hints dropped by the host arbiter's gate
    batches: int = 0
    errors: int = 0
    observed: int = 0          # demand-accessed keys fed to observe()
    predicted: int = 0         # predictor-expanded hints accepted for loading
    preads_issued: int = 0     # pread syscalls the reader thread issued
    frames_fetched: int = 0    # store frames those reads delivered
    coalesced_bytes: int = 0   # payload bytes arriving via multi-frame preads

    def to_dict(self) -> dict:
        return {
            "hints": self.hints,
            "enqueued": self.enqueued,
            "loaded_units": self.loaded_units,
            "loaded_bytes": self.loaded_bytes,
            "skipped_resident": self.skipped_resident,
            "skipped_headroom": self.skipped_headroom,
            "batches": self.batches,
            "errors": self.errors,
            "observed": self.observed,
            "predicted": self.predicted,
            "preads_issued": self.preads_issued,
            "frames_fetched": self.frames_fetched,
            "coalesced_bytes": self.coalesced_bytes,
        }


@dataclass
class _Stage:
    """One host staging buffer: decoded units awaiting device upload."""

    items: list = field(default_factory=list)  # (key, host tensor, fetch_s)


class Prefetcher:
    """Background tier-1 loader driven by engine hints: a reader thread
    (pread + decode into host staging) and an uploader thread (device
    install), joined by a bounded stage queue."""

    def __init__(
        self,
        tiered: TieredParams,
        *,
        batch_units: int = 8,
        queue_depth: int = 2,
        name: str = "prefetch",
        predictor: Optional[TransitionPredictor] = None,
        read_gap_bytes: int = COALESCE_GAP,
    ):
        if tiered.store is None:
            raise ValueError("prefetcher needs a TieredParams with an optional store")
        self.tiered = tiered
        self.batch_units = max(1, batch_units)
        self.read_gap_bytes = read_gap_bytes  # pread coalescing gap (0 = off)
        self.predictor = predictor
        self._obs_prev: list[str] = []  # last observe() batch (2nd-order context)
        self.stats = PrefetchStats()
        # hint set keeps insertion order (FIFO priority) while deduping
        self._hints: OrderedDict[str, None] = OrderedDict()
        self._hint_lock = threading.Lock()
        self._wake = threading.Event()
        self._stage_q: queue.Queue[_Stage] = queue.Queue(maxsize=max(1, queue_depth))
        self._inflight = 0  # claimed by the reader, not yet installed/aborted
        self._idle = threading.Condition(self._hint_lock)
        self._stop = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, name=f"{name}-read", daemon=True)
        self._uploader = threading.Thread(target=self._upload_loop, name=f"{name}-upload", daemon=True)
        self._reader.start()
        self._uploader.start()

    # -- producer side ---------------------------------------------------------
    def hint(self, keys: Iterable[str]) -> int:
        """Offer access hints. Non-blocking: cold keys join the FIFO hint
        set, already-resident keys get an LRU touch (a predicted reuse should
        not be the next eviction victim). Under a host arbiter a cold hint
        is dropped when loading it would force evictions beyond the tenant's
        share (``HostArbiter.prefetch_headroom``); demand loads are never
        gated. Returns the keys accepted."""
        if self._stop.is_set():
            return 0
        accepted = 0
        touch: list[str] = []
        res = self.tiered.residency
        arb = self.tiered.arbiter  # set while a HostArbiter governs this tenant
        with self._hint_lock:
            for k in keys:
                self.stats.hints += 1
                if k in self._hints or res.state_of(k) != COLD:
                    self.stats.skipped_resident += 1
                    if res.is_resident(k):
                        touch.append(k)
                    continue
                if arb is not None and not arb.prefetch_headroom(self.tiered, self.tiered.unit_charge(k)):
                    self.stats.skipped_headroom += 1
                    continue
                self._hints[k] = None
                accepted += 1
            self.stats.enqueued += accepted
        if touch:
            self.tiered.touch(touch)
        if accepted:
            self._wake.set()
        return accepted

    def observe(self, keys: Iterable[str]) -> int:
        """Feed the units a step actually demand-accessed; with a predictor,
        their learned successors join the hint set. Returns the predicted
        keys accepted (0 without a predictor)."""
        if self.predictor is None or self._stop.is_set():
            return 0
        keys = list(keys)
        if not keys:
            return 0
        self.stats.observed += len(keys)
        prev, self._obs_prev = self._obs_prev, keys
        predicted = self.predictor.follow(keys, phase=self.tiered._phase, prev=prev)
        if not predicted:
            return 0
        accepted = self.hint(predicted)
        self.stats.predicted += accepted
        return accepted

    @property
    def hit_rate(self) -> float:
        return self.tiered.stats.prefetch_hit_rate

    # -- lifecycle -------------------------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every accepted hint is installed (or aborted)."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._hints or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(min(remaining, 0.1))
        return True

    def stop(self, timeout: float = 30.0) -> None:
        """Stop both threads and abort whatever is still staged."""
        self._stop.set()
        self._wake.set()
        self._reader.join(timeout)
        self._uploader.join(timeout)
        if self._reader.is_alive() or self._uploader.is_alive():
            raise RuntimeError(f"prefetch threads still running {timeout} s after stop()")
        while True:
            try:
                stage = self._stage_q.get_nowait()
            except queue.Empty:
                break
            for key, _, _ in stage.items:
                self.tiered.abort_prefetch(key)
                self._done(1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- reader thread: pread + decode into host staging ------------------------
    def _next_batch(self) -> list[str]:
        with self._hint_lock:
            batch = []
            while self._hints and len(batch) < self.batch_units:
                batch.append(self._hints.popitem(last=False)[0])
            if not self._hints:
                self._wake.clear()
            self._inflight += len(batch)
        return batch

    def _done(self, n: int) -> None:
        with self._idle:
            self._inflight -= n
            self._idle.notify_all()

    def _read_loop(self) -> None:
        store = self.tiered.store
        while not self._stop.is_set():
            if not self._wake.wait(timeout=0.05):
                continue
            batch = self._next_batch()
            if not batch:
                continue
            claimed = [k for k in batch if self.tiered.claim_for_prefetch(k)]
            self._done(len(batch) - len(claimed))
            if not claimed:
                continue
            stage = _Stage()
            ordered = sorted(claimed, key=lambda k: store.entries[k].offset)
            # one vectored pass for the whole batch; a failing batch read
            # falls back to per-key reads so one torn frame aborts one key
            rs = ReadStats()
            try:
                t_read0 = time.perf_counter()
                bufs = store.read_raw_many(ordered, gap_threshold=self.read_gap_bytes, stats=rs)
                t_read = time.perf_counter() - t_read0
            except StoreError:
                bufs, t_read = {}, 0.0
            self._add_reads(rs)
            total_csize = sum(store.entries[k].csize for k in ordered) or 1
            for key in ordered:
                if self._stop.is_set():
                    self.tiered.abort_prefetch(key)
                    self._done(1)
                    continue
                try:
                    t0 = time.perf_counter()
                    if key in bufs:
                        buf = bufs.pop(key)
                        # the batch read's wall is split csize-proportionally
                        t_io = t_read * (store.entries[key].csize / total_csize)
                    else:
                        t_io = 0.0
                        rs2 = ReadStats()
                        buf = store.read_raw(key, stats=rs2)
                        self._add_reads(rs2)
                    host = store.decode(key, buf)
                    stage.items.append((key, host, t_io + time.perf_counter() - t0))
                except Exception:
                    self.stats.errors += 1
                    self.tiered.abort_prefetch(key)
                    self._done(1)
            if not stage.items:
                continue
            self.stats.batches += 1
            while not self._stop.is_set():
                try:
                    self._stage_q.put(stage, timeout=0.1)
                    break
                except queue.Full:
                    continue
            else:  # stopping with a full queue: roll the claims back
                for key, _, _ in stage.items:
                    self.tiered.abort_prefetch(key)
                    self._done(1)

    def _add_reads(self, rs: ReadStats) -> None:
        self.stats.preads_issued += rs.preads
        self.stats.frames_fetched += rs.frames
        self.stats.coalesced_bytes += rs.coalesced_bytes

    # -- uploader thread: staged host tensors → device ---------------------------
    def _upload_loop(self) -> None:
        while not (self._stop.is_set() and self._stage_q.empty()):
            try:
                stage = self._stage_q.get(timeout=0.1)
            except queue.Empty:
                continue
            for key, host, fetch_s in stage.items:
                try:
                    moved = self.tiered.install_prefetched(key, host, fetch_s)
                    if moved:
                        self.stats.loaded_units += 1
                        self.stats.loaded_bytes += moved
                except Exception:
                    self.stats.errors += 1
                    self.tiered.abort_prefetch(key)
                finally:
                    self._done(1)

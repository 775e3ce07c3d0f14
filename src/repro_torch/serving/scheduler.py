"""Continuous-batching request scheduler over the on-demand engine
(``repro.serving.scheduler`` counterpart).

``GenerationEngine.generate()`` serves one batch synchronously. The
scheduler turns the same fault-in, pin and prefetch machinery into a
serving loop:

  * **slots** — a fixed ``max_batch`` of decode lanes over ONE compiled
    masked-decode entry (``ColdStartServer.compiled_decode_masked``: a CUDA
    graph on the card, the plain call on the CPU) whose caches are the
    slots' caches. Per slot: the owning request, its token position, its
    last emitted token; the free/taken state is the ``active`` mask fed to
    the step. Inactive rows ride the batch as pad lanes: their routing never
    reaches the usage masks (so a free slot never faults a unit in), and
    what they write to their own cache row is overwritten at the slot's next
    admission.
  * **admission** — between decode steps, queued prompts fill free slots:
    same-length prompts admitted in one round share one prefill through the
    compiled (k, S) entry, whose caches are written into the slots' rows of
    the decode caches in place (``_graft_slot_cache``). Over-length requests
    are rejected at admission (``Request.error``), never raised out of the
    loop.
  * **union fault handling** — each decode step ensures (pinned) the union
    of every active slot's vocab row groups and runs one expert retry loop
    over the union of routed misses.
  * **fairness** — admission follows the policy (strict FIFO by default),
    every active slot advances one token per step, and hints are
    round-robin-merged across slots (``core.prefetch.merge_hints``).
  * **paged KV accounting** — a ``PagePool`` grants each request the pages
    its ``prompt + n_steps`` positions need (atomic: on exhaustion the
    request is rejected with slot state untouched); retire and both failure
    paths return them. The decode itself stays dense over the slots'
    (max_batch, max_seq) caches, as the reference's does; the pool only
    counts what a paged layout would stream (``kv_tokens_paged`` against
    ``kv_tokens_dense``).
  * **online re-tiering** — with a ``RetierDaemon`` on the server the loop
    ticks it at the end of every step (and with ``steps=0`` on an idle
    step, for its wall-clock cadence): between steps, never while a forward
    run holds the tiered params' gate.

Greedy outputs equal each request run alone through ``generate()`` (the
tests hold that on the CPU): decode rows are independent, serving MoE is
dropless at these sizes, and admission rebuilds the slot's cache row.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.prefetch import merge_hints
from repro_torch.serving.engine import GenerationEngine, RequestStats, graft_prefix
from repro_torch.serving.paged_kv import PagePool
from repro_torch.utils.tree import flatten_with_paths


@dataclass
class Request:
    """One generation request moving through the scheduler."""

    rid: int
    tokens: np.ndarray  # (S,) int32 prompt
    n_steps: int
    submitted_t: float = 0.0
    admitted_t: float = 0.0
    first_token_t: float = 0.0
    finished_t: float = 0.0
    # SLO admission: seconds after submit by which the LAST token must land
    # (None: no deadline), and a tie-breaking priority (higher first under
    # burst re-ordering). The FIFO policy ignores both.
    deadline_s: Optional[float] = None
    priority: int = 0
    out: list = field(default_factory=list)  # emitted token ids
    stats: RequestStats = field(default_factory=RequestStats)
    error: Optional[str] = None
    _done: threading.Event = field(default_factory=threading.Event, repr=False)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def finish(self, error: Optional[str] = None) -> None:
        self.error = error
        self.finished_t = time.perf_counter()
        self._done.set()

    @property
    def output(self) -> np.ndarray:
        return np.asarray(self.out, np.int32)

    @property
    def latency_s(self) -> float:
        """Submit → last token (0 until finished)."""
        return max(0.0, self.finished_t - self.submitted_t)

    @property
    def ttft_s(self) -> float:
        """Submit → first token (prefill wait included)."""
        return max(0.0, self.first_token_t - self.submitted_t)

    @property
    def deadline_t(self) -> Optional[float]:
        """Absolute perf_counter deadline (None without one)."""
        if self.deadline_s is None:
            return None
        return self.submitted_t + self.deadline_s

    @property
    def shed(self) -> bool:
        """True when an SLO policy dropped this request unserved."""
        return self.error is not None and self.error.startswith("shed:")


class RequestQueue:
    """Thread-safe FIFO of pending requests. ``submit`` is safe from any
    thread; the scheduler's thread pops."""

    def __init__(self) -> None:
        self._q: deque[Request] = deque()
        self._lock = threading.Lock()
        self._next_rid = 0

    def submit(self, tokens, n_steps: int, *, deadline_s: Optional[float] = None,
               priority: int = 0) -> Request:
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            req = Request(rid, tokens, int(n_steps), submitted_t=time.perf_counter(),
                          deadline_s=deadline_s, priority=int(priority))
            self._q.append(req)
        return req

    def pop(self) -> Optional[Request]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class AdmissionPolicy:
    """Admission decision for the scheduler. Each round the scheduler calls
    ``select(queue, free, now, validate)``: the policy may pop from the queue
    and returns ``(admit, drop)``, at most ``free`` requests to admit and
    ``(request, kind, error)`` triples to retire unserved (``kind``
    "rejected" for invalid requests, "shed" for load or deadline drops).
    ``validate(req)`` returns the rejection message or None. A policy that
    holds popped requests in a backlog reports them through ``pending()``.
    ``note_prefill`` / ``note_step`` feed it observed service times."""

    def select(self, queue: RequestQueue, free: int, now: float, validate):
        raise NotImplementedError

    def pending(self) -> int:
        return 0

    def note_prefill(self, seconds: float) -> None:
        pass

    def note_step(self, seconds: float, n_active: int) -> None:
        pass


class FIFOAdmission(AdmissionPolicy):
    """The default: strict arrival order, no deadlines, never sheds."""

    def select(self, queue: RequestQueue, free: int, now: float, validate):
        admit: list[Request] = []
        drop: list[tuple[Request, str, str]] = []
        while len(admit) < free:
            req = queue.pop()
            if req is None:
                break
            err = validate(req)
            if err is not None:
                drop.append((req, "rejected", err))  # the loop survives bad requests
                continue
            admit.append(req)
        return admit, drop


class SLOAdmission(AdmissionPolicy):
    """Deadline- and queue-depth-aware admission:

      * shed-on-hopeless — a request whose projected finish already exceeds
        its deadline is dropped before any prefill or decode is spent on it
        (``error="shed: ..."``). The projection is slot-granular: work ranked
        ahead fills the slots in waves, each holding its slot for a full
        decode, so a request ``w`` waves deep projects ``now + prefill_est +
        (1 + w) × n_steps × step_est``, from EMAs of observed service times;
      * priority re-order under burst — the backlog admits by (priority
        desc, deadline asc, arrival); with equal priorities and no deadlines
        that is FIFO;
      * bounded backlog wait — requests a round could not admit stay in the
        backlog (``pending()``) and are projected again every round.

    ``default_deadline_s`` applies to requests submitted without one (None:
    such requests are never shed)."""

    def __init__(self, *, default_deadline_s: Optional[float] = None, step_est_s: float = 2e-3,
                 prefill_est_s: float = 10e-3, ema: float = 0.2):
        self.default_deadline_s = default_deadline_s
        self.ema = float(ema)
        self._step_est = float(step_est_s)
        self._prefill_est = float(prefill_est_s)
        self._backlog: list[Request] = []
        self._slots = 1  # widest admission round seen ≈ the host's slot count
        self.shed_total = 0

    def pending(self) -> int:
        return len(self._backlog)

    def note_prefill(self, seconds: float) -> None:
        self._prefill_est += self.ema * (seconds - self._prefill_est)

    def note_step(self, seconds: float, n_active: int) -> None:
        self._step_est += self.ema * (seconds - self._step_est)

    def _deadline_t(self, req: Request) -> Optional[float]:
        if req.deadline_s is not None:
            return req.submitted_t + req.deadline_s
        if self.default_deadline_s is not None:
            return req.submitted_t + self.default_deadline_s
        return None

    def select(self, queue: RequestQueue, free: int, now: float, validate):
        drop: list[tuple[Request, str, str]] = []
        self._slots = max(self._slots, free)
        # drain arrivals into the backlog, validating on entry
        while True:
            req = queue.pop()
            if req is None:
                break
            err = validate(req)
            if err is not None:
                drop.append((req, "rejected", err))
                continue
            self._backlog.append(req)

        def rank(r: Request):
            dt = self._deadline_t(r)
            return (-r.priority, dt if dt is not None else float("inf"), r.rid)

        self._backlog.sort(key=rank)
        kept: list[Request] = []
        for r in self._backlog:
            dt = self._deadline_t(r)
            if dt is not None:
                # mid-decode rounds (free == 0) wait one more wave
                waves = len(kept) // self._slots + (1 if free == 0 else 0)
                projected = now + self._prefill_est + (1 + waves) * r.n_steps * self._step_est
                if projected > dt:
                    self.shed_total += 1
                    drop.append((r, "shed", (
                        f"shed: projected finish +{projected - r.submitted_t:.3f}s "
                        f"exceeds deadline {dt - r.submitted_t:.3f}s "
                        f"(backlog={len(self._backlog)}, step_est={self._step_est * 1e3:.2f}ms)")))
                    continue
            kept.append(r)
        admit, self._backlog = kept[:free], kept[free:]
        return admit, drop


@dataclass
class SchedulerStats:
    """Loop accounting (per-request numbers live on each ``Request.stats``;
    the union fault and the batched decode are shared by the step)."""

    steps: int = 0          # batched decode steps executed
    admitted: int = 0
    rejected: int = 0
    shed: int = 0           # SLO-policy drops (never under FIFO)
    completed: int = 0
    failed: int = 0         # admitted requests killed by a failed prefill or decode step
    decode_s: float = 0.0
    fault_s: float = 0.0
    faulted_units: int = 0
    faulted_bytes: int = 0
    decode_retries: int = 0
    max_active: int = 0     # high-water concurrent slots
    # KV positions the dense masked decode streams (max_batch × max_seq a
    # step) against what a paged layout would (the active slots' pages)
    kv_tokens_dense: int = 0
    kv_tokens_paged: int = 0
    kv_pages_high_water: int = 0

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class ContinuousBatchingScheduler:
    """Slot-based continuous batching over ``GenerationEngine`` primitives.

    Single consumer: one thread drives ``step()`` / ``run()``; any thread may
    ``submit()``. The slot arrays and stats belong to the loop's thread; the
    decode caches belong to the masked-decode entry, which the loop alone
    writes."""

    def __init__(self, engine: GenerationEngine, *, max_batch: int = 4,
                 queue: Optional[RequestQueue] = None, admission: Optional[AdmissionPolicy] = None,
                 kv_page_size: Optional[int] = None, kv_pages: Optional[int] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if engine.server.sharded:
            # its slot grafts and greedy ids read whole caches and logits, and
            # each rank would admit on its own clock
            raise ValueError("the scheduler serves no server that computes on shards (a multi-rank mesh)")
        self.engine = engine
        self.server = engine.server
        self.model = engine.model
        self.max_batch = max_batch
        self.queue = queue if queue is not None else RequestQueue()
        # each of the policy and the pool's shape: the keyword argument, else
        # the server's default (cold_start(admission=, kv_page_size=,
        # kv_pages=)), else FIFO and a pool of exactly max_batch × max_seq
        # positions, where exhaustion is impossible
        self.admission = (admission if admission is not None
                          else getattr(self.server, "admission", None) or FIFOAdmission())
        ps = kv_page_size or getattr(self.server, "kv_page_size", None) or 16
        per_slot = -(-engine.max_seq // ps)
        n_pages = kv_pages or getattr(self.server, "kv_pages", None) or max_batch * per_slot
        self.page_pool = PagePool(n_pages, ps, max_batch)
        self.stats = SchedulerStats()
        self._slots: list[Optional[Request]] = [None] * max_batch
        self._pos = np.zeros(max_batch, np.int64)       # next decode position
        self._last_tok = np.zeros(max_batch, np.int64)  # token feeding the next step

    @property
    def _decode(self):
        """The masked-decode entry; made (on the card: captured) at first use."""
        return self.server.compiled_decode_masked(self.max_batch, self.engine.max_seq)

    def warm_compile(self) -> None:
        """Make the masked decode at the slot batch shape now, so the first
        traffic step serves instead of capturing (admission prefills are
        still made per group shape on first use)."""
        self._decode

    # -- submission ------------------------------------------------------------
    def submit(self, tokens, n_steps: int) -> Request:
        """Enqueue one prompt. Decoding is greedy (argmax)."""
        return self.queue.submit(tokens, n_steps)

    @property
    def _tracing(self) -> bool:
        """True when a live AccessTrace would record request attribution."""
        tiered = self.server.tiered
        return tiered is not None and tiered.trace is not None

    @property
    def active(self) -> list[int]:
        return [i for i, r in enumerate(self._slots) if r is not None]

    @property
    def idle(self) -> bool:
        # the policy's backlog is outstanding work too
        return not self.active and len(self.queue) == 0 and self.admission.pending() == 0

    def _validate(self, req: Request) -> Optional[str]:
        S = int(req.tokens.size)
        if S == 0 or S + req.n_steps > self.engine.max_seq or req.n_steps < 1:
            return (f"rejected: prompt {S} + {req.n_steps} steps exceeds "
                    f"max_seq={self.engine.max_seq} (or is empty)")
        return None

    # -- admission ---------------------------------------------------------------
    def _admit(self) -> int:
        """Fill free slots per the admission policy. Same-length prompts of a
        round share one prefill; its cache rows are written into the slots.
        Returns the number of requests admitted."""
        free = [i for i, r in enumerate(self._slots) if r is None]
        to_admit, dropped = self.admission.select(self.queue, len(free), time.perf_counter(), self._validate)
        for req, kind, err in dropped:
            if kind == "shed":
                self.stats.shed += 1
            else:
                self.stats.rejected += 1
            req.finish(error=err)
        picked = [(free[i], req) for i, req in enumerate(to_admit[: len(free)])]
        # each request owns the pages its prompt + n_steps positions need
        # before any prefill is spent on it; exhaustion rejects it
        granted: list[tuple[int, Request]] = []
        for slot, req in picked:
            need = int(req.tokens.size) + req.n_steps
            if not self.page_pool.alloc(slot, need):
                self.stats.rejected += 1
                req.finish(error=(f"rejected: kv page pool exhausted "
                                  f"(need {self.page_pool.pages_for(need)} pages, "
                                  f"{self.page_pool.free_pages} free of {self.page_pool.n_pages})"))
                continue
            granted.append((slot, req))

        admitted = 0
        hints: list[list[str]] = []
        observed: list[str] = []
        by_request: dict[int, list[str]] = {}
        # everything granted is admitted this round, so grouping by length
        # reorders no one past anyone else
        groups: dict[int, list[tuple[int, Request]]] = {}
        for slot, req in granted:
            groups.setdefault(req.tokens.size, []).append((slot, req))
        slot_caches = self._decode.caches if groups else None
        for S, grp in groups.items():
            reqs = [r for _, r in grp]
            now = time.perf_counter()
            for r in reqs:
                r.admitted_t = now
            shared = RequestStats()
            try:
                toks = torch.from_numpy(np.stack([r.tokens for r in reqs]).astype(np.int64)).to(
                    self.server.device)
                logits, caches, expert_keys = self.engine.prefill_step(toks, shared, hint=False)
            except Exception as e:
                # a failed fault-in must not kill the loop or leave the
                # submitters waiting: fail the group, return its slots
                self.stats.failed += len(reqs)
                for s, r in grp:
                    self.page_pool.free(s)
                    r.finish(error=f"prefill failed: {e!r}")
                continue
            self.admission.note_prefill(shared.prefill_s + shared.fault_s)
            # read the prefill's outputs before the next replay rewrites them
            _graft_slot_cache(slot_caches, caches, [s for s, _ in grp])
            lg = logits.float().cpu().numpy()
            if self._tracing:
                # each prompt's own row groups; experts are exact only when
                # the prefill was not shared
                for r in reqs:
                    by_request[r.rid] = self.engine.row_keys_for(r.tokens) + (
                        list(expert_keys) if len(reqs) == 1 else [])
            for i, (slot, req) in enumerate(grp):
                # group costs are shared: every member waited out the batch
                req.stats.prefill_s += shared.prefill_s
                req.stats.fault_s += shared.fault_s
                req.stats.prefill_runs += shared.prefill_runs
                req.stats.prefill_retries += shared.prefill_retries
                req.stats.faulted_units += shared.faulted_units
                req.stats.faulted_bytes += shared.faulted_bytes
                tok = int(lg[i].argmax())
                req.out.append(tok)
                req.stats.steps = 1  # the prefill-produced token
                req.first_token_t = time.perf_counter()
                self._pos[slot] = S
                self._last_tok[slot] = tok
                self._slots[slot] = req
                self.stats.admitted += 1
                admitted += 1
                hints.append(self.engine.topk_row_hints(lg[i]))
                if len(req.out) >= req.n_steps:  # single-token request
                    self._retire(slot)
            if expert_keys:
                hints.append(list(expert_keys))
            observed += self.engine.row_keys_for(np.concatenate([r.tokens for r in reqs])) + list(expert_keys)
        self._emit_hints(hints, observed=observed, by_request=by_request)
        return admitted

    def _retire(self, slot: int) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        self._last_tok[slot] = 0
        self._pos[slot] = 0
        self.page_pool.free(slot)  # pages return at retire, ready for reuse
        self.stats.completed += 1
        req.finish()

    def _emit_hints(self, per_slot_hints: list[list[str]], observed: list[str] = (),
                    by_request: Optional[dict] = None) -> None:
        """Feed the prefetcher (the units this step accessed, then the
        round-robin-merged per-slot next-step hints) and tag the live trace
        with per-request attribution (``by_request``: rid → the keys that
        request accessed). Requests that finished this step are recorded
        first, then their chain state is dropped."""
        if by_request:
            tiered = self.server.tiered
            if tiered is not None:
                live = {r.rid for r in self._slots if r is not None}
                for rid, keys in by_request.items():
                    if keys:
                        tiered.record_request(rid, keys)
                    if rid not in live:
                        tiered.end_request(rid)
        pf = self.engine.prefetcher
        if pf is None:
            return
        if observed:
            pf.observe(observed)
        merged = merge_hints(*per_slot_hints)
        if merged:
            pf.hint(merged)

    # -- the serving loop --------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> bool:
        """Admit new work, then advance every active slot one token with a
        single masked decode over the union of their faults. Returns True if
        anything happened (admission or decode)."""
        admitted = self._admit()
        active = self.active
        self.stats.max_active = max(self.stats.max_active, len(active))
        if not active:
            # still a step boundary: the re-tiering daemon may tick on its
            # wall-clock cadence while the queue is drained
            self.engine.tick_retier(steps=0)
            return admitted > 0

        device = self.server.device
        mask = np.zeros(self.max_batch, bool)
        mask[active] = True
        dbatch = {
            "tokens": torch.from_numpy(self._last_tok[:, None].copy()).to(device),
            "pos": torch.from_numpy(self._pos.copy()).to(device),
            "active": torch.from_numpy(mask).to(device),
        }
        step_stats = RequestStats()
        decode = self._decode
        try:
            logits, _, expert_keys = self.engine.decode_once(
                decode, decode.caches, dbatch, step_stats,
                prefault_tokens=self._last_tok[active], hint=False)
            lg = logits.float().cpu().numpy()
        except Exception as e:
            # a failed step fault-in must not kill the loop or leave the
            # active slots' submitters waiting: fail them, keep serving
            self.stats.failed += len(active)
            tiered = self.server.tiered
            for i in active:
                req = self._slots[i]
                self._slots[i] = None
                self._last_tok[i] = 0
                self._pos[i] = 0
                self.page_pool.free(i)  # failed slots leak no pages
                if tiered is not None:
                    tiered.end_request(req.rid)  # never reaches _emit_hints
                req.finish(error=f"decode step failed: {e!r}")
            return True
        self.stats.decode_s += step_stats.decode_s
        self.stats.fault_s += step_stats.fault_s
        self.stats.faulted_units += step_stats.faulted_units
        self.stats.faulted_bytes += step_stats.faulted_bytes
        self.stats.decode_retries += step_stats.decode_retries
        self.stats.steps += 1
        self.admission.note_step(step_stats.decode_s + step_stats.fault_s, len(active))
        # the masked decode streams the whole (max_batch, max_seq) cache; a
        # paged layout would stream only the active slots' occupied pages
        self.stats.kv_tokens_dense += self.max_batch * self.engine.max_seq
        self.stats.kv_tokens_paged += self.page_pool.step_kv_positions(
            {i: int(self._pos[i]) + 1 for i in active})
        self.stats.kv_pages_high_water = self.page_pool.stats.high_water_pages

        # units this step demand-accessed: the active slots' row groups and
        # every routed expert (resident ones included)
        observed = self.engine.row_keys_for(self._last_tok[active]) + list(expert_keys)
        # per-request attribution, before the token updates below; experts
        # are exact only with a single active slot
        by_request = {
            self._slots[i].rid: self.engine.row_keys_for(self._last_tok[i:i + 1]) + (
                list(expert_keys) if len(active) == 1 else [])
            for i in active
        } if self._tracing else {}

        hints: list[list[str]] = []
        for i in active:
            req = self._slots[i]
            tok = int(lg[i].argmax())
            req.out.append(tok)
            req.stats.steps += 1
            self._last_tok[i] = tok
            self._pos[i] += 1
            if len(req.out) >= req.n_steps:
                self._retire(i)
            else:
                hints.append(self.engine.topk_row_hints(lg[i]))
        if expert_keys:
            hints.append(list(expert_keys))
        self._emit_hints(hints, observed=observed, by_request=by_request)
        # the step is over (pins released, outputs read): the one place the
        # serving loop advances the re-tiering daemon
        self.engine.tick_retier()
        return True

    def run(self, *, max_steps: Optional[int] = None) -> None:
        """Drive the loop until the queue is empty and every slot is free (or
        ``max_steps`` steps have run)."""
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break

    def serve_forever(self, stop: threading.Event, poll_s: float = 0.002) -> None:
        """Loop until ``stop`` is set, sleeping briefly when idle (the
        launcher's traffic mode runs it on its own thread)."""
        while not stop.is_set():
            if not self.step():
                time.sleep(poll_s)


def _graft_slot_cache(big: Any, small: Any, slots: list[int]) -> Any:
    """Write an admission group's prefill caches (batch k) into rows
    ``slots`` of the decode caches ``big``, in place; returns ``big``.

    Each slot row is rebuilt as zeros (``Model.init_cache``) with the prefill
    prefix written along the sequence axis (carry-state leaves, conv and
    LRU, and caches of the row's own shape are copied whole), the sequential
    path's ``_graft_prefill_cache`` applied per row. Scanned-group leaves are
    (n_groups, B, ...): batch is axis 1 there, axis 0 everywhere else."""
    big_flat = dict(flatten_with_paths(big))
    for path, s in flatten_with_paths(small):
        b = big_flat[path]
        ax = 1 if path.startswith("groups.") else 0
        for i, slot in enumerate(slots):
            graft_prefix(b.select(ax, slot), s.select(ax, i))
    return big

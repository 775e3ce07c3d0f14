"""Batched generation engine with on-demand fault-in — the request path
(``repro.serving.engine`` counterpart).

Execution never fails on a cold unit; it faults. Two fault classes:

  * vocab rows — exact pre-fault: the ids a step will embed are known
    before it runs, so their row-groups are ensured first;
  * routed experts — read from the step's router-usage masks (riding the
    cache tree); a miss faults the expert units in and re-runs the step,
    up to ``MAX_FAULT_RETRIES`` times, because routing can shift once real
    weights replace placeholders.

With a prefetcher attached the engine also emits access hints after each
step so the next step's units load off the request path: the row groups of
the top-k candidate tokens of the step's logits, and the experts the step
routed to (the strongest predictor of the next step's routing).

Every step's units are pinned for the duration of the step, so a device
budget can never zero a unit between its fault-in and the compute that
needs it. Each forward run holds the tiered params' gate from launch until
its outputs are on the device and its misses are read (``_run``), so a
prefetch install lands wholly before or after a run. The reference reads
the misses after the run with no such gate, so a prefetch that commits in
between makes a run computed on placeholder zeros look complete there.

The monolithic servers (before/after1) have no tiered params: nothing
faults and nothing is hinted.

On a server that computes on shards (``ColdStartServer.sharded``: a
multi-rank mesh, a family with a sharded forward) an entry's logits are the
rank's (rows, vocab rows) block and its caches the rank's blocks: greedy ids
come from ``server.next_tokens`` (the argmax across ranks), the prefill's
caches reach the decode caches through ``server.graft_prefill``, and the
usage masks are the global ones, the same on every rank, so every rank
faults the same experts and ``TieredParams.missing`` sees the same keys.

Every forward run goes through the server's compiled entries
(``ColdStartServer.compiled_prefill`` / ``compiled_decode``): CUDA graphs
replayed on the card, the plain model calls on the CPU. A decode step writes
its K/V rows into the decode entry's caches in place, which a re-run after a
fault rewrites; its new carry state (conv, LRU) comes back separately and is
committed into the caches once the step has reached its fixed point
(``commit_decode_caches``).

With an online re-tiering daemon on the server, ``generate()`` ticks it
(``tick_retier``) after the prefill and after each decode step: between
steps, with the step's pins released and no forward run holding the gate.
A tick's installs and evictions are in place, so the next graph replay
reads them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.serving.cold_start import ColdStartServer, _synchronize
from repro_torch.utils.tree import flatten_with_paths

MAX_FAULT_RETRIES = 3


@dataclass
class RequestStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    fault_s: float = 0.0
    prefill_runs: int = 0    # prefill forward passes, retries included
    prefill_retries: int = 0
    decode_retries: int = 0
    faulted_bytes: int = 0
    faulted_units: int = 0
    steps: int = 0
    prefetch_hits: int = 0   # demand touches served by the prefetcher
    hinted_units: int = 0    # hints this request emitted (accepted)


def _strip_usage(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _strip_usage(v) for k, v in tree.items() if k != "moe_usage"}
    return tree


def _usage_masks(caches: Any) -> dict[str, np.ndarray]:
    return {p: v.cpu().numpy() for p, v in flatten_with_paths(caches) if p.endswith("moe_usage")}


def graft_prefix(big: torch.Tensor, small: torch.Tensor) -> None:
    """Write ``small`` into ``big`` in place: whole where the shapes are
    equal, else as a prefix of zeros. A prefix longer than ``big`` (a prompt
    longer than a rolling window cache) raises ValueError, as the reference's
    graft does: neither package serves such a prompt."""
    if big.shape == small.shape:
        big.copy_(small)
        return
    if any(s > b for s, b in zip(small.shape, big.shape)):
        raise ValueError(f"a prefill cache of shape {tuple(small.shape)} does not fit the decode cache "
                         f"{tuple(big.shape)}: the prompt is longer than a rolling window")
    big.zero_()
    big[tuple(slice(0, d) for d in small.shape)] = small


def _graft_prefill_cache(big: Any, small: Any) -> Any:
    """Rebuild the max-length decode caches ``big`` in place as zeros with
    the prefill-sized K/V prefixes of ``small`` written in (carry states and
    caches of equal shape copied whole); returns ``big``. ``small`` may be a
    graph's static outputs, so it is copied, never kept."""
    if isinstance(big, dict):
        for k in big:
            _graft_prefill_cache(big[k], small[k])
        return big
    graft_prefix(big, small)
    return big


def commit_decode_caches(caches: Any, new_caches: Any) -> Any:
    """Commit a final decode step: copy every leaf of ``new_caches`` that is
    not ``caches``' own tensor (a rec block's new conv and LRU state; K/V
    were written in place) into ``caches``. Returns ``caches``."""
    new = dict(flatten_with_paths(_strip_usage(new_caches)))
    for path, leaf in flatten_with_paths(caches):
        if new[path] is not leaf:
            leaf.copy_(new[path])
    return caches


class GenerationEngine:
    def __init__(self, server: ColdStartServer, *, max_seq: int = 256, hint_topk: int = 8):
        self.server = server
        self.model = server.model
        self.max_seq = max_seq
        self.hint_topk = hint_topk
        self.prefetcher = server.prefetcher
        self.retier_daemon = server.retier_daemon
        self._expert_units_index = self._build_expert_index()
        self._row_group = self._embed_row_group()

    def tick_retier(self, steps: int = 1) -> None:
        """Advance the online re-tiering daemon by ``steps`` serving steps.
        Called between steps only: ``generate()`` after its prefill and after
        each decode step, the scheduler at its own ``step()`` boundary (never
        from ``prefill_step`` / ``decode_once``, which run inside a step)."""
        if self.retier_daemon is not None:
            self.retier_daemon.maybe_tick(steps)

    def _embed_row_group(self) -> int:
        tiered = self.server.tiered
        if tiered is None:
            return 0
        dec = tiered.plan.decisions.get("embed")
        if dec is None or dec.tier != 1 or dec.granularity != "rows":
            return 0
        return dec.units[0].rows[1] - dec.units[0].rows[0]

    # -- expert usage → unit keys --------------------------------------------
    def _build_expert_index(self) -> dict[str, list[str]]:
        """usage path ("groups.u0.moe_usage") -> expert-table param paths."""
        tiered = self.server.tiered
        if tiered is None:
            return {}
        idx: dict[str, list[str]] = {}
        for path, dec in tiered.plan.decisions.items():
            if dec.granularity == "expert" and dec.tier == 1:
                prefix = path.rsplit(".moe.", 1)[0]
                idx.setdefault(f"{prefix}.moe_usage", []).append(path)
        return idx

    def _expert_keys_from_usage(self, usage: dict[str, np.ndarray]) -> list[str]:
        """Every expert unit the step's router selected, resident ones included."""
        keys: list[str] = []
        for upath, mask in usage.items():
            for table in self._expert_units_index.get(upath, ()):
                for l, e in zip(*np.nonzero(mask)):  # stacked: (n_groups, E)
                    keys.append(f"{table}#l{l}e{e}")
        return keys

    # -- faults ----------------------------------------------------------------
    def row_keys_for(self, tokens: np.ndarray) -> list[str]:
        """Embed row-group unit keys the given token ids live in."""
        if not self._row_group:
            return []
        return [f"embed#rg{g}" for g in np.unique(np.asarray(tokens) // self._row_group)]

    def _prefault_rows(self, tokens: np.ndarray, stats: RequestStats, pins: list) -> list[str]:
        """Ensure (and pin) the row-groups this step will embed; keys join
        ``pins`` before the load so the caller's release covers a failure.
        Returns the accessed keys."""
        tiered = self.server.tiered
        needed = self.row_keys_for(tokens)
        if tiered is None or not needed:
            return []
        n_cold = sum(1 for k in needed if not tiered.is_resident(k))
        pins.extend(needed)
        t0 = time.perf_counter()
        stats.faulted_bytes += tiered.ensure(needed, pin=True)
        stats.fault_s += time.perf_counter() - t0
        stats.faulted_units += n_cold  # incl. waits on in-flight prefetch
        return needed

    def _run(self, fn, *args) -> tuple:
        """One forward run ``fn(params, *args)``. Returns ``(logits, caches,
        newly, used)``: ``used`` every expert the run routed to, ``newly``
        those that were not resident while it ran. Under tiered params the
        gate is held from launch until the outputs are on the device and
        ``newly`` is read, so no prefetch install or eviction lands inside
        the run or between it and its miss check."""
        tiered = self.server.tiered
        if tiered is None:
            logits, caches = fn(self.server.params, *args)
            return logits, caches, [], []
        with tiered.gate:
            logits, caches = fn(tiered.tree(), *args)
            _synchronize(logits.device)
            used = self._expert_keys_from_usage(_usage_masks(caches))
            newly = tiered.missing(used)
        return logits, caches, newly, used

    def _fault_experts(self, newly: list[str], used: list[str], stats: RequestStats, pins: list) -> None:
        """Ensure (and pin) every expert the last run routed to (``used``,
        from ``_run``), resident ones included: their pins block mid-step
        eviction. A retry is needed while ``newly`` is non-empty. Never
        called with the gate held: the ensure may wait on a unit the
        prefetcher is installing."""
        if not used:
            return
        pins.extend(used)
        t0 = time.perf_counter()
        stats.faulted_bytes += self.server.tiered.ensure(used, pin=True)
        stats.fault_s += time.perf_counter() - t0
        stats.faulted_units += len(newly)

    # -- hint emission ---------------------------------------------------------
    def topk_row_hints(self, logits) -> list[str]:
        """Embed row-group keys for the top-k candidate tokens of ``logits``
        ((V,), (B, V), …): the vocab half of a predictive hint."""
        if not self._row_group:
            return []
        flat = torch.as_tensor(logits).detach().float().cpu().numpy()
        flat = flat.reshape(-1, flat.shape[-1])
        k = min(self.hint_topk, flat.shape[-1])
        top = np.argpartition(-flat, k - 1, axis=-1)[:, :k]
        return [f"embed#rg{g}" for g in np.unique(top // self._row_group)]

    def _hint_next_step(self, logits, expert_keys: list[str], stats: RequestStats,
                        accessed: list[str] = (), B: int = 0) -> None:
        """Warm the units the next step will likely touch: the learned
        successors of what this step accessed (with a predictor), then the
        row groups of the top-k candidate tokens and this step's experts.
        On a sharded server the logits are a rank's block: the top-k reads
        the whole (B, V), gathered first."""
        if self.prefetcher is None:
            return
        if accessed:
            stats.hinted_units += self.prefetcher.observe(accessed)
        hints = list(expert_keys) + self.topk_row_hints(self.server.whole_logits(logits, B))
        if hints:
            stats.hinted_units += self.prefetcher.hint(hints)

    # -- step primitives (shared by generate() and the scheduler) ---------------
    def prefill_step(self, tokens: torch.Tensor, stats: RequestStats, *, hint: bool = True):
        """Prefill one prompt batch under the fault-in contract through the
        compiled (B, S) entry. Returns ``(logits, caches, expert_keys)``:
        caches with the usage masks stripped, and the experts the step routed
        to. On the card the logits and caches are the graph's static outputs,
        valid until the server's next replay."""
        tiered = self.server.tiered
        prefill = self.server.compiled_prefill(*tokens.shape)
        step_pins: list[str] = []
        expert_keys: list[str] = []
        accessed: list[str] = []
        if tiered is not None:
            tiered.set_phase("prefill")
        batch = {"tokens": tokens}
        try:
            accessed += self._prefault_rows(tokens.cpu().numpy(), stats, step_pins)
            fault0 = stats.fault_s
            t0 = time.perf_counter()
            logits, caches, newly, used = self._run(prefill, batch)
            stats.prefill_runs += 1
            for _ in range(MAX_FAULT_RETRIES):
                self._fault_experts(newly, used, stats, step_pins)
                seen = set(expert_keys)
                expert_keys.extend(k for k in used if k not in seen)
                if not newly:
                    break
                stats.prefill_retries += 1
                logits, caches, newly, used = self._run(prefill, batch)
                stats.prefill_runs += 1
            stats.prefill_s += time.perf_counter() - t0 - (stats.fault_s - fault0)
        finally:
            if tiered is not None and step_pins:
                tiered.release(step_pins)
        # hint after release: evicted or still-cold predictions are loadable now
        if hint:
            self._hint_next_step(logits, expert_keys, stats, accessed=accessed + expert_keys, B=tokens.shape[0])
        return logits, _strip_usage(caches), expert_keys

    def decode_once(self, decode_fn, caches: Any, dbatch: dict, stats: RequestStats, *,
                    prefault_tokens: Optional[np.ndarray] = None, hint: bool = True):
        """One decode step of the compiled entry ``decode_fn`` over its own
        ``caches`` under the fault-in contract. ``prefault_tokens`` defaults to
        the batch tokens; the scheduler passes only the active slots' tokens so
        free slots never fault vocab rows. A retry after an expert fault
        re-runs the step from the same caches (its K/V row writes are
        idempotent and its carry state goes to separate outputs); the final
        run's state is then committed. Returns ``(logits, caches,
        expert_keys)``: ``caches`` itself, now holding the step."""
        tiered = self.server.tiered
        if prefault_tokens is None:
            prefault_tokens = dbatch["tokens"].cpu().numpy()
        step_pins: list[str] = []
        expert_keys: list[str] = []
        accessed: list[str] = []
        if tiered is not None:
            tiered.set_phase("decode")
        try:
            accessed += self._prefault_rows(np.asarray(prefault_tokens), stats, step_pins)
            fault0 = stats.fault_s
            t0 = time.perf_counter()
            logits, new_caches, newly, used = self._run(decode_fn, caches, dbatch)
            for _ in range(MAX_FAULT_RETRIES):
                self._fault_experts(newly, used, stats, step_pins)
                seen = set(expert_keys)
                expert_keys.extend(k for k in used if k not in seen)
                if not newly:
                    break
                stats.decode_retries += 1
                logits, new_caches, newly, used = self._run(decode_fn, caches, dbatch)
            commit_decode_caches(caches, new_caches)
            stats.decode_s += time.perf_counter() - t0 - (stats.fault_s - fault0)
        finally:
            if tiered is not None and step_pins:
                tiered.release(step_pins)
        if hint:
            self._hint_next_step(logits, expert_keys, stats, accessed=accessed + expert_keys,
                                 B=dbatch["tokens"].shape[0])
        return logits, caches, expert_keys

    # -- request path -----------------------------------------------------------
    @torch.inference_mode()
    def generate(self, tokens: torch.Tensor, n_steps: int) -> tuple[np.ndarray, RequestStats]:
        """Greedy generation: ``tokens`` (B, S) prompt on the server's device;
        returns ((B, n_steps) int32 token ids, stats)."""
        tiered = self.server.tiered
        stats = RequestStats()
        hits_before = tiered.stats.prefetch_hits + tiered.stats.prefetch_waits if tiered else 0
        B, S = tokens.shape
        if S + n_steps > self.max_seq:
            raise ValueError(
                f"request needs {S + n_steps} positions (prompt {S} + {n_steps} steps) "
                f"but the engine was built for max_seq={self.max_seq}")
        device = tokens.device
        decode = self.server.compiled_decode(B, self.max_seq)
        logits, caches, _ = self.prefill_step(tokens, stats)
        if self.server.sharded:
            caches = self.server.graft_prefill(decode, caches, B, S, self.max_seq)
        else:
            caches = _graft_prefill_cache(decode.caches, caches)
        out = [self.server.next_tokens(logits, B).to(torch.int32).cpu().numpy()]
        self.tick_retier()  # between steps, after the prefill's outputs are read
        stats.steps = 1  # the prefill-produced token is step #1
        for step in range(n_steps - 1):
            dbatch = {
                "tokens": torch.as_tensor(out[-1], dtype=torch.int64, device=device)[:, None],
                "pos": torch.full((B,), S + step, dtype=torch.int64, device=device),
            }
            logits, caches, _ = self.decode_once(decode, caches, dbatch, stats)
            out.append(self.server.next_tokens(logits, B).to(torch.int32).cpu().numpy())
            stats.steps += 1
            self.tick_retier()
        if tiered is not None:
            stats.prefetch_hits = tiered.stats.prefetch_hits + tiered.stats.prefetch_waits - hits_before
        return np.stack(out, axis=1), stats

"""Batched generation engine with on-demand fault-in — the request path
(``repro.serving.engine`` counterpart, without prefetch hints or the online
re-tiering tick).

Execution never fails on a cold unit; it faults. Two fault classes:

  * vocab rows — exact pre-fault: the ids a step will embed are known
    before it runs, so their row-groups are ensured first;
  * routed experts — read from the step's router-usage masks (riding the
    cache tree); a miss faults the expert units in and re-runs the step,
    up to ``MAX_FAULT_RETRIES`` times, because routing can shift once real
    weights replace placeholders.

Every step's units are pinned for the duration of the step, so a device
budget can never zero a unit between its fault-in and the compute that
needs it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

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


def _strip_usage(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _strip_usage(v) for k, v in tree.items() if k != "moe_usage"}
    return tree


def _usage_masks(caches: Any) -> dict[str, np.ndarray]:
    return {p: v.cpu().numpy() for p, v in flatten_with_paths(caches) if p.endswith("moe_usage")}


def _graft_prefill_cache(big: Any, small: Any) -> Any:
    """Write prefill-sized K/V prefixes into max-length zero caches."""
    if isinstance(big, dict):
        return {k: _graft_prefill_cache(big[k], small[k]) for k in big}
    if big.shape == small.shape:
        return small
    big[tuple(slice(0, d) for d in small.shape)] = small
    return big


class GenerationEngine:
    def __init__(self, server: ColdStartServer, *, max_seq: int = 256):
        self.server = server
        self.model = server.model
        self.max_seq = max_seq
        self._expert_units_index = self._build_expert_index()
        self._row_group = self._embed_row_group()

    def _embed_row_group(self) -> int:
        dec = self.server.tiered.plan.decisions.get("embed")
        if dec is None or dec.tier != 1 or dec.granularity != "rows":
            return 0
        return dec.units[0].rows[1] - dec.units[0].rows[0]

    # -- expert usage → unit keys --------------------------------------------
    def _build_expert_index(self) -> dict[str, list[str]]:
        """usage path ("groups.u0.moe_usage") -> expert-table param paths."""
        idx: dict[str, list[str]] = {}
        for path, dec in self.server.tiered.plan.decisions.items():
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

    def _prefault_rows(self, tokens: np.ndarray, stats: RequestStats, pins: list) -> None:
        """Ensure (and pin) the row-groups this step will embed; keys join
        ``pins`` before the load so the caller's release covers a failure."""
        tiered = self.server.tiered
        needed = self.row_keys_for(tokens)
        if not needed:
            return
        n_cold = sum(1 for k in needed if not tiered.is_resident(k))
        pins.extend(needed)
        t0 = time.perf_counter()
        stats.faulted_bytes += tiered.ensure(needed, pin=True)
        stats.fault_s += time.perf_counter() - t0
        stats.faulted_units += n_cold

    def _fault_experts(self, caches: Any, stats: RequestStats, pins: list) -> list[str]:
        """Ensure (and pin) every expert the last run routed to; returns the
        ones that were not resident (a retry is needed while non-empty)."""
        tiered = self.server.tiered
        used = self._expert_keys_from_usage(_usage_masks(caches))
        if not used:
            return []
        miss = [k for k in used if not tiered.is_resident(k)]
        pins.extend(used)
        t0 = time.perf_counter()
        stats.faulted_bytes += tiered.ensure(used, pin=True)
        stats.fault_s += time.perf_counter() - t0
        stats.faulted_units += len(miss)
        return miss

    # -- step primitives -------------------------------------------------------
    def prefill_step(self, tokens: torch.Tensor, stats: RequestStats):
        """Prefill one prompt batch under the fault-in contract. Returns
        ``(logits, caches)`` with the usage masks stripped."""
        server, tiered = self.server, self.server.tiered
        step_pins: list[str] = []
        tiered.set_phase("prefill")
        try:
            self._prefault_rows(tokens.cpu().numpy(), stats, step_pins)
            fault0 = stats.fault_s
            t0 = time.perf_counter()
            batch = {"tokens": tokens}
            logits, caches = self.model.prefill(server.live_params(), batch)
            stats.prefill_runs += 1
            for _ in range(MAX_FAULT_RETRIES):
                if not self._fault_experts(caches, stats, step_pins):
                    break
                stats.prefill_retries += 1
                logits, caches = self.model.prefill(server.live_params(), batch)
                stats.prefill_runs += 1
            _synchronize(logits.device)
            stats.prefill_s += time.perf_counter() - t0 - (stats.fault_s - fault0)
        finally:
            if step_pins:
                tiered.release(step_pins)
        return logits, _strip_usage(caches)

    def decode_once(self, caches: Any, dbatch: dict, stats: RequestStats):
        """One decode step under the fault-in contract. Returns
        ``(logits, new_caches)`` with the usage masks stripped."""
        server, tiered = self.server, self.server.tiered
        step_pins: list[str] = []
        tiered.set_phase("decode")
        try:
            self._prefault_rows(dbatch["tokens"].cpu().numpy(), stats, step_pins)
            fault0 = stats.fault_s
            t0 = time.perf_counter()
            logits, new_caches = self.model.decode_step(server.live_params(), caches, dbatch)
            for _ in range(MAX_FAULT_RETRIES):
                if not self._fault_experts(new_caches, stats, step_pins):
                    break
                stats.decode_retries += 1
                logits, new_caches = self.model.decode_step(server.live_params(), caches, dbatch)
            _synchronize(logits.device)
            stats.decode_s += time.perf_counter() - t0 - (stats.fault_s - fault0)
        finally:
            if step_pins:
                tiered.release(step_pins)
        return logits, _strip_usage(new_caches)

    # -- request path -----------------------------------------------------------
    @torch.inference_mode()
    def generate(self, tokens: torch.Tensor, n_steps: int) -> tuple[np.ndarray, RequestStats]:
        """Greedy generation: ``tokens`` (B, S) prompt on the server's device;
        returns ((B, n_steps) int32 token ids, stats)."""
        stats = RequestStats()
        B, S = tokens.shape
        if S + n_steps > self.max_seq:
            raise ValueError(
                f"request needs {S + n_steps} positions (prompt {S} + {n_steps} steps) "
                f"but the engine was built for max_seq={self.max_seq}")
        device = tokens.device
        logits, caches = self.prefill_step(tokens, stats)
        caches = _graft_prefill_cache(self.model.init_cache(B, self.max_seq, device=device), caches)
        out = [torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()]
        stats.steps = 1  # the prefill-produced token is step #1
        for step in range(n_steps - 1):
            dbatch = {
                "tokens": torch.as_tensor(out[-1], dtype=torch.int64, device=device)[:, None],
                "pos": torch.full((B,), S + step, dtype=torch.int64, device=device),
            }
            logits, caches = self.decode_once(caches, dbatch, stats)
            out.append(torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy())
            stats.steps += 1
        return np.stack(out, axis=1), stats

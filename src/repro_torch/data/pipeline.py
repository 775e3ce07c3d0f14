"""Deterministic synthetic token pipeline (``repro.data.pipeline``
counterpart, pure numpy): the same tokens and row-group stats as the
reference for the same config.

Batches come from a counter-based PRNG (Philox keyed by (seed, shard,
step)), so every (shard, step) pair gives the same bytes on every run and
shards never overlap. Tokens are Zipfian (s≈1.1, like natural text), with a
few document boundaries (EOS) spliced in at deterministic positions; the
offline ``vocab_row_stats`` of a few steps is the row-group hotness that the
stats residency policy preloads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_s: float = 1.1
    eos_id: int = 0
    mean_doc_len: int = 512


class SyntheticTokenPipeline:
    """{"tokens": (B, S) i32, "labels": (B, S) i32} batches by step.

    ``shard``/``num_shards`` split the batch dimension: each shard emits its
    (B/num_shards, S) slice. ``batch_at(step)`` is random access, and a
    resumed run iterates from its step (``iterate_from``).
    """

    def __init__(self, cfg: DataConfig, *, shard: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not split into {num_shards} shards")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        # Zipf CDF over the vocab (host-side, float64, computed once)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_s)
        self._cdf = np.cumsum(w) / np.sum(w)

    def _tokens(self, step: int) -> np.ndarray:
        """Deterministic (local_batch, S+1) token block for this shard."""
        cfg = self.cfg
        ss = np.random.SeedSequence([cfg.seed, self.shard, step])
        rng = np.random.Generator(np.random.Philox(ss))
        u = rng.random((self.local_batch, cfg.seq_len + 1))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        # packing: deterministic document boundaries → EOS tokens
        n_docs = max(1, cfg.seq_len // cfg.mean_doc_len)
        bounds = rng.integers(1, cfg.seq_len, size=(self.local_batch, n_docs))
        rows = np.repeat(np.arange(self.local_batch), n_docs)
        toks[rows, bounds.ravel()] = cfg.eos_id
        return toks

    def batch_at(self, step: int) -> dict:
        toks = self._tokens(step)
        return {
            "tokens": toks[:, :-1].copy(),
            "labels": toks[:, 1:].copy(),
        }

    def __iter__(self) -> Iterator[dict]:
        return self.iterate_from(0)

    def iterate_from(self, step: int) -> Iterator[dict]:
        """Batches from ``step`` on: a resumed run needs no cursor replay."""
        while True:
            yield self.batch_at(step)
            step += 1

    # -- offline stats (the paper's profiling of module-init functions) -----
    def vocab_row_stats(self, n_steps: int = 4, row_group: int = 2048) -> dict[str, float]:
        """Row-group hotness from a short offline profile — feeds the
        stats residency policy's hot vocab."""
        counts = np.zeros(int(np.ceil(self.cfg.vocab_size / row_group)))
        for s in range(n_steps):
            toks = self._tokens(s)
            groups, c = np.unique(toks // row_group, return_counts=True)
            counts[groups] += c
        total = counts.sum() or 1.0
        return {f"embed#rg{g}": float(c / total) for g, c in enumerate(counts)}

"""Paged KV-cache pool (``repro.serving.paged_kv`` counterpart).

The KV capacity of a layer is carved into fixed-size pages owned by a global
free list: a request is granted exactly the pages its ``prompt + n_steps``
positions need, holds them for its lifetime, and returns them when it
retires. ``models.attention.paged_gqa_decode`` then reads a slot's cache
through its row of ``page_table``, and the paged decode kernel visits only
the pages that hold admitted positions.

``PagePool`` is host bookkeeping only (page ids, no tensors) and
single-threaded. Exhaustion is an admission signal: ``alloc`` fails
atomically (no partial grant) and returns False.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PagePoolStats:
    allocs: int = 0            # successful per-request grants
    frees: int = 0             # per-request releases
    alloc_pages: int = 0       # pages handed out across all grants
    exhausted: int = 0         # failed grants (admission rejections)
    high_water_pages: int = 0  # peak concurrent pages in use

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class PagePool:
    """Fixed pool of ``n_pages`` KV pages of ``page_size`` token positions,
    granted per slot and freed wholesale."""

    def __init__(self, n_pages: int, page_size: int, n_slots: int):
        if n_pages < 1 or page_size < 1 or n_slots < 1:
            raise ValueError(
                f"PagePool needs positive sizes, got n_pages={n_pages} "
                f"page_size={page_size} n_slots={n_slots}"
            )
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.n_slots = int(n_slots)
        # LIFO free list: a just-freed slot's pages are the next grant
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._owned: dict[int, list[int]] = {}  # slot -> pages, logical order
        self.stats = PagePoolStats()

    def pages_for(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` positions (at least one)."""
        return max(1, -(-int(n_tokens) // self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def can_admit(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= len(self._free)

    def alloc(self, slot: int, n_tokens: int) -> bool:
        """Grant ``slot`` the pages ``n_tokens`` positions need. Atomic: on
        exhaustion nothing is granted and False returns. A slot must be
        freed before it is granted again."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already owns pages (free it first)")
        need = self.pages_for(n_tokens)
        if need > len(self._free):
            self.stats.exhausted += 1
            return False
        self._owned[slot] = [self._free.pop() for _ in range(need)]
        self.stats.allocs += 1
        self.stats.alloc_pages += need
        self.stats.high_water_pages = max(self.stats.high_water_pages, self.used_pages)
        return True

    def free(self, slot: int) -> int:
        """Return ``slot``'s pages to the free list (idempotent); returns the
        number of pages released."""
        pages = self._owned.pop(slot, None)
        if pages is None:
            return 0
        self._free.extend(reversed(pages))  # back on top, for the same LIFO reuse
        self.stats.frees += 1
        return len(pages)

    def owned(self, slot: int) -> list[int]:
        return list(self._owned.get(slot, ()))

    def page_table(self, np_max: int | None = None) -> np.ndarray:
        """(n_slots, np_max) int32 table: row s holds slot s's pages in
        logical order, tail-padded with its last page; 0 for empty slots."""
        if np_max is None:
            np_max = max(1, -(-self.n_pages // max(self.n_slots, 1)))
            np_max = max(np_max, max((len(p) for p in self._owned.values()), default=1))
        table = np.zeros((self.n_slots, np_max), np.int32)
        for slot, pages in self._owned.items():
            table[slot] = (pages + [pages[-1]] * np_max)[:np_max]
        return table

    def step_kv_positions(self, active_lens: dict[int, int]) -> int:
        """KV positions one paged decode step streams: per active slot, the
        whole pages that hold any of its first n positions."""
        total = 0
        for slot, n in active_lens.items():
            pages = self._owned.get(slot)
            n_pages = len(pages) if pages else self.pages_for(n)
            total += min(n_pages, self.pages_for(n)) * self.page_size
        return total

    def assert_consistent(self) -> None:
        """Every page is exactly once in the free list or in one grant."""
        seen = list(self._free) + [p for ps in self._owned.values() for p in ps]
        if sorted(seen) != list(range(self.n_pages)):
            raise AssertionError(
                f"page books corrupt: {len(self._free)} free + "
                f"{sum(len(p) for p in self._owned.values())} owned != {self.n_pages}"
            )

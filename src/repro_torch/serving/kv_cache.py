"""Paged KV cache for the serving engine.

The device memory is ONE fixed allocation — the model cache for
``slots`` rows at ``max_len`` tokens, created once when the engine
starts — organised as a pool of fixed-size *pages* (``page_size``
tokens each; slot ``s`` owns the contiguous physical page range
``[s·P, (s+1)·P)`` where ``P = max_len // page_size``). A host-side
:class:`PageTable` tracks which pages are live: pages are allocated
lazily as a request's sequence grows across page boundaries, and
released — returned to the pool and reused by later requests without
any reallocation or zeroing — when the request finishes or is evicted.

No zeroing is needed on reuse because stale keys are unreachable by
construction: decode attention masks every cache position beyond the
slot's current depth, and admission overwrites the whole slot row with
the new request's prefill dump. Decode appends into the pool in place.
"""
from __future__ import annotations

from typing import Optional


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` cache entries."""
    return max(0, -(-tokens // page_size))


class PageTable:
    """Host-side page accounting over the fixed device pool.

    Page ids are global: slot ``s``'s j-th page is ``s * pages_per_slot
    + j``. ``ensure`` grows a slot's allocation to cover a sequence
    length (lazy, page-at-a-time); ``release`` frees a slot's pages
    back to the pool. ``reused_pages`` counts allocations of a page
    that some earlier request already used and freed — the direct
    evidence of slot/page reuse after eviction.
    """

    def __init__(self, slots: int, pages_per_slot: int, page_size: int):
        self.slots = slots
        self.pages_per_slot = pages_per_slot
        self.page_size = page_size
        self.total_pages = slots * pages_per_slot
        self._used = [0] * slots          # live pages per slot
        self._freed: set[int] = set()     # page ids freed at least once
        self.reused_pages = 0
        self.allocations = 0

    def _page_id(self, slot: int, j: int) -> int:
        return slot * self.pages_per_slot + j

    def ensure(self, slot: int, tokens: int) -> list[int]:
        """Grow ``slot``'s allocation to cover ``tokens`` cache
        entries; returns the newly allocated page ids (empty when the
        current pages already cover it)."""
        need = pages_for(tokens, self.page_size)
        if need > self.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {tokens} tokens need {need} pages but a "
                f"slot holds {self.pages_per_slot} "
                f"(max_len {self.pages_per_slot * self.page_size})")
        new = []
        for j in range(self._used[slot], need):
            pid = self._page_id(slot, j)
            if pid in self._freed:
                self.reused_pages += 1
            self.allocations += 1
            new.append(pid)
        self._used[slot] = max(self._used[slot], need)
        return new

    def release(self, slot: int) -> list[int]:
        """Free all of ``slot``'s pages back to the pool."""
        freed = [self._page_id(slot, j)
                 for j in range(self._used[slot])]
        self._freed.update(freed)
        self._used[slot] = 0
        return freed

    def pages_used(self, slot: Optional[int] = None) -> int:
        if slot is not None:
            return self._used[slot]
        return sum(self._used)

    @property
    def free_pages(self) -> int:
        return self.total_pages - self.pages_used()

    def stats(self) -> dict:
        return {"total_pages": self.total_pages,
                "live_pages": self.pages_used(),
                "free_pages": self.free_pages,
                "allocations": self.allocations,
                "reused_pages": self.reused_pages}


class PagedKVCache:
    """The device cache pool + its page table + the slot-insert op.

    The table accounts for all ``config.slots`` slots; the device pool
    holds ``rows`` of them (a data row's block of the slots on a mesh;
    all by default), indexed from 0."""

    def __init__(self, model, params, config, extra=None,
                 rows: Optional[int] = None):
        self.table = PageTable(config.slots,
                               config.max_len // config.page_size,
                               config.page_size)
        self.cache = model.init_cache(
            params, config.slots if rows is None else rows,
            config.max_len, extra)

    def insert(self, prefill_cache: list, src: int, dst: int) -> None:
        """Copy batch row ``src`` of ``prefill_cache`` into slot ``dst``
        of the pool, in place: every tensor of every layer (``k``/``v``,
        and a vlm cross layer's ``ck``/``cv``), cast to the pool's
        dtype."""
        for big, small in zip(self.cache, prefill_cache):
            for name, pool in big.items():
                pool[dst].copy_(small[name][src])

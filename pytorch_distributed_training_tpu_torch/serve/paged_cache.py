"""Host-side page allocator for the paged KV cache (counterpart: the JAX
package's ``serve/paged_cache.py`` ``PageAllocator``).

The device side (``models/bert.py`` paged branch + ``ops/paged_attention``)
stores K/V in fixed-size pages addressed through a per-slot block table;
this module owns WHICH pages a slot holds:

- fixed page size, fixed pool, page ids handed out from a LIFO free list
  (recently freed pages are re-handed first);
- alloc on admit (the whole worst case, prompt bucket + max_new_tokens, up
  front, so a running request can never starve mid-decode), free on evict;
- page 0 is RESERVED as the null page: never allocated; idle slots park
  their whole block-table row on it and entries past a slot's pages point
  at it (reads are masked by length, writes by idle slots land there).

Shared pages (refcounts, copy-on-write) come with the prefix cache, which
is not ported yet. Called from the engine's single-threaded tick only.
"""

from __future__ import annotations

import numpy as np


class PageAllocator:
    """Free-list allocator over ``num_pages`` fixed-size KV pages.

    ``block_table`` is the [num_slots, pages_per_slot] int32 array handed
    to the device each tick; row ``slot`` lists that slot's pages in token
    order, null-padded with page 0.
    """

    def __init__(self, num_pages: int, page_size: int, pages_per_slot: int,
                 num_slots: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is reserved), got {num_pages}"
            )
        if pages_per_slot < 1:
            raise ValueError(
                f"pages_per_slot must be >= 1, got {pages_per_slot}"
            )
        self.num_pages = num_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.num_slots = num_slots
        self._free = list(range(num_pages - 1, 0, -1))
        self._owned: list[list[int]] = [[] for _ in range(num_slots)]
        self.block_table = np.zeros((num_slots, pages_per_slot), np.int32)
        self.peak_used = 0

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        # excludes the reserved null page
        return (self.num_pages - 1) - len(self._free)

    def pages_needed(self, total_tokens: int) -> int:
        """Pages covering ``total_tokens`` (prompt + worst-case new)."""
        return -(-max(total_tokens, 1) // self.page_size)

    def pages_reserved(self, total_tokens: int, spec_k: int = 0) -> int:
        """Admission reservation: ``pages_needed(total_tokens + spec_k)``
        (the speculative overshoot is 0 until speculation is ported)."""
        return self.pages_needed(total_tokens + max(spec_k, 0))

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def admit(self, slot: int, n: int) -> None:
        """Give ``slot`` ``n`` pages and fill its block-table row."""
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        if n > self.pages_per_slot:
            raise ValueError(
                f"request needs {n} pages but block-table rows hold "
                f"{self.pages_per_slot}"
            )
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, free {len(self._free)} "
                "(admission must check can_alloc first)"
            )
        pages = [self._free.pop() for _ in range(n)]
        self._owned[slot] = pages
        row = self.block_table[slot]
        row[:] = 0
        row[: len(pages)] = pages
        self.peak_used = max(self.peak_used, self.pages_used)

    def release(self, slot: int) -> None:
        """Return ``slot``'s pages to the free list (no-op when idle).
        Reverse order keeps the LIFO list handing the slot's first page
        first on the next admit."""
        self._free.extend(reversed(self._owned[slot]))
        self._owned[slot] = []
        self.block_table[slot][:] = 0

    def slot_pages(self, slot: int) -> tuple[int, ...]:
        return tuple(self._owned[slot])

"""Host-side page allocator for the paged KV cache (counterpart: the JAX
package's ``serve/paged_cache.py`` ``PageAllocator``).

The device side (``models/bert.py`` paged branch + ``ops/paged_attention``)
stores K/V in fixed-size pages addressed through a per-slot block table;
this module owns WHICH pages a slot holds:

- fixed page size, fixed pool, page ids handed out from a LIFO free list
  (recently freed pages are re-handed first);
- alloc on admit (the whole worst case, prompt bucket + max_new_tokens +
  the speculative overshoot, up front, so a running request can never
  starve mid-decode), free on evict;
- refcounted: a page may appear in several block-table rows at once (the
  prefix cache maps one immutable prompt-prefix run into many slots) and
  returns to the free list only when its count reaches zero; a writer
  never touches a page with refcount > 1, ``cow`` gives it a private copy;
- page 0 is RESERVED as the null page: never allocated; idle slots park
  their whole block-table row on it and entries past a slot's pages point
  at it (reads are masked by length, writes by idle slots land there).

Called from the engine's single-threaded tick only.
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
        # per-page refcount: 0 free, 1 sole holder (a slot or the prefix
        # cache), > 1 shared; page 0 stays at 0 and is never handed out
        self._ref = [0] * num_pages
        self.block_table = np.zeros((num_slots, pages_per_slot), np.int32)
        self.peak_used = 0

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        # excludes the reserved null page
        return (self.num_pages - 1) - len(self._free)

    @property
    def pages_shared(self) -> int:
        """Pages held by more than one holder (slots + prefix cache)."""
        return sum(1 for r in self._ref if r > 1)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def pages_needed(self, total_tokens: int) -> int:
        """Pages covering ``total_tokens`` (prompt + worst-case new)."""
        return -(-max(total_tokens, 1) // self.page_size)

    def pages_reserved(self, total_tokens: int, spec_k: int = 0) -> int:
        """Admission reservation with the speculative overshoot:
        ``pages_needed(total_tokens + spec_k)``. A verify tick launched one
        token before the emission cap scatters its pending token and k
        drafts before acceptance is known, so the highest position ever
        written is ``total_tokens + spec_k - 2``: covered. Rejected drafts
        stay in those pages as dead lanes (masked by the context length,
        overwritten on reuse), so rollback is a host-side cursor rewind."""
        return self.pages_needed(total_tokens + max(spec_k, 0))

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def _fill_row(self, slot: int, pages: list) -> None:
        self._owned[slot] = pages
        row = self.block_table[slot]
        row[:] = 0
        row[: len(pages)] = pages
        self.peak_used = max(self.peak_used, self.pages_used)

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
        self._fill_row(slot, [self._pop_free() for _ in range(n)])

    def admit_shared(self, slot: int, shared_pages: list,
                     n_private: int) -> None:
        """Admit ``slot`` on a prefix-cache hit: map ``shared_pages``
        (already written, refcount bumped, read-only for this slot) then
        ``n_private`` fresh pages for the prompt tail and decode."""
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        n = len(shared_pages) + n_private
        if n > self.pages_per_slot:
            raise ValueError(
                f"request needs {n} pages but block-table rows hold "
                f"{self.pages_per_slot}"
            )
        if n_private > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n_private}, free "
                f"{len(self._free)} (admission must check can_alloc first)"
            )
        for p in shared_pages:
            self.acquire(p)
        pages = list(shared_pages)
        pages.extend(self._pop_free() for _ in range(n_private))
        self._fill_row(slot, pages)

    def acquire(self, page: int) -> None:
        """Add a reference to an allocated page (sharing it)."""
        if page <= 0 or page >= self.num_pages:
            raise ValueError(f"page {page} out of range")
        if self._ref[page] == 0:
            raise RuntimeError(
                f"page {page} is free; acquire only shares live pages"
            )
        self._ref[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; the page frees only at refcount 0 (True
        when this call freed it). A double release raises: the freed id
        may already sit in another slot's row."""
        if self._ref[page] == 0:
            raise RuntimeError(f"double release of page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            return True
        return False

    def cow(self, slot: int, index: int) -> tuple[int, int]:
        """Copy-on-write: repoint ``slot``'s block-table entry ``index``
        from its shared page to a fresh private one. Bookkeeping only: the
        caller copies the page contents on the device (old and new page
        ids are returned for that) before the slot's next write."""
        old = self._owned[slot][index]
        if self._ref[old] <= 1:
            raise RuntimeError(
                f"cow on page {old} with refcount {self._ref[old]}; "
                "exclusively-held pages are written in place"
            )
        if not self._free:
            raise RuntimeError(
                "page pool exhausted: cow needs 1 free page "
                "(admission must reserve the private copy up front)"
            )
        new = self._pop_free()
        self._owned[slot][index] = new
        self.block_table[slot][index] = new
        self._ref[old] -= 1
        self.peak_used = max(self.peak_used, self.pages_used)
        return old, new

    def release(self, slot: int) -> None:
        """Drop ``slot``'s references (no-op when idle); pages free only
        at refcount 0. Reverse order keeps the LIFO list handing the
        slot's first page first on the next admit."""
        for page in reversed(self._owned[slot]):
            self.decref(page)
        self._owned[slot] = []
        self.block_table[slot][:] = 0

    def slot_pages(self, slot: int) -> tuple[int, ...]:
        return tuple(self._owned[slot])

    def _pop_free(self) -> int:
        page = self._free.pop()
        if self._ref[page] != 0:
            raise RuntimeError(f"free list held live page {page}")
        self._ref[page] = 1
        return page

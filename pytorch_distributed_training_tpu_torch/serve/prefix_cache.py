"""Shared-KV prefix cache: a token-keyed trie over immutable page runs
(counterpart: the JAX package's ``serve/prefix_cache.py``, pure Python,
kept here as the port's own copy).

Thousands of requests re-prefilling the *same* system prompt is the
dominant waste in multi-tenant serving; this module lets the engine serve
a shared prefix once. After a request's prompt has been fully prefilled,
its FULLY-WRITTEN pages (the first ``prompt_len // page_size`` entries of
its block-table row — every lane holds real K/V) are inserted into a trie
keyed by ``page_size``-token chunks. A later request walks the trie with
its own prompt: every matched node maps an existing page into the new
slot's block table (refcount bumped via ``PageAllocator.acquire``), and
prefill starts at the cached boundary instead of position 0.

Invariants that make this exact rather than approximate:

- only COMPLETE pages are cached, and a cached page is immutable: decode
  and verify write at positions ``>= prompt_len``, which land strictly
  after the full-page region, so a shared page is read-only by
  construction once inserted;
- a slot never writes into a page with refcount > 1. When the divergence
  point falls mid-page the engine takes the partially-matching cached page
  as a copy-on-write SOURCE (``match`` returns it separately), copies it
  on device into a private page, and repoints the block table before the
  tail prefill's first write;
- cached K/V is a pure function of (weights, prompt tokens). A weight
  swap must therefore call ``invalidate_all``: stale entries would be
  silently wrong, not just slow.

Eviction: the cache holds its own reference on every inserted page, so a
page with allocator refcount 1 is held ONLY by the cache and is safe to
drop. ``evict_until`` walks refcount-1 leaves in LRU order under page
pressure; ``evict_idle`` (brownout trigger) drops every such run. Neither
can touch a page an in-flight slot still references.

Single-threaded like the allocator: every method runs on the engine tick
loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from pytorch_distributed_training_tpu_torch.serve.paged_cache import (
    PageAllocator,
)


@dataclass
class _Node:
    """One cached page; children keyed by the NEXT page_size-token chunk."""

    page: int
    parent: Optional["_Node"]
    key: tuple[int, ...]
    children: dict[tuple[int, ...], "_Node"] = field(default_factory=dict)
    last_use: int = 0


@dataclass(frozen=True)
class PrefixMatch:
    """Result of a trie lookup.

    ``pages`` are the fully-matched shared pages in token order (the caller
    maps them read-only). ``cached_len`` counts matched tokens including
    the partial page; ``cow_src`` is the cached page covering tokens
    ``len(pages) * page_size .. cached_len`` when the divergence point is
    mid-page (None when the match ends exactly on a page boundary).
    """

    pages: tuple[int, ...]
    cached_len: int
    cow_src: Optional[int]

    @property
    def hit(self) -> bool:
        return self.cached_len > 0


class PrefixCache:
    """Trie of immutable KV page runs shared across requests and tenants."""

    def __init__(self, allocator: PageAllocator):
        self._alloc = allocator
        self._page_size = allocator.page_size
        self._root = _Node(page=0, parent=None, key=())
        self._nodes = 0
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.invalidations = 0

    @property
    def cached_pages(self) -> int:
        return self._nodes

    def match(self, tokens: list[int]) -> PrefixMatch:
        """Longest cached prefix of ``tokens``.

        Callers pass ``prompt[:-1]`` so the tail prefill always covers at
        least one token (the last prompt position must run to sample the
        first output token).
        """
        ps = self._page_size
        self._clock += 1
        node = self._root
        pages: list[int] = []
        i = 0
        while i + ps <= len(tokens):
            child = node.children.get(tuple(tokens[i : i + ps]))
            if child is None:
                break
            child.last_use = self._clock
            pages.append(child.page)
            node = child
            i += ps
        # Mid-page tail: the longest partial chunk match among this node's
        # children becomes the copy-on-write source.
        best_len, best_child = 0, None
        tail = tuple(tokens[i:])
        if tail:
            for key, child in node.children.items():
                n = 0
                for a, b in zip(key, tail):
                    if a != b:
                        break
                    n += 1
                if n > best_len:
                    best_len, best_child = n, child
        if best_child is not None:
            best_child.last_use = self._clock
        cached_len = i + best_len
        return PrefixMatch(
            pages=tuple(pages),
            cached_len=cached_len,
            cow_src=best_child.page if best_child is not None else None,
        )

    def note(self, hit: bool) -> None:
        """Count one ADMITTED lookup. Separate from ``match`` so a head
        re-matched every tick while blocked on pages/quota doesn't inflate
        the hit-rate denominator."""
        if hit:
            self.hits += 1
        else:
            self.misses += 1

    def insert(self, tokens: list[int], pages: tuple[int, ...]) -> int:
        """Index the fully-written page run covering ``tokens``.

        ``pages`` must hold real K/V for every lane (the engine passes the
        first ``len(tokens) // page_size`` row entries after prefill
        completed). First writer wins: an existing node keeps its page and
        the offered duplicate is simply not indexed — both hold identical
        K/V, so sharing either is exact. Returns nodes created.
        """
        ps = self._page_size
        full = len(tokens) // ps
        if full > len(pages):
            raise ValueError(
                f"{full} full pages of tokens but only {len(pages)} pages"
            )
        self._clock += 1
        node = self._root
        created = 0
        for j in range(full):
            key = tuple(tokens[j * ps : (j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                self._alloc.acquire(pages[j])
                child = _Node(page=pages[j], parent=node, key=key)
                node.children[key] = child
                self._nodes += 1
                created += 1
            child.last_use = self._clock
            node = child
        self.inserts += created
        return created

    def evict_until(self, pages_wanted: int,
                    protect: Optional[set] = None) -> int:
        """LRU-evict cache-only (refcount-1) runs until ``pages_wanted``
        pages have been freed or no evictable page remains. Leaf-first:
        dropping a leaf may expose its parent as the next candidate, so
        whole idle runs unwind back-to-front without ever orphaning an
        interior node. ``protect`` pins pages a just-computed match is
        about to map into a slot (they may still be refcount-1 here)."""
        freed = 0
        while freed < pages_wanted:
            victim = None
            for node in self._iter_nodes():
                if node.children or self._alloc.refcount(node.page) != 1:
                    continue
                if protect and node.page in protect:
                    continue
                if victim is None or node.last_use < victim.last_use:
                    victim = node
            if victim is None:
                break
            self._drop(victim)
            freed += 1
        return freed

    def evict_idle(self) -> int:
        """Drop EVERY cache-only page (brownout pressure trigger)."""
        freed = 0
        while True:
            victims = [
                n for n in self._iter_nodes()
                if not n.children and self._alloc.refcount(n.page) == 1
            ]
            if not victims:
                return freed
            for v in victims:
                self._drop(v)
                freed += 1

    def invalidate_all(self) -> int:
        """Forget every entry (weight swap: cached KV is now wrong).

        Pages still referenced by in-flight slots stay allocated until
        those slots release; they just become unreachable for future
        matches, so no post-swap stream can map a pre-swap page.
        """
        dropped = 0
        for node in list(self._iter_nodes()):
            self._alloc.decref(node.page)
            dropped += 1
        self._root.children.clear()
        self._nodes = 0
        self.evictions += dropped
        self.invalidations += 1
        return dropped

    def stats(self) -> dict:
        lookups = self.hits + self.misses
        return {
            "prefix_lookups": lookups,
            "prefix_hits": self.hits,
            "prefix_hit_rate": (self.hits / lookups) if lookups else 0.0,
            "prefix_inserts": self.inserts,
            "prefix_evictions": self.evictions,
            "prefix_invalidations": self.invalidations,
            "prefix_cached_pages": self._nodes,
        }

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _drop(self, node: _Node) -> None:
        if node.children:
            raise RuntimeError("evicting an interior node")
        del node.parent.children[node.key]
        self._alloc.decref(node.page)
        self._nodes -= 1
        self.evictions += 1

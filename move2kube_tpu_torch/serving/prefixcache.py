"""Refcounted prefix/prompt cache over the paged KV pool: the port's own
copy of ``move2kube_tpu/serving/fleet/prefixcache.py``, over the port's
:class:`~move2kube_tpu_torch.serving.kvcache.PageAllocator`.

The fleet's cheapest token is the one never prefilled: multi-tenant
serving traffic is dominated by shared prompt *prefixes* (system
prompts, few-shot preambles), and the paged KV cache already stores
K/V in position-aligned fixed-size pages — so two requests that agree
on their first ``k*block_size`` tokens can point their block tables at
the *same* pages. This module is the host-side index that makes that
sharing safe:

- a **trie** keyed on token chunks (one node per page; dict buckets
  hash the chunk tuples, the same prefix hash the router's session
  affinity uses) maps cached prefixes to immutable page runs;
- every cached page holds one **reference** in the
  :class:`~move2kube_tpu_torch.serving.kvcache.PageAllocator`, so a page
  outlives the sequence that prefilled it and is returned to the pool
  only when both the cache and every borrowing slot have dropped it;
- pages handed out by :meth:`PrefixCache.lookup` are *shared*
  (refcount > 1) and therefore **immutable** — a slot that must write
  into one (the partially-filled boundary page, or re-feeding the last
  prompt token of a fully-covered prompt) copy-on-writes it first
  (kvcache.copy_page), which the engine enforces.

Eviction is LRU over trie *leaves* (interior nodes are pinned by their
descendants — evicting a parent before its child would orphan the
child's positional prefix). Evicting a node drops the cache's
reference; the allocator reclaims the page once no slot borrows it.

Single-threaded by design: one cache belongs to one engine, and the
engine's admission loop is the only caller.
"""

from __future__ import annotations

import dataclasses

from move2kube_tpu_torch.serving.kvcache import PageAllocator


@dataclasses.dataclass
class PrefixHit:
    """A successful lookup. ``pages`` are the covering pages in block
    order — the allocator references for them are already taken on the
    caller's behalf (release with ``allocator.free`` when done, whether
    or not the hit is used)."""

    pages: list[int]
    covered: int  # tokens of K/V those pages hold


class _Node:
    __slots__ = ("chunk", "page", "children", "partials", "last_used")

    def __init__(self, chunk: tuple, page: int) -> None:
        self.chunk = chunk
        self.page = page
        self.children: dict[tuple, _Node] = {}
        # partially-filled boundary pages (< block_size tokens); always
        # leaves — a deeper full page can't stack on a partial one
        self.partials: list[_Node] = []
        self.last_used = 0

    def is_leaf(self) -> bool:
        return not self.children and not self.partials


class PrefixCache:
    def __init__(self, block_size: int, allocator: PageAllocator,
                 max_pages: int = 0) -> None:
        self.block_size = int(block_size)
        self.allocator = allocator
        self.max_pages = int(max_pages)  # 0 = bounded only by pool pressure
        self._root = _Node((), -1)
        self._clock = 0
        self._pages = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    # ------------------------------------------------------------------

    @property
    def total_pages(self) -> int:
        return self._pages

    def __len__(self) -> int:
        return self._pages

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, tokens) -> PrefixHit | None:
        """Longest cached prefix of ``tokens``. On a hit, takes one
        allocator reference per returned page (the pages cannot be
        evicted out from under the caller)."""
        tokens = list(tokens)
        bs = self.block_size
        now = self._tick()
        node, pages, covered = self._root, [], 0
        while covered + bs <= len(tokens):
            child = node.children.get(tuple(tokens[covered:covered + bs]))
            if child is None:
                break
            child.last_used = now
            pages.append(child.page)
            covered += bs
            node = child
        # longest partial boundary page that is a prefix of the remainder
        rest = tokens[covered:]
        best = None
        for part in node.partials:
            n = len(part.chunk)
            if n <= len(rest) and tuple(rest[:n]) == part.chunk:
                if best is None or n > len(best.chunk):
                    best = part
        if best is not None:
            best.last_used = now
            pages.append(best.page)
            covered += len(best.chunk)
        if not pages:
            self.misses += 1
            return None
        self.allocator.incref(pages)
        self.hits += 1
        self.hit_tokens += covered
        return PrefixHit(pages=list(pages), covered=covered)

    def insert(self, tokens, pages) -> int:
        """Adopt a freshly prefilled prompt's page run. ``pages`` are
        the covering pages in block order (``ceil(len(tokens)/bs)`` of
        them, last one partial when the length isn't page-aligned).
        Chunks already cached keep their existing page (the newcomer's
        duplicate stays private to its slot); new chunks incref the
        donor's page into the cache. Returns pages adopted."""
        tokens = list(tokens)
        bs = self.block_size
        now = self._tick()
        node, adopted, idx = self._root, 0, 0
        while (idx + 1) * bs <= len(tokens):
            chunk = tuple(tokens[idx * bs:(idx + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, int(pages[idx]))
                self.allocator.incref([child.page])
                node.children[chunk] = child
                adopted += 1
                self._pages += 1
            child.last_used = now
            node = child
            idx += 1
        rest = tuple(tokens[idx * bs:])
        if rest and idx < len(pages):
            if not any(p.chunk == rest for p in node.partials):
                part = _Node(rest, int(pages[idx]))
                self.allocator.incref([part.page])
                part.last_used = now
                node.partials.append(part)
                adopted += 1
                self._pages += 1
        self.inserted_pages += adopted
        if self.max_pages and self._pages > self.max_pages:
            self.evict(self._pages - self.max_pages)
        return adopted

    def evict(self, n_pages: int) -> int:
        """Drop LRU leaves until ``n_pages`` allocator pages were
        actually reclaimed (a dropped page still borrowed by a live
        slot frees later, so keep going) or the trie is empty.
        Returns the number of cache pages dropped."""
        before = self.allocator.available
        dropped = 0
        while self.allocator.available - before < n_pages and self._pages:
            victim, parent = self._lru_leaf()
            if victim is None:
                break
            self._drop(victim, parent)
            dropped += 1
        return dropped

    def clear(self) -> int:
        return self.evict(self._pages) if self._pages else 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "pages": self._pages,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "hit_tokens": self.hit_tokens,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
        }

    # ------------------------------------------------------------------

    def _lru_leaf(self) -> tuple[_Node | None, _Node | None]:
        best, best_parent = None, None
        stack = [self._root]
        while stack:
            node = stack.pop()
            for part in node.partials:
                if best is None or part.last_used < best.last_used:
                    best, best_parent = part, node
            for child in node.children.values():
                if child.is_leaf():
                    if best is None or child.last_used < best.last_used:
                        best, best_parent = child, node
                else:
                    stack.append(child)
        return best, best_parent

    def _drop(self, node: _Node, parent: _Node) -> None:
        if node in parent.partials:
            parent.partials.remove(node)
        else:
            parent.children.pop(node.chunk, None)
        self.allocator.free([node.page])
        self._pages -= 1
        self.evicted_pages += 1

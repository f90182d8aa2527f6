"""The radix prefix cache: prompt-prefix K/V shared across requests on
the paged pool.

Counterpart: ``paddle_tpu/serving/prefix_cache.py``. A page-granular
radix tree over token sequences whose nodes own refcounted page ids: a
request whose prompt prefix is already resident maps those pages
read-only and skips that span's prefill.

- **Page-granular matching.** One node per complete page, keyed by its
  ``page_size`` token ids, so a lookup walks ``len(prompt) / page_size``
  dict hops. Only complete prompt pages enter the tree: the partial
  boundary page (the prompt's tail and the first decode columns) is
  written on, so it stays private and its tokens prefill again with the
  tail.
- **A match is capped below the full prompt**: at least one token always
  prefills, since the first sampled token needs the last prompt
  position's logits.
- **One reference count for all readers** (`paged.PagePool.incref` /
  ``decref``): the tree holds one reference on every cached page, every
  slot that maps it one more, and a page frees only when its last reader
  lets go.
- **Insertion at admission.** As soon as a prefill returns, the
  request's complete prompt pages are immutable and enter the tree, so a
  burst of requests behind one prefix shares from the second admission
  on. A prefix already in the tree (the request's own match, or a
  duplicate prefilled beside it) is left alone: the duplicate pages stay
  private and free at release.
- **LRU eviction under pool pressure** (the pool's ``reclaim`` hook):
  leaves whose page has no slot reader (refcount 1, the tree's own) go
  oldest first until the shortfall is covered.

The engine runs it (``Engine(prefix_cache=True)``): match, map the
shared pages, reserve the private rest, prefill the tail
(`compiled.build_cached_prefill_fn`), insert.
"""
from __future__ import annotations

import heapq

import numpy as np


class _Node:
    """One cached page: ``key`` its page_size token ids (the edge from
    the parent), ``page`` the physical page."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key, page, parent, last_used):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = {}
        self.last_used = last_used


class PrefixCache:
    """Page-granular radix index over cached prompt prefixes. It owns no
    tensor: the pages live in the `paged.PagedKVCache` pool, the tree
    maps token runs to page ids and holds one reference on each. The
    owner wires the pool's ``reclaim`` hook to `evict`."""

    def __init__(self, kv):
        self.kv = kv
        self.page_size = int(kv.page_size)
        self.root = _Node(None, None, None, 0)
        self._clock = 0
        self._nodes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _page_key(self, tokens, i):
        ps = self.page_size
        return tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    def _walk(self, tokens):
        """The cached path of complete pages prefixing ``tokens``, at most
        ``(len(tokens) - 1) // page_size`` pages."""
        tokens = np.asarray(tokens)
        limit = (int(tokens.shape[0]) - 1) // self.page_size
        node, path = self.root, []
        for i in range(limit):
            node = node.children.get(self._page_key(tokens, i))
            if node is None:
                break
            path.append(node)
        return path

    def match(self, tokens) -> list:
        """The longest cached page run prefixing ``tokens``, capped so that
        at least one token is left to prefill; touches the path's LRU
        stamps."""
        path = self._walk(tokens)
        t = self._tick()
        for n in path:
            n.last_used = t
        return path

    def match_len(self, tokens) -> int:
        """The token length `match` would return, without touching LRU
        stamps or taking references."""
        return len(self._walk(tokens)) * self.page_size

    def acquire(self, tokens) -> tuple:
        """`match`, then one reference a matched page on the caller's
        behalf: ``(page_ids, matched_tokens)``. The caller maps the pages
        read-only into a slot's row, or decrefs them if its reservation
        falls through."""
        pages = [n.page for n in self.match(tokens)]
        if pages:
            self.kv.incref(pages)
        return pages, len(pages) * self.page_size

    def insert(self, tokens, row_pages) -> int:
        """Adopt a prefilled prompt's complete pages: ``row_pages`` are the
        slot's pages in logical order (`PagedKVCache.slot_row_pages`);
        the first ``len(tokens) // page_size`` are immutable. A new node
        takes the tree's own reference on its page; a token run already
        cached only has its stamp touched. Returns the pages adopted."""
        tokens = np.asarray(tokens)
        n_full = int(tokens.shape[0]) // self.page_size
        node, added, t = self.root, 0, self._tick()
        for i in range(n_full):
            key = self._page_key(tokens, i)
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(row_pages[i]), node, t)
                node.children[key] = child
                self.kv.incref([child.page])
                self._nodes += 1
                added += 1
            else:
                child.last_used = t
            node = child
        return added

    def evict(self, n_pages: int) -> int:
        """Free at least ``n_pages`` by dropping least recently used
        leaves whose page has no slot reader (refcount 1: the tree's
        own); a parent left childless joins the candidates. Returns the
        pages freed, fewer when live slots pin the rest."""
        def evictable(node):
            return not node.children and self.kv.readers(node.page) == 1

        heap = [(n.last_used, id(n), n) for n in self._leaves()
                if evictable(n)]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < n_pages:
            _, _, victim = heapq.heappop(heap)
            del victim.parent.children[victim.key]
            self._nodes -= 1
            self.kv.decref([victim.page])
            freed += 1
            parent = victim.parent
            if parent is not self.root and evictable(parent):
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        return freed

    def evict_to(self, target_pages: int) -> int:
        """Evict until at most ``target_pages`` stay cached; returns the
        pages freed (fewer when live slots pin the rest)."""
        return (self.evict(self._nodes - int(target_pages))
                if self._nodes > int(target_pages) else 0)

    def _leaves(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    @property
    def cached_pages(self) -> int:
        """Pages the tree holds (one reference each)."""
        return self._nodes

    def cached_tokens(self) -> int:
        return self._nodes * self.page_size


__all__ = ["PrefixCache"]

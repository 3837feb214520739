"""Radix-tree prefix cache over the paged KV pool (vLLM-style).

A copy of the JAX package's ``serving/frontdoor/prefix_cache.py``, which
touches no array: the same tree, eviction order and metric names.

Two requests that share a prompt prefix compute byte-identical K/V for
it (greedy serving is deterministic and RoPE positions of a shared
prefix are identical by construction), so the second request can point
its block table at the first one's blocks and skip prefilling them.
This module owns the sharing index; the refcounting that makes it safe
lives in :class:`~horovod_tpu_torch.serving.kv_pager.KVPager`:

- **nodes are whole blocks**: one radix node per ``block_size`` token
  chunk, keyed by the chunk's exact token ids.  Only FULL blocks enter
  the tree — a partially-filled block is still written by decode ticks,
  and a shared block must be immutable (this is what makes
  copy-on-write unnecessary);
- **insert-on-prefill**: after a request's prompt K/V lands in the
  pool, its full prompt blocks are inserted; each newly-shared block is
  ``pin()``-ed so it survives the owning request's release;
- **longest-prefix match at admission**, capped at ``len(prompt) - 1``
  tokens rounded down to a block multiple — at least one prompt token
  must prefill to produce the first-token logits;
- **LRU eviction of refcount-1 leaves** (held only by the cache's own
  pin) under :class:`~horovod_tpu_torch.serving.kv_pager.OutOfBlocks`
  pressure; evicting a leaf can expose its parent as the next
  candidate, so eviction cascades bottom-up.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ...obs import REGISTRY as _obs
from ..kv_pager import KVPager

_m_hits = _obs.counter(
    "hvd_prefix_cache_hits_total",
    "admissions whose prompt matched a cached prefix (>= 1 block)")
_m_misses = _obs.counter(
    "hvd_prefix_cache_misses_total",
    "admissions with no cached prefix block")
_m_evictions = _obs.counter(
    "hvd_prefix_cache_evictions_total",
    "cached blocks evicted (LRU, refcount-1 leaves) under pool pressure")
_m_shared = _obs.counter(
    "hvd_prefix_cache_blocks_shared_total",
    "prefill block-writes skipped by attaching cached blocks instead")
_m_resident = _obs.gauge(
    "hvd_prefix_cache_blocks", "blocks currently pinned by the cache")


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_use")

    def __init__(self, key: tuple, block: int,
                 parent: Optional["_Node"]) -> None:
        self.key = key
        self.block = block
        self.children: dict[tuple, "_Node"] = {}
        self.parent = parent
        self.last_use = 0


class PrefixCache:
    """Radix tree of cached prompt blocks over one :class:`KVPager`.

    ``max_blocks`` bounds the pinned working set (None = bounded only by
    pool pressure via :meth:`evict`).
    """

    def __init__(self, pager: KVPager, *,
                 max_blocks: Optional[int] = None) -> None:
        self.pager = pager
        self.block_size = pager.cache.block_size
        self.max_blocks = max_blocks
        self._root: dict[tuple, _Node] = {}
        self._tick = 0
        self._n_blocks = 0

    # -- queries ---------------------------------------------------------
    @property
    def resident_blocks(self) -> int:
        return self._n_blocks

    def _chunks(self, tokens, n_blocks: int):
        toks = np.asarray(tokens, np.int32)
        BS = self.block_size
        for i in range(n_blocks):
            yield tuple(int(t) for t in toks[i * BS:(i + 1) * BS])

    def match(self, tokens) -> tuple[int, list[int]]:
        """Longest cached prefix of ``tokens``: (matched_token_count,
        blocks).  Capped at ``len(tokens) - 1`` so at least one token
        always prefills (the first-token logits must come from
        somewhere); matched nodes get their LRU stamp refreshed."""
        n = int(np.asarray(tokens).shape[0])
        limit_blocks = max(0, n - 1) // self.block_size
        self._tick += 1
        blocks: list[int] = []
        children = self._root
        for key in self._chunks(tokens, limit_blocks):
            node = children.get(key)
            if node is None:
                break
            node.last_use = self._tick
            blocks.append(node.block)
            children = node.children
        if blocks:
            _m_hits.inc()
            _m_shared.inc(len(blocks))
        else:
            _m_misses.inc()
        return len(blocks) * self.block_size, blocks

    def peek(self, tokens) -> int:
        """Matched-token count of the longest cached prefix, without any
        side effect: no LRU refresh, no hit/miss counters.  The disagg
        router uses this as a placement probe — a probe that mutated LRU
        order would let scoring traffic evict real working sets."""
        n = int(np.asarray(tokens).shape[0])
        limit_blocks = max(0, n - 1) // self.block_size
        matched = 0
        children = self._root
        for key in self._chunks(tokens, limit_blocks):
            node = children.get(key)
            if node is None:
                break
            matched += 1
            children = node.children
        return matched * self.block_size

    def insert(self, tokens, table: Sequence[int]) -> int:
        """Insert the full blocks of a just-prefilled prompt; returns the
        number of NEW nodes.  ``table`` is the request's block table (its
        head is the cached prefix on a hit, so re-inserting a matched
        path just refreshes LRU stamps).  A concurrent-miss collision
        (two requests prefilled the same prompt before either inserted)
        keeps the first request's block; the loser's stays privately
        owned and frees on release."""
        n_full = int(np.asarray(tokens).shape[0]) // self.block_size
        self._tick += 1
        added = 0
        children, parent = self._root, None
        for i, key in enumerate(self._chunks(tokens, n_full)):
            node = children.get(key)
            if node is None:
                if self.max_blocks is not None \
                        and self._n_blocks >= self.max_blocks \
                        and not self.evict(1, protect=table):
                    break                      # cap reached, nothing evictable
                node = _Node(key, int(table[i]), parent)
                self.pager.pin(node.block)
                children[key] = node
                self._n_blocks += 1
                added += 1
            node.last_use = self._tick
            children, parent = node.children, node
        _m_resident.set(self._n_blocks)
        return added

    def evict(self, n_blocks: int, protect: Sequence[int] = ()) -> int:
        """Unpin up to ``n_blocks`` least-recently-used evictable leaves
        (evictable = refcount 1, i.e. held by nobody but the cache, and
        not in ``protect`` — the admission path protects a just-matched
        prefix that has not been attached to a table yet).  Returns how
        many blocks were actually freed."""
        guard = frozenset(int(b) for b in protect)
        freed = 0
        while freed < n_blocks:
            victim = self._lru_leaf(guard)
            if victim is None:
                break
            self.pager.unpin(victim.block)
            siblings = (victim.parent.children if victim.parent is not None
                        else self._root)
            del siblings[victim.key]
            self._n_blocks -= 1
            freed += 1
            _m_evictions.inc()
        _m_resident.set(self._n_blocks)
        return freed

    def _lru_leaf(self, guard: frozenset) -> Optional[_Node]:
        best: Optional[_Node] = None
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
                continue
            if node.block in guard or self.pager.refcount(node.block) != 1:
                continue
            if best is None or node.last_use < best.last_use:
                best = node
        return best

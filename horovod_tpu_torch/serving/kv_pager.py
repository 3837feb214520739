"""Block-paged KV cache: the allocator and the device-side page pool.

The batch `generate()` cache is ``[B, T, KV, D]`` with ``T = prompt +
max_new`` — every request pays worst-case memory up front, and the batch
dimension is welded shut.  Here the same grouped layout is cut into
fixed-size blocks pooled across requests (PagedAttention, Kwon et al.;
vLLM's central idea):

- device pool: ``[L, num_blocks, block_size, KV, D]`` per K and V —
  one allocation for the whole serving session, never resized;
- host allocator (:class:`KVPager`): a free list of block ids with
  per-request block tables mapping logical position ``p`` to physical
  block ``table[p // block_size]``;
- attention reads the pool either by gathering a request's blocks into a
  contiguous ``[B, T_pad, KV, D]`` view (:func:`gather_blocks`) or
  directly through the paged decode kernel, which reads each request's
  table itself
  (:func:`horovod_tpu_torch.ops.flash_attention.paged_attention`).

Block 0 is RESERVED as a scratch target: inactive decode slots in the
fixed-shape step function point their table rows at it, so their masked
garbage writes can never land in a live request's block.

Blocks are REFCOUNTED so a prefix cache (the JAX package's
``serving/frontdoor/prefix_cache.py``; a later slice of the port) can share one
physical block across many requests: a block's count is the number of
request tables containing it plus one if the cache holds a pin on it.
Shared blocks are only ever *prefix* blocks — fully written at insert
time and never rewritten (writes always land at positions past the
shared prefix, hence in privately-owned blocks), so no copy-on-write is
needed.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Sequence

import numpy as np
import torch


class OutOfBlocks(RuntimeError):
    """The pool has no free block; callers preempt a request and retry."""


@dataclasses.dataclass
class PagedKVCache:
    """Shape/bookkeeping descriptor for one device-side page pool.

    The pool tensors themselves live in the engine (the decode step
    writes them in place); this object owns the static geometry the
    allocator and the step functions agree on."""

    n_layers: int
    num_blocks: int
    block_size: int
    kv_heads: int
    head_dim: int

    @property
    def shape(self) -> tuple[int, int, int, int, int]:
        return (self.n_layers, self.num_blocks, self.block_size,
                self.kv_heads, self.head_dim)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` positions."""
        return -(-n_tokens // self.block_size)

    def bytes_per_block(self, itemsize: int) -> int:
        # x2: K and V pools.
        return (2 * self.n_layers * self.block_size * self.kv_heads
                * self.head_dim * itemsize)


class KVPager:
    """Free-list block allocator with refcounted per-request block tables.

    Invariants (tested):
    - block 0 is never handed out (scratch target for masked writes);
    - per held block, ``refcount == (#tables containing it)
      + (1 if pinned)``; a block appears at most once per table;
    - the free list and the held set partition the usable pool:
      ``len(held) + len(free) == num_blocks - 1``;
    - double-free, foreign-free, double-pin and pinning/sharing a
      non-live block raise.
    """

    def __init__(self, cache: PagedKVCache) -> None:
        if cache.num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is scratch)")
        self.cache = cache
        # LIFO free list: recently-freed blocks are re-used first, which
        # keeps the working set of pool pages dense.
        self._free: list[int] = list(range(cache.num_blocks - 1, 0, -1))
        self._tables: dict[int, list[int]] = {}
        self._refs: dict[int, int] = {}        # held block -> refcount
        self._pinned: set[int] = set()         # cache-held blocks

    # -- queries ---------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def table(self, req_id: int) -> list[int]:
        return list(self._tables[req_id])

    def refcount(self, block: int) -> int:
        """Live references to ``block`` (0 = on the free list)."""
        return self._refs.get(block, 0)

    def is_pinned(self, block: int) -> bool:
        return block in self._pinned

    def shared_blocks(self) -> int:
        """Blocks referenced by more than one holder (sharing gauge)."""
        return sum(1 for r in self._refs.values() if r > 1)

    def num_tokens_capacity(self) -> int:
        return self.free_blocks * self.cache.block_size

    def can_allocate(self, n_tokens: int) -> bool:
        return self.cache.blocks_for(n_tokens) <= self.free_blocks

    # -- allocation ------------------------------------------------------
    def _take(self, n: int) -> list[int]:
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._refs[b] = 1
        return blocks

    def _decref(self, block: int) -> None:
        r = self._refs[block] - 1
        if r:
            self._refs[block] = r
        else:
            del self._refs[block]
            self._free.append(block)

    def allocate(self, req_id: int, n_tokens: int,
                 prefix_blocks: Sequence[int] = ()) -> list[int]:
        """Fresh table covering ``n_tokens`` for a new request.

        ``prefix_blocks`` (from a prefix-cache hit) head the table as
        shared references — their refcounts bump instead of consuming
        free blocks; only the remainder is drawn from the free list."""
        if req_id in self._tables:
            raise ValueError(f"request {req_id} already has a table")
        need = self.cache.blocks_for(n_tokens) - len(prefix_blocks)
        if need < 0:
            raise ValueError(
                f"{len(prefix_blocks)} prefix blocks exceed the "
                f"{self.cache.blocks_for(n_tokens)} needed for "
                f"{n_tokens} tokens")
        for b in prefix_blocks:
            if b not in self._refs:
                raise ValueError(f"prefix block {b} is not live")
        if need > len(self._free):
            raise OutOfBlocks(
                f"need {need} blocks for {n_tokens} tokens, "
                f"{len(self._free)} free")
        for b in prefix_blocks:
            self._refs[b] += 1
        blocks = list(prefix_blocks) + self._take(need)
        self._tables[req_id] = blocks
        return list(blocks)

    def extend(self, req_id: int, n_tokens: int) -> list[int]:
        """Grow ``req_id``'s table to cover ``n_tokens`` total positions;
        returns the full table.  Raises :class:`OutOfBlocks` (allocator
        state unchanged) when the pool is exhausted — the scheduler
        preempts a request and retries."""
        table = self._tables[req_id]
        need = self.cache.blocks_for(n_tokens) - len(table)
        if need <= 0:
            return list(table)
        if need > len(self._free):
            raise OutOfBlocks(
                f"request {req_id} needs {need} more blocks, "
                f"{len(self._free)} free")
        table.extend(self._take(need))
        return list(table)

    def truncate(self, req_id: int, n_tokens: int) -> list[int]:
        """Shrink ``req_id``'s table to the blocks covering ``n_tokens``
        positions, releasing the tail (speculative-decode rollback: the
        blocks past the accepted prefix go back to the pool so their
        stale rejected-token K/V can never be read through this table).
        Returns the remaining table."""
        table = self._tables[req_id]
        keep = self.cache.blocks_for(n_tokens)
        for b in table[keep:]:
            self._decref(b)
        del table[keep:]
        return list(table)

    def release(self, req_id: int) -> None:
        """Drop every reference ``req_id`` holds; unshared blocks return
        to the free list, shared/pinned ones stay with their holders."""
        blocks = self._tables.pop(req_id, None)
        if blocks is None:
            raise KeyError(f"request {req_id} holds no blocks")
        for b in blocks:
            self._decref(b)

    # -- cache pins ------------------------------------------------------
    def pin(self, block: int) -> None:
        """Add the prefix cache's reference to a live block, keeping it
        resident after every owning request releases."""
        if block not in self._refs:
            raise ValueError(f"cannot pin block {block}: not live")
        if block in self._pinned:
            raise ValueError(f"block {block} already pinned")
        self._pinned.add(block)
        self._refs[block] += 1

    def unpin(self, block: int) -> None:
        """Drop the cache's reference (eviction); the block frees once no
        request table holds it."""
        if block not in self._pinned:
            raise ValueError(f"block {block} is not pinned")
        self._pinned.discard(block)
        self._decref(block)

    # -- fixed-shape table matrix for the compiled step ------------------
    def table_matrix(self, req_ids: list[int], n_cols: int) -> np.ndarray:
        """``[len(req_ids), n_cols]`` int32 block tables, rows padded with
        the scratch block 0 (ids of ``-1`` mean an inactive slot — an
        all-scratch row)."""
        out = np.zeros((len(req_ids), n_cols), np.int32)
        for i, rid in enumerate(req_ids):
            if rid < 0:
                continue
            tbl = self._tables[rid][:n_cols]
            out[i, :len(tbl)] = tbl
        return out

    def check_invariants(self) -> None:
        uses = Counter(b for tbl in self._tables.values() for b in tbl)
        for tbl in self._tables.values():
            assert len(set(tbl)) == len(tbl), "block twice in one table"
        for b in self._pinned:
            uses[b] += 1
        assert 0 not in uses, "scratch block 0 leaked into a table/pin"
        assert 0 not in self._free, "scratch block 0 leaked into free list"
        assert dict(uses) == self._refs, \
            f"refcounts drifted: counted {dict(uses)}, stored {self._refs}"
        assert not (set(self._free) & set(self._refs)), \
            "block both free and held"
        assert len(self._refs) + len(self._free) \
            == self.cache.num_blocks - 1, "blocks lost or duplicated"


def gather_blocks(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Contiguous ``[B, n_cols * block_size, KV, D]`` copy of each row's
    blocks (the gather path of paged attention: a take along the block
    dim).

    pool: ``[num_blocks, block_size, KV, D]`` (one layer's pages);
    table: ``[B, n_cols]`` integer block ids.
    """
    B, n_cols = table.shape
    g = pool[table.long()]                # [B, n_cols, BS, KV, D]
    return g.reshape(B, n_cols * pool.shape[1], *pool.shape[2:])

"""Flatten/partition plan of the ZeRO-1 sharded optimizer.

The port of ``horovod_tpu/optim/partition.py`` over a list of tensors.
The sharded optimizer (:mod:`.zero`) keeps only the 1/n gradient shard
the reduce-scatter hands this rank and steps its inner optimizer on that
shard.  Every tensor is padded to a shard-divisible size whose unit is the
schedule lowerer's chunk unit (:func:`~..ops.sched.lower.chunk_layout`):

- fp32 / cast tensors pad to a multiple of ``n``;
- quantized tensors pad to a multiple of ``n * block``, so quant block
  boundaries fall where the dense per-tensor path puts them and every
  shared scale, so every quantized bit, matches it.

Tensors are grouped into size-targeted *buckets* (``HVDTPU_BUCKET_BYTES``):
a bucket is one flat buffer, the concatenation of its padded tensors,
reduced by one reduce-scatter chain and closed by one parameter
allgather.  Buckets never mix dtypes or wire modes.

Shard layout: a bucket of ``P`` padded elements is cut by
``chunk_layout`` into ``k`` chunks; the reduce-scatter of chunk *c* hands
rank *r* the slice ``[r*clen/n, (r+1)*clen/n)`` of that chunk, so the
rank's shard is the chunk-major concatenation of those slices (``P/n``
elements).  :func:`extract_shard` and :func:`assemble_from_shards` are the
exact inverse pair for that layout; :func:`shard_ranges` names the slices.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from ..ops.sched.lower import chunk_layout


class LeafSpec(NamedTuple):
    """Static geometry of one tensor inside its bucket."""
    index: int          # position in the tensor list
    shape: tuple
    dtype: Any
    numel: int
    padded: int         # numel rounded up to the bucket's unit
    offset: int         # offset of this tensor inside the bucket's buffer


class BucketSpec(NamedTuple):
    """One fusion bucket: same-dtype, same-wire-mode tensors."""
    leaves: tuple       # tuple[LeafSpec, ...] in list order
    numel: int          # sum of padded sizes (a multiple of the unit)
    shard: int          # numel // n
    mode: str           # "fp32" or a quantized wire mode
    dtype: Any


class Plan(NamedTuple):
    """The partition plan: derived from shapes, dtypes and config only,
    so every rank computes the same one."""
    n: int
    block: int
    chunks: int
    buckets: tuple      # tuple[BucketSpec, ...]
    numel: int          # total unpadded elements
    padded: int         # total padded elements
    shard_numel: int    # padded // n


def _pad_unit(mode: str, n: int, block: int) -> int:
    return n * block if mode not in ("fp32", "bf16", "fp16") else n


def build_plan(leaves: Sequence[torch.Tensor], n: int, *,
               modes: Sequence[str], block: int = 512, chunks: int = 2,
               bucket_bytes: int = 0) -> Plan:
    """The partition plan of ``leaves`` over ``n`` shards.  ``modes[i]``
    is tensor *i*'s resolved wire mode ("fp32", or the quantized mode
    for a quantized tensor above the size floor).  ``bucket_bytes <= 0``
    means one bucket per (dtype, mode) group."""
    if len(modes) != len(leaves):
        raise ValueError(f"modes has {len(modes)} entries for "
                         f"{len(leaves)} leaves")
    open_by_key: dict = {}
    order: list = []
    for i, (leaf, mode) in enumerate(zip(leaves, modes)):
        dtype = leaf.dtype
        itemsize = leaf.element_size()
        unit = _pad_unit(mode, n, block)
        numel = leaf.numel()
        padded = max(1, -(-numel // unit)) * unit
        key = (dtype, mode)
        cur = open_by_key.get(key)
        cur_bytes = sum(s.padded for s in cur) * itemsize if cur else 0
        if cur is None or (bucket_bytes > 0 and cur and
                           cur_bytes + padded * itemsize > bucket_bytes):
            cur = []
            open_by_key[key] = cur
            order.append((cur, mode, dtype))
        off = sum(s.padded for s in cur)
        cur.append(LeafSpec(index=i, shape=tuple(leaf.shape), dtype=dtype,
                            numel=numel, padded=padded, offset=off))
    buckets = []
    for specs, mode, dtype in order:
        total = sum(s.padded for s in specs)
        buckets.append(BucketSpec(leaves=tuple(specs), numel=total,
                                  shard=total // n, mode=mode, dtype=dtype))
    numel = sum(s.numel for b in buckets for s in b.leaves)
    padded = sum(b.numel for b in buckets)
    return Plan(n=n, block=block, chunks=chunks, buckets=tuple(buckets),
                numel=numel, padded=padded, shard_numel=padded // n)


def bucket_layout(plan: Plan, bucket: BucketSpec) -> tuple:
    """Chunk layout of one bucket's buffer, shared by the reduce-scatter
    chain and the shard extract/assemble pair (``bucket.numel`` is
    already unit-aligned, so this never pads)."""
    return tuple(chunk_layout(bucket.numel, plan.n, max(1, plan.chunks),
                              bucket.mode, plan.block))


def flatten_bucket(bucket: BucketSpec,
                   leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate a bucket's tensors (from the whole list) into its
    padded flat buffer."""
    parts = []
    for spec in bucket.leaves:
        flat = leaves[spec.index].reshape(-1)
        if spec.padded != spec.numel:
            flat = torch.cat([flat, flat.new_zeros(spec.padded - spec.numel)])
        parts.append(flat)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unflatten_bucket(bucket: BucketSpec, flat: torch.Tensor) -> list:
    """Inverse of :func:`flatten_bucket`: ``[(index, tensor), ...]``,
    views of ``flat`` without the padding."""
    return [(spec.index,
             flat[spec.offset:spec.offset + spec.numel].view(spec.shape))
            for spec in bucket.leaves]


def shard_ranges(layout: Sequence[int], me: int, n: int) -> list:
    """Rank ``me``'s slices of a bucket's buffer, ``[(start, end), ...]``
    in shard (chunk-major) order."""
    out, off = [], 0
    for clen in layout:
        piece = clen // n
        out.append((off + me * piece, off + (me + 1) * piece))
        off += clen
    return out


def extract_shard(flat: torch.Tensor, me: int, layout: Sequence[int],
                  n: int) -> torch.Tensor:
    """Rank ``me``'s shard of a bucket's buffer, chunk-major: the same
    elements in the same order that the reduce-scatter of each chunk
    hands that rank (a view when it is one slice)."""
    parts = [flat[a:b] for a, b in shard_ranges(layout, me, n)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def assemble_from_shards(gathered: torch.Tensor, layout: Sequence[int],
                         n: int) -> torch.Tensor:
    """Rebuild the whole bucket buffer from the allgather of every rank's
    shard (``gathered``: flat ``[n * shard]``, rank-major)."""
    rows = gathered.view(n, -1)
    chunks, soff = [], 0
    for clen in layout:
        piece = clen // n
        # rows[:, soff:soff+piece] holds chunk c's pieces by rank; their
        # rank-major flatten is the chunk's element order.
        chunks.append(rows[:, soff:soff + piece].reshape(-1))
        soff += piece
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks)


def shard_bytes(tensors) -> int:
    """Total bytes of a collection of tensors."""
    return sum(t.numel() * t.element_size() for t in tensors)

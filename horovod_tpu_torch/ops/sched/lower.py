"""Lowering passes: collective verb + parameters -> :class:`~.ir.Schedule`.

A copy of the JAX package's ``ops/sched/lower.py``: the port lowers
every collective exactly as the reference does.  The hierarchical
lowerings are data only here; their executor family waits for ROADMAP
section A 'Hierarchy'.

Everything here is a pure function of values every rank agrees on
(shape, dtype, reduce op, wire mode, chunk count, synchronized config),
so two processes — or a joined rank rebuilding from a negotiation meta —
always produce byte-identical schedules and therefore identical compiled
programs.  That invariant is what lets the engine carry only the compact
descriptor (``"rs_ag:4"``) through negotiation, next to the ``wp`` wire
mode field.
"""

from __future__ import annotations

import math
import re
from typing import Optional

from .ir import Schedule, _Builder

#: Descriptor grammar for negotiation metas: three schedule families
#: ride the ``sc`` field — the chunked reduce-scatter/allgather
#: decomposition (``rs_ag:<k>``), the chunked+tiered two-level allreduce
#: (``hier:<n_local>:<k>``), and the compiled GSPMD lowering of the flat
#: family (``compiled:rs_ag:<k>`` — same schedule, executed as ONE
#: jitted program instead of the executor's dispatch-unit walk).
#: Unknown descriptors from version-skewed peers must be rejected
#: (parse -> None), never guessed at.
_DESC_RE = re.compile(r"^rs_ag:(\d+)$")
_HIER_DESC_RE = re.compile(r"^hier:(\d+):(\d+)$")
_COMPILED_DESC_RE = re.compile(r"^compiled:rs_ag:(\d+)$")

#: Schedule-mode config values (``HOROVOD_TPU_SCHED_MODE``).
SCHED_MODES = ("monolithic", "decomposed", "compiled")


def parse_descriptor(desc: str) -> Optional[int]:
    """``"rs_ag:<k>"`` -> chunk count k, or None when malformed/unknown.

    The joined-rank half of schedule agreement: a meta whose ``sc`` field
    does not parse means a peer runs a lowering this build does not know
    — the entry must be skipped (exactly like an unknown ``wp`` mode),
    not crash the cycle thread.
    """
    m = _DESC_RE.match(desc or "")
    if not m:
        return None
    k = int(m.group(1))
    return k if k >= 1 else None


def descriptor(chunks: int) -> str:
    return f"rs_ag:{int(chunks)}"


def parse_hier_descriptor(desc: str) -> Optional[tuple]:
    """``"hier:<n_local>:<k>"`` -> ``(n_local, chunks)``, or None.

    The tiered sibling of :func:`parse_descriptor`: ``n_local`` is the
    fast-tier (ICI) group size every rank agreed on, ``k`` the chunk
    count.  ``n_local >= 2`` is required — a one-rank "tier" is just the
    flat schedule and must never be encoded as hier (two ranks lowering
    differently for the same meta would desynchronize dispatch).
    """
    m = _HIER_DESC_RE.match(desc or "")
    if not m:
        return None
    n_local, k = int(m.group(1)), int(m.group(2))
    if n_local < 2 or k < 1:
        return None
    return (n_local, k)


def hier_descriptor(n_local: int, chunks: int) -> str:
    return f"hier:{int(n_local)}:{int(chunks)}"


def parse_compiled_descriptor(desc: str) -> Optional[int]:
    """``"compiled:rs_ag:<k>"`` -> chunk count k, or None.

    The compiled sibling of :func:`parse_descriptor`: the schedule lowered
    is byte-identical to the flat ``rs_ag:<k>`` family's, but the backend
    is one jitted NamedSharding program (XLA places and fuses the
    collectives) instead of the executor's per-unit dispatch walk.  The
    backend choice rides the descriptor because every process MUST run
    the same executable — under ``jax.distributed`` the per-collective
    channel IDs are assigned per-program, so a compiled rank and a
    dispatched rank would rendezvous on nothing.
    """
    m = _COMPILED_DESC_RE.match(desc or "")
    if not m:
        return None
    k = int(m.group(1))
    return k if k >= 1 else None


def compiled_descriptor(chunks: int) -> str:
    return f"compiled:rs_ag:{int(chunks)}"


def known_descriptor(desc: str) -> bool:
    """True when ``desc`` belongs to a schedule family this build can
    lower — the negotiation meta's validity check for the ``sc`` field."""
    return (parse_descriptor(desc) is not None or
            parse_hier_descriptor(desc) is not None or
            parse_compiled_descriptor(desc) is not None)


def autotune_sched_arms(chunk_counts=(2, 4)) -> list:
    """The autotuner's schedule-dimension arm set, derived from
    :data:`SCHED_MODES` so the two can never drift apart (adding a mode
    here grows the grid automatically; tests assert the sync).

    ``monolithic`` contributes itself; ``decomposed`` contributes one
    flat ``rs_ag:<k>`` arm per candidate chunk count; ``compiled``
    contributes the compiled twin of each.  Hier arms are seeded
    separately from the split table (topology-, not mode-, derived).
    """
    arms = []
    for mode in SCHED_MODES:
        if mode == "monolithic":
            arms.append("monolithic")
        elif mode == "decomposed":
            arms.extend(descriptor(k) for k in chunk_counts)
        elif mode == "compiled":
            arms.extend(compiled_descriptor(k) for k in chunk_counts)
    return arms


def chunk_layout(numel: int, n: int, chunks: int, mode: str,
                 block: int) -> list:
    """Per-chunk element counts for a decomposed allreduce payload.

    The flat payload is zero-padded to ``plen`` — a multiple of the
    *unit* — and split into at most ``chunks`` contiguous pieces, each a
    whole number of units:

    - fp32/cast modes: unit = ``n`` (psum_scatter shards must divide
      evenly across ranks);
    - quantized modes: unit = ``n * block`` (shard boundaries must also
      land on block-scale boundaries, and — deliberately — on the SAME
      boundaries the monolithic quantized kernel uses, so the decomposed
      result is bit-identical to it: per-block scales, exact narrow-
      accumulator sums and per-block requantization are all independent
      of which chunk a block lands in).

    Returns the chunk lengths (summing to plen >= numel); the effective
    chunk count is ``len(result)`` <= ``chunks`` (a payload with fewer
    units than requested chunks degrades gracefully).
    """
    if numel < 1 or n < 1 or chunks < 1:
        raise ValueError(f"bad chunk layout inputs ({numel}, {n}, {chunks})")
    from ..reduction import QUANT_MODES
    unit = n * block if mode in QUANT_MODES else n
    units_total = max(1, math.ceil(numel / unit))
    k = min(chunks, units_total)
    base, rem = divmod(units_total, k)
    # Deterministic spread: the first ``rem`` chunks get one extra unit.
    return [(base + (1 if c < rem else 0)) * unit for c in range(k)]


def lower_allreduce(numel: int, n: int, *, op_average: bool, mode: str,
                    chunks: int, axis: str, block: int = 512) -> Schedule:
    """Fused-allreduce group -> chunked reduce-scatter/allgather schedule.

    Per chunk *c* the pipeline is::

        [encode(c)] -> reduce_scatter(c) -> combine(c) -> all_gather(c)
                       \\_______ comm ____/   \\ compute /   \\__ comm __/

    where for quantized modes ``encode`` is the shared-scale block
    quantization (folded into the same dispatch as the reduce-scatter —
    XLA fuses them; the IR keeps it explicit so signatures say what the
    wire carries), ``combine`` is the fp32 dequant-accumulate + average +
    local-scale requant, and ``all_gather`` moves the 1-byte payload +
    scales and decodes.  For fp32, ``encode`` is elided and ``combine``
    is the average (elided again for SUM — nothing to compute).

    A leading ``chunk`` DATA step models the flatten/concat/pad split and
    a trailing ``concat`` step models reassembly; ``barrier`` is not
    emitted here (the rs_ag DAG's only joins are per-chunk edges) but the
    executor honors it for hand-built schedules.
    """
    b = _Builder()
    layout = chunk_layout(numel, n, chunks, mode, block)
    k = len(layout)
    quant = mode in ("int8", "fp8")
    split = b.add("chunk")
    tails = []
    for c in range(k):
        prev = split
        if quant:
            prev = b.add("encode", chunk=c, mode=mode, deps=[prev])
        rs = b.add("reduce_scatter", chunk=c, axis=axis, deps=[prev])
        prev = rs
        if quant or op_average:
            # Quantized: dequant-accumulate (+average) + requant.
            # fp32 AVERAGE: the divide.  fp32 SUM: no compute step.
            prev = b.add("combine", chunk=c, mode=mode if quant else "",
                         deps=[prev])
        ag = b.add("all_gather", chunk=c, axis=axis, deps=[prev])
        prev = ag
        if quant:
            prev = b.add("decode", chunk=c, mode=mode, deps=[prev])
        tails.append(prev)
    b.add("concat", deps=tails)
    return b.build("rs_ag", chunks=k, mode=mode,
                   descriptor=descriptor(chunks))


def lower_hierarchical(local_axis: str, cross_axis: str) -> Schedule:
    """Two-tier allreduce as an IR schedule (ROADMAP item 3 seed).

    The reference's ``HOROVOD_HIERARCHICAL_ALLREDUCE`` shape — NCCL
    reduce-scatter within the node, MPI allreduce across, NCCL allgather
    back — expressed as three steps on two tiers::

        reduce_scatter@local -> all_reduce@cross -> all_gather@local

    ``ops/hierarchical.py`` builds this schedule and interprets it
    in-graph (the JAX package's ``ops/sched/in_context.run_in_context``),
    so the two-level path and the engine's chunked path share one step
    vocabulary — the prerequisite for a topology-aware lowering that
    chunks *and* tiers.
    """
    b = _Builder()
    rs = b.add("reduce_scatter", chunk=0, axis=local_axis)
    ar = b.add("all_reduce", chunk=0, axis=cross_axis, deps=[rs])
    cb = b.add("combine", chunk=0, deps=[ar])
    b.add("all_gather", chunk=0, axis=local_axis, deps=[cb])
    return b.build("hier", chunks=1, mode="fp32",
                   descriptor=f"hier:{local_axis}/{cross_axis}")


def lower_hierarchical_chunked(
        numel: int, n_local: int, n_cross: int, *, op_average: bool,
        mode: str, cross_mode: str, chunks: int, local_axis: str,
        cross_axis: str, block: int = 512) -> Schedule:
    """Chunked + tiered allreduce: ``rs_ag:k`` chunking composed with the
    two-tier split so chunk *i*'s slow-tier (DCN) allreduce overlaps
    chunk *i+1*'s fast-tier (ICI) reduce-scatter.

    Per chunk *c* the pipeline is::

        [encode(c)] -> reduce_scatter(c)@local -> all_reduce(c)@cross
                    -> combine(c) -> all_gather(c)@local -> [decode(c)]

    The cross-tier ``all_reduce`` moves only the 1/n_local shard and
    carries its own wire mode (``cross_mode`` — e.g. int8 on DCN under
    fp32 ICI, per EQuARX); ``combine`` is the post-cross dequant/average/
    requant.  :meth:`~.ir.Schedule.interleaved_order` ranks all local
    scatters ahead of every post-scatter step, so the dispatch order is
    ``RS(c0), RS(c1), ..., AR(c0), CB(c0), AG(c0), AR(c1), ...`` — chunk
    c's cross hop runs under chunk c+1's local scatter.

    Chunk boundaries reuse :func:`chunk_layout` with ``n = n_local *
    n_cross`` (total ranks): the quantized unit ``n * block`` makes each
    chunk's 1/n_local local shard a whole number of ``n_cross * block``
    units (so the cross hop can itself scatter on block boundaries), and
    — deliberately — lands on the SAME boundaries the flat lowering
    uses, so quantized hier results are bit-identical to flat per chunk.
    """
    if n_local < 2 or n_cross < 2:
        raise ValueError(f"bad tier split ({n_local}, {n_cross})")
    b = _Builder()
    n = n_local * n_cross
    from ..reduction import QUANT_MODES
    mode_eff = mode if mode in QUANT_MODES else (
        cross_mode if cross_mode in QUANT_MODES else mode)
    layout = chunk_layout(numel, n, chunks, mode_eff, block)
    k = len(layout)
    quant = mode in QUANT_MODES
    cross_quant = cross_mode in QUANT_MODES
    split = b.add("chunk")
    tails = []
    for c in range(k):
        prev = split
        if quant:
            prev = b.add("encode", chunk=c, mode=mode, deps=[prev])
        rs = b.add("reduce_scatter", chunk=c, axis=local_axis, deps=[prev])
        ar = b.add("all_reduce", chunk=c, axis=cross_axis,
                   mode=cross_mode if cross_quant else "", deps=[rs])
        prev = ar
        if quant or cross_quant or op_average:
            prev = b.add("combine", chunk=c,
                         mode=mode if quant else
                         (cross_mode if cross_quant else ""),
                         deps=[prev])
        ag = b.add("all_gather", chunk=c, axis=local_axis, deps=[prev])
        prev = ag
        if quant:
            prev = b.add("decode", chunk=c, mode=mode, deps=[prev])
        tails.append(prev)
    b.add("concat", deps=tails)
    return b.build("hier", chunks=k, mode=mode,
                   descriptor=hier_descriptor(n_local, chunks))

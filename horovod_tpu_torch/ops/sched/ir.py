"""Collective schedule IR: schedules-as-data for decomposed collectives.

A copy of the JAX package's ``ops/sched/ir.py`` (it imports no jax), so
both packages lower every collective to the same steps and signatures.

Per GC3 ("GC3: An Optimizing Compiler for GPU Collective Communication")
and "Optimizing Distributed ML Communication with Fused
Computation-Collective Operations" (PAPERS.md), a large allreduce should
not be an opaque verb: it is a *schedule* of primitive steps —
reduce-scatter and allgather halves, chunked so later chunks'
communication overlaps earlier chunks' compute, composed with the wire
precision encode/decode steps of :mod:`horovod_tpu_torch.ops.reduction`.

This module is the data model only: a :class:`Step` is one primitive
operation, a :class:`Schedule` is a validated DAG of steps with a stable
string :meth:`~Schedule.signature`.  Lowering (verb -> schedule) lives in
:mod:`.lower`; execution lives in :mod:`.executor` (engine-side, one
jitted program per phase) and :mod:`.in_context` (inside an existing
mapped region).

Design constraints, in order:

1. **Cross-rank determinism.**  Every rank — including a joined rank
   rebuilding the entry from a negotiation meta — must lower to the
   byte-identical schedule, so signatures are pure functions of
   (verb, shape, dtype, op, wire mode, chunk count, config) and never of
   rank-local state.  The compact descriptor carried in negotiation
   metas (``"rs_ag:4"``) re-derives the full schedule through the same
   lowering.
2. **Precision composes.**  ``Encode``/``Decode`` steps reuse the
   reduction algebras, so the block-scaled int8/fp8 pipeline maps onto
   the same IR as fp32 (quantize -> reduce-scatter -> dequant-accumulate
   -> requant -> 1-byte allgather).
3. **Topology composes.**  The same step vocabulary expresses the
   two-tier hierarchical allreduce (intra-tier reduce-scatter,
   inter-tier allreduce, intra-tier allgather) — see
   :func:`horovod_tpu_torch.ops.sched.lower.lower_hierarchical`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

#: Step kinds.  COMM steps move bytes over the interconnect; COMPUTE
#: steps are local arithmetic (the overlap target); DATA steps reshape
#: buffers and carry no meaningful wall-clock.
COMM_KINDS = ("reduce_scatter", "all_gather", "all_reduce")
COMPUTE_KINDS = ("encode", "combine", "decode")
DATA_KINDS = ("chunk", "concat", "barrier")
KINDS = COMM_KINDS + COMPUTE_KINDS + DATA_KINDS


@dataclasses.dataclass(frozen=True)
class Step:
    """One primitive operation in a collective schedule.

    ``uid``    — schedule-unique id; dependency edges reference uids.
    ``kind``   — one of :data:`KINDS`.
    ``chunk``  — chunk index this step operates on (-1 = whole buffer).
    ``axis``   — mesh axis a COMM step communicates over ("" for local
    steps; hierarchical schedules use it to place steps on tiers).
    ``mode``   — wire mode for encode/decode steps ("" = fp32/identity).
    ``deps``   — uids of steps that must complete before this one; the
    executor is free to dispatch anything whose deps are satisfied, which
    is exactly where overlap comes from.
    """

    uid: int
    kind: str
    chunk: int = -1
    axis: str = ""
    mode: str = ""
    deps: tuple = ()

    @property
    def is_comm(self) -> bool:
        return self.kind in COMM_KINDS

    @property
    def is_compute(self) -> bool:
        return self.kind in COMPUTE_KINDS

    def sig(self) -> str:
        """Stable per-step signature fragment."""
        parts = [self.kind]
        if self.chunk >= 0:
            parts.append(f"c{self.chunk}")
        if self.axis:
            parts.append(f"@{self.axis}")
        if self.mode and self.mode != "fp32":
            parts.append(self.mode)
        dep = ",".join(str(d) for d in self.deps)
        return f"{self.uid}:" + ".".join(parts) + (f"<-{dep}" if dep else "")


class ScheduleError(ValueError):
    """Malformed schedule (bad deps, unknown kind, cycle)."""


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A validated DAG of :class:`Step`, plus the lowering parameters
    that produced it (enough to rebuild identical compiled programs on
    every rank).

    ``descriptor`` is the compact wire form carried through negotiation
    metas (e.g. ``"rs_ag:4"``); ``signature()`` is the full stable
    string — lowering determinism means descriptor + entry meta implies
    the signature, and the signature doubles as a compile-cache key.
    """

    name: str                       # e.g. "rs_ag", "hier"
    steps: tuple                    # tuple[Step, ...], topologically ordered
    chunks: int = 1                 # effective chunk count
    mode: str = "fp32"              # wire mode the schedule composes with
    descriptor: str = ""            # compact negotiation-meta form

    def __post_init__(self) -> None:
        seen: set = set()
        for s in self.steps:
            if s.kind not in KINDS:
                raise ScheduleError(f"unknown step kind {s.kind!r}")
            if s.uid in seen:
                raise ScheduleError(f"duplicate step uid {s.uid}")
            for d in s.deps:
                if d not in seen:
                    # Steps are declared in topological order, so a dep
                    # on a not-yet-seen uid is either forward (a cycle)
                    # or dangling — both malformed.
                    raise ScheduleError(
                        f"step {s.uid} depends on {d}, which is not an "
                        "earlier step (cycle or dangling edge)")
            seen.add(s.uid)

    def signature(self) -> str:
        """Stable string identity: equal schedules (same lowering inputs)
        produce equal signatures on every rank and across processes."""
        body = ";".join(s.sig() for s in self.steps)
        return f"sched[{self.name}/k{self.chunks}/{self.mode}]{{{body}}}"

    def step(self, uid: int) -> Step:
        for s in self.steps:
            if s.uid == uid:
                return s
        raise KeyError(uid)

    def consumers(self, uid: int) -> list:
        return [s for s in self.steps if uid in s.deps]

    def comm_steps(self) -> list:
        return [s for s in self.steps if s.is_comm]

    def compute_steps(self) -> list:
        return [s for s in self.steps if s.is_compute]

    def interleaved_order(self) -> list:
        """Dispatch order that exposes overlap: a greedy topological walk
        over the ready set with priority ``reduce_scatter`` > pre-comm
        compute (``encode``) > everything downstream of the scatters
        (``combine``/``decode``/``all_gather``/``all_reduce``) > data,
        ties broken by ascending chunk, then uid.

        Ranking the scatters (and the encodes that unlock them) ahead of
        ALL post-scatter steps matters: it issues every chunk's inbound
        communication before any earlier chunk's results are demanded —
        including the no-combine fp32 SUM pipeline, where an earlier
        chunk's ``all_gather`` becomes ready while later scatters are
        still pending and must NOT jump the queue (COMM priority alone
        would serialize the walk into RS(c), AG(c) pairs).  For the
        rs_ag family this yields ``RS(c0), RS(c1), ...,
        [COMBINE(c0),] AG(c0), [COMBINE(c1),] AG(c1), ...`` (encodes/
        decodes interleaved next to their chunk's comm) — the same unit
        order the engine executor dispatches, asserted equivalent in
        tests/test_sched.py — giving the device room to run chunk
        *c+1*'s collective under chunk *c*'s arithmetic.
        """
        def pri(s: Step) -> int:
            if s.kind == "reduce_scatter":
                return 0
            if s.kind == "encode":
                return 1
            if s.is_comm or s.is_compute:
                return 2
            return 3

        done: set = set()
        pending = list(self.steps)
        order: list = []
        while pending:
            ready = [s for s in pending if all(d in done for d in s.deps)]
            if not ready:  # unreachable post-validation; defensive
                raise ScheduleError("schedule has an unsatisfiable step")
            ready.sort(key=lambda s: (pri(s), s.chunk, s.uid))
            nxt = ready[0]
            order.append(nxt)
            done.add(nxt.uid)
            pending.remove(nxt)
        return order


class _Builder:
    """Tiny helper for lowering passes: monotonically numbered steps."""

    def __init__(self) -> None:
        self.steps: list = []
        self._uid = 0

    def add(self, kind: str, *, chunk: int = -1, axis: str = "",
            mode: str = "", deps: Iterable = ()) -> int:
        uid = self._uid
        self._uid += 1
        self.steps.append(Step(uid=uid, kind=kind, chunk=chunk, axis=axis,
                               mode=mode, deps=tuple(deps)))
        return uid

    def build(self, name: str, *, chunks: int, mode: str,
              descriptor: str = "") -> Schedule:
        return Schedule(name=name, steps=tuple(self.steps), chunks=chunks,
                        mode=mode, descriptor=descriptor)

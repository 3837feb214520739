"""Collective schedule IR: decomposed collectives with compute overlap.

The port of ``horovod_tpu/ops/sched``, the flat family:

- :mod:`.ir` and :mod:`.lower` — copies of the reference's data model and
  lowering passes (no jax in either);
- :mod:`.executor` — the engine-side walk of the chunked
  reduce-scatter -> combine -> allgather schedule (``rs_ag:<k>``);
- :mod:`.in_context` — ``overlap_allreduce`` and
  ``overlap_reducescatter`` as eager functions over a process group;
- :mod:`.buckets` — size-targeted gradient buckets.

The engine default comes from ``HVDTPU_SCHED_MODE`` (``monolithic`` or
``decomposed``) and ``HVDTPU_SCHED_CHUNKS``; :func:`resolve_schedule`
turns it into a concrete descriptor from values every rank agrees on, and
the descriptor rides the negotiation meta (``sc``, beside ``wp``).  The
``compiled`` backend, the ``hier:`` family and the hierarchical knobs wait
for ROADMAP section A 'Hierarchy and the compiled schedule' and raise.
"""

from __future__ import annotations

from typing import Any

import torch

from .ir import KINDS, Schedule, ScheduleError, Step  # noqa: F401
from .lower import (  # noqa: F401
    chunk_layout,
    descriptor,
    known_descriptor,
    lower_allreduce,
    parse_compiled_descriptor,
    parse_descriptor,
    parse_hier_descriptor,
)
from .in_context import overlap_allreduce, overlap_reducescatter  # noqa: F401

NOT_PORTED = "'Hierarchy and the compiled schedule'"


def _refuse(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to horovod_tpu_torch yet (ROADMAP section A "
        f"{NOT_PORTED})")


def resolve_schedule(requested: str, verb: str, op: Any,
                     dtype: torch.dtype, nbytes: int, cfg, n: int,
                     mode: str) -> str:
    """The schedule of one collective, from values every rank agrees on
    (verb, op, dtype, size, synchronized config, resolved wire mode): ""
    (monolithic) or ``"rs_ag:<k>"``.  ``requested`` is the per-call
    override ("" defers to ``cfg.sched_mode``).  Monolithic for other
    verbs, non-sum ops, non-float payloads, one rank, the cast wires
    (their single ``all_reduce`` is 2-byte end to end already) and
    payloads under two chunk units (``n`` elements, ``n * block`` for a
    quantized wire) — the reference's rules."""
    from .. import reduction as R
    from ..collectives import ReduceOp
    req = requested or getattr(cfg, "sched_mode", "monolithic") \
        or "monolithic"
    if req == "monolithic":
        return ""
    if req == "decomposed":
        k = max(1, int(getattr(cfg, "sched_chunks", 4)))
    else:
        k = parse_descriptor(req)
        if k is None:
            if (req == "compiled" or parse_compiled_descriptor(req)
                    is not None or parse_hier_descriptor(req) is not None):
                raise _refuse(f"schedule {req!r}")
            raise ValueError(
                f"unknown schedule {req!r}; expected 'monolithic', "
                "'decomposed' or 'rs_ag:<chunks>'")
    if getattr(cfg, "hierarchical_allreduce", False):
        raise _refuse("hierarchical_allreduce")
    if verb != "allreduce" or n <= 1 or k < 2:
        return ""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        return ""
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        return ""
    if mode in R.CAST_MODES:
        return ""
    unit = (n * getattr(cfg, "quant_block_size", 512)
            if mode in R.QUANT_MODES else n)
    numel = max(1, nbytes // max(1, dtype.itemsize))
    if numel < 2 * unit:
        return ""
    return descriptor(k)

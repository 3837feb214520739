"""Collective schedule IR: decomposed collectives with compute overlap.

The port of ``horovod_tpu/ops/sched``:

- :mod:`.ir` and :mod:`.lower` — copies of the reference's data model and
  lowering passes (no jax in either);
- :mod:`.executor` — the engine-side walk of the chunked
  reduce-scatter -> combine -> allgather schedule (``rs_ag:<k>``) and of
  its two-tier form (``hier:<n_local>:<k>``: local scatter, cross hop,
  local gather);
- :mod:`.compiled` — the same walk as one CUDA graph per schedule
  signature (``compiled:rs_ag:<k>``; eager on the CPU);
- :mod:`.in_context` — ``overlap_allreduce``, ``overlap_reducescatter``,
  ``matmul_reducescatter`` (the fused row-parallel projection) and
  ``run_in_context`` (the two-tier allreduce's interpreter) as eager
  functions over process groups;
- :mod:`.buckets` — size-targeted gradient buckets.

The engine default comes from ``HVDTPU_SCHED_MODE`` (``monolithic``,
``decomposed`` or ``compiled``) and ``HVDTPU_SCHED_CHUNKS``;
:func:`resolve_schedule` turns it into a concrete descriptor from values
every rank agrees on, and the descriptor rides the negotiation meta
(``sc``, beside ``wp``).
"""

from __future__ import annotations

from typing import Any

import torch

from .ir import KINDS, Schedule, ScheduleError, Step  # noqa: F401
from .lower import (  # noqa: F401
    chunk_layout,
    compiled_descriptor,
    descriptor,
    hier_descriptor,
    known_descriptor,
    lower_allreduce,
    lower_hierarchical,
    lower_hierarchical_chunked,
    parse_compiled_descriptor,
    parse_descriptor,
    parse_hier_descriptor,
)
from .in_context import (  # noqa: F401
    matmul_reducescatter,
    overlap_allreduce,
    overlap_reducescatter,
    run_in_context,
)

def resolve_schedule(requested: str, verb: str, op: Any,
                     dtype: torch.dtype, nbytes: int, cfg, n: int,
                     mode: str) -> str:
    """The schedule of one collective, from values every rank agrees on
    (verb, op, dtype, size, synchronized config, resolved wire mode): ""
    (monolithic), ``"rs_ag:<k>"``, ``"compiled:rs_ag:<k>"`` or
    ``"hier:<n_local>:<k>"``.  ``requested`` is the per-call override (""
    defers to ``cfg.sched_mode``; a concrete descriptor passes through).
    Monolithic for other verbs, non-sum ops, non-float payloads, one
    rank, the cast wires (their single ``all_reduce`` is 2-byte end to
    end already) and payloads under two chunk units (``n`` elements,
    ``n * block`` for a quantized wire or cross hop) — the reference's
    rules.

    Hierarchical mode composes rather than suppresses: a decomposed
    request under a valid tier split (``cfg.hierarchical_allreduce`` and
    :func:`..collectives._hier_split`) upgrades to the chunked and tiered
    ``hier:<n_local>:<k>``; a monolithic request keeps returning "" (the
    engine's monolithic route rides the unchunked two-tier allreduce); an
    invalid split falls back to the flat descriptor.  The tiered family
    has no compiled lowering, in the reference either: a compiled request
    under a valid split runs the dispatched ``hier:`` schedule, with a
    warning once a process."""
    from .. import reduction as R
    from ..collectives import ReduceOp
    req = requested or getattr(cfg, "sched_mode", "monolithic") \
        or "monolithic"
    hier_req = None     # an explicit hier:<n_local>:<k> request
    compiled = False
    if req == "monolithic":
        return ""
    if req in ("decomposed", "compiled"):
        k = max(1, int(getattr(cfg, "sched_chunks", 4)))
        compiled = req == "compiled"
    else:
        k = parse_descriptor(req)
        if k is None:
            k = parse_compiled_descriptor(req)
            compiled = k is not None
        if k is None:
            hier_req = parse_hier_descriptor(req)
            if hier_req is None:
                raise ValueError(
                    f"unknown schedule {req!r}; expected 'monolithic', "
                    "'decomposed', 'compiled', 'rs_ag:<chunks>', "
                    "'compiled:rs_ag:<chunks>' or "
                    "'hier:<n_local>:<chunks>'")
            k = hier_req[1]
    if verb != "allreduce" or n <= 1 or k < 2:
        return ""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        return ""
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        return ""
    if mode in R.CAST_MODES:
        return ""
    # The tier split: an explicit hier request, or the flag upgrading a
    # decomposed one; an unusable split degrades to the flat descriptor.
    n_local = 0
    if hier_req is not None:
        n_local = hier_req[0]
        if n % n_local or not (1 < n_local < n):
            n_local = 0
    elif getattr(cfg, "hierarchical_allreduce", False):
        from ..collectives import _hier_split
        split = _hier_split(None)
        if split is not None:
            n_local = split[1]
    cross = getattr(cfg, "hierarchical_cross_precision", "") \
        if n_local else ""
    unit = (n * getattr(cfg, "quant_block_size", 512)
            if (mode in R.QUANT_MODES or cross in R.QUANT_MODES) else n)
    numel = max(1, nbytes // max(1, dtype.itemsize))
    if numel < 2 * unit:
        return ""
    if n_local:
        if compiled:
            _warn_hier_fallback(n_local, k)
        return hier_descriptor(n_local, k)
    return compiled_descriptor(k) if compiled else descriptor(k)


_HIER_FALLBACK_WARNED: set = set()


def _warn_hier_fallback(n_local: int, k: int) -> None:
    key = (n_local, k)
    if key in _HIER_FALLBACK_WARNED:
        return
    _HIER_FALLBACK_WARNED.add(key)
    from ...utils import logging as hvd_logging
    hvd_logging.get_logger().info(
        "sched: compiled mode has no hierarchical lowering yet; "
        "falling back to dispatched hier:%d:%d (deterministic on all "
        "ranks)", n_local, k)

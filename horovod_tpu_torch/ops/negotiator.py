"""Distributed negotiation: the engine's multi-process readiness protocol.

A copy of ``horovod_tpu/ops/negotiator.py`` over the port's native shim.
† ``controller.cc Controller::ComputeResponseList`` via the native
coordinator (``horovod_tpu_torch/_native``): every engine cycle, each
process submits its pending tensor names; the rank-0 coordinator service
replies with the identical ordered ready-list to every process, so every
rank fuses the same groups and issues its NCCL or Gloo calls in the same
order, the invariant the reference's coordinator exists for.

Straggler attribution (beyond the reference's † ``stall_inspector.cc``,
which only logged the tensor name): the coordinator's stall records carry
the exact ranks that have NOT submitted each stalled tensor plus its age,
and this side surfaces them three ways —

- one actionable log line per stalled tensor naming rank(s) + tensor +
  age (what to go look at, not just that something is wrong);
- a ``horovod_tpu_straggler{rank,tensor}`` gauge holding the stall age in
  seconds while a rank withholds a tensor (zeroed when it resolves), so
  the cluster ``/cluster`` view pinpoints the lagging rank;
- ``hvd_negotiate_wait_seconds``, the per-cycle time this rank spent
  blocked in the coordinator's round barrier — fast ranks wait long,
  stragglers wait ~0, so the per-rank skew of this histogram in the
  aggregated view is the continuous (pre-stall) form of the same signal.
"""

from __future__ import annotations

import time
from typing import Optional

from .engine import NegotiationOutcome, Negotiator, TensorTableEntry
from .. import chaos
from ..obs import REGISTRY as _obs
from ..utils import logging as hvd_logging

log = hvd_logging.get_logger()

_m_neg_wait = _obs.histogram(
    "hvd_negotiate_wait_seconds",
    "time per engine cycle spent blocked in the negotiation round "
    "barrier (per-rank skew of this histogram localizes stragglers)")
_m_straggler = _obs.gauge(
    "horovod_tpu_straggler",
    "stall age in seconds while a rank withholds a tensor other ranks "
    "submitted (0 = resolved)", ("rank", "tensor"))


class DistributedNegotiator(Negotiator):
    always_check_in = True

    def __init__(self, host: str, port: int, rank: int,
                 timeout_ms: int = 60000) -> None:
        from .._native import ControllerClient
        self._client = ControllerClient(host, port, rank,
                                        timeout_ms=timeout_ms)
        self._warned: set[str] = set()
        # tensor -> set of straggler ranks currently flagged in the gauge
        # (so resolution can zero exactly what was raised).
        self._straggling: dict[str, set] = {}
        self.last_stall_info: dict = {}
        # Freshness stamp for the /healthz readiness probe: age of the
        # last negotiation round this rank completed.
        self.last_negotiate_ts: float = time.monotonic()

    def negotiate(self, entries: list[TensorTableEntry], *,
                  joined: bool = False) -> NegotiationOutcome:
        pairs = []
        seen = set()
        for e in entries:
            if e.name in seen:
                continue
            seen.add(e.name)
            members = ""
            if e.process_set is not None:
                # † process_set.cc: readiness counts the member ranks
                # only — without this, a subgroup collective would wait
                # forever for ranks that never submit it.
                members = ",".join(str(r) for r in e.process_set.ranks)
            pairs.append((e.name, e.meta(), members))
        # Chaos site: barrier entry.  A delay here holds THIS rank's
        # check-in (its peers see it as a straggler and /healthz ages);
        # an err aborts the round exactly like controller TCP trouble.
        chaos.fire("negotiate")
        t0 = time.monotonic()
        res = self._client.negotiate(pairs, joined=joined)
        self.last_negotiate_ts = time.monotonic()
        _m_neg_wait.observe(self.last_negotiate_ts - t0)
        self._account_stalls(res)
        # Ready order comes from the coordinator; the engine maps names to
        # local entries (or join zero-participation for names it lacks).
        return NegotiationOutcome(
            ready=res.ready, stalled=res.stalled, metas=res.metas,
            all_joined=res.all_joined, last_join_rank=res.last_join_rank,
            join_covered=set(res.join_covered),
            stall_info=dict(res.stall_info))

    def _account_stalls(self, res) -> None:
        """Straggler gauge + actionable warning from one round's stall
        records; zero the gauge for tensors that resolved."""
        self.last_stall_info = dict(res.stall_info)
        stalled_now = set(res.stalled)
        for name in res.stalled:
            info = res.stall_info.get(name)
            missing = set(info.missing_ranks) if info else set()
            age_s = (info.age_ms / 1000.0) if info else 0.0
            flagged = self._straggling.setdefault(name, set())
            for r in missing:
                _m_straggler.labels(rank=str(r), tensor=name).set(age_s)
            for r in flagged - missing:   # e.g. a straggler finally arrived
                _m_straggler.labels(rank=str(r), tensor=name).set(0.0)
            self._straggling[name] = missing
            if name not in self._warned:
                self._warned.add(name)
                if missing:
                    log.warning(
                        "Straggler: rank(s) %s have not submitted tensor "
                        "%r for %.1fs while the other ranks wait "
                        "(† stall_inspector); check those ranks for "
                        "rank-dependent control flow or a hung step",
                        ",".join(str(r) for r in sorted(missing)), name,
                        age_s)
                else:
                    log.warning(
                        "Negotiation stall: tensor %r submitted by some "
                        "ranks but not all († stall_inspector)", name)
        # Tensors no longer stalled (completed or abandoned): resolve.
        for name in list(self._straggling):
            if name not in stalled_now:
                for r in self._straggling.pop(name):
                    _m_straggler.labels(rank=str(r), tensor=name).set(0.0)
                self._warned.discard(name)

    def stall_attribution(self, name: str) -> Optional[str]:
        """Human-readable straggler attribution for a stalled tensor, for
        the engine's stall warnings/shutdown errors; None when the
        coordinator has not (yet) reported this tensor stalled."""
        info = self.last_stall_info.get(name)
        if info is None:
            return None
        if not info.missing_ranks:
            return f"awaiting unknown ranks, {info.age_ms / 1000.0:.0f}s"
        ranks = ",".join(str(r) for r in info.missing_ranks)
        return f"awaiting rank(s) {ranks}, {info.age_ms / 1000.0:.0f}s"

    def close(self) -> None:
        self._client.close()

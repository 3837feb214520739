"""Expected-vs-achieved collective performance model.

A copy of the JAX package's ``obs/perfmodel.py`` for the port (pure
arithmetic plus the :class:`PerfModel` tracker).  For a verb at a
payload size on ``n`` ranks with a wire mode and a schedule descriptor
it computes expected **wire bytes per device** (ring accounting),
expected **latency steps**, and the **algorithmic busbw factor** that
converts measured seconds into the NCCL-tests bus bandwidth (GC3's
observation, PAPERS.md: once a collective is a schedule, its cost is
predictable).  The wire modes and schedules model what the JAX package
runs, a 2-byte container for the quantized wires (the port's int8 sums
in int32 beyond 16 ranks, ``ops/reduction.py``); the port's engine feeds
its monolithic groups with their wire mode and the executor its
``rs_ag:<k>`` windows.

Achieved timings come from the instrumented call sites:

- :meth:`PerfModel.observe` — the port's engine times each fused-group
  dispatch (ops/engine.py): on the CPU over Gloo the host window of the
  synchronous collective, on the card a pair of CUDA timing events
  around the group's work on the engine's stream, read once the group
  has finished (the host window there holds only the NCCL launch);
- :meth:`PerfModel.observe_schedule` — the decomposed schedule's unit
  windows (``ops/sched/executor.py``); :meth:`PerfModel.observe_tiers` —
  the tiered ``hier:<n_local>:<k>`` walk's local and cross windows and
  the standalone two-tier allreduce (``ops/hierarchical.py``).

The two-tier model's tiers on H100s: ``local`` is NVLink inside a node,
``cross`` the inter-node fabric (InfiniBand or RoCE).  The one link
knob, ``HVDTPU_PERF_LINK_GBS`` (with ``HVDTPU_PERF_LINK_LATENCY_US``),
sets the rate every tier is scored at in :meth:`PerfModel.observe_tiers`
and the flat ring's; :func:`hier_split_table` takes each tier's rate
from its caller (the JAX package's autotuner passes the knob as the
cross tier and ten times it as the local one).

Efficiency needs a denominator.  Two sources, in priority order:

1. **Configured link model** (``HVDTPU_PERF_LINK_GBS`` +
   ``HVDTPU_PERF_LINK_LATENCY_US``): expected seconds =
   steps * latency + wire_bytes / (gbs * 1e9); efficiency =
   expected / achieved.  This is the honest mode on hardware whose
   interconnect you know (NVLink within a node).
2. **Rolling observed peak** (default): per ``(verb, tier)`` series the
   model remembers the best achieved busbw and reports efficiency
   relative to it.  Self-calibrating on any rig — exactly what the CPU
   bench rig needs, where "the link" is shared memory and nominal GB/s
   is meaningless — and still surfaces regressions (efficiency sinking
   vs the peak the same process already demonstrated).

All gauges carry ``{verb, mode, schedule, tier}`` so /cluster merges
them per rank and a straggler shows up as one rank's efficiency sitting
under its peers'.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from .registry import REGISTRY

#: ring-accounting per-element wire widths, as the JAX package's
#: ops/reduction.ring_wire_bytes counts them
_CAST_MODES = ("bf16", "fp16")
_QUANT_MODES = ("int8", "fp8")

_m_eff = REGISTRY.gauge(
    "hvd_perf_efficiency",
    "achieved / expected collective performance (1.0 = model bound)",
    ("verb", "mode", "schedule", "tier"))
_m_achieved = REGISTRY.gauge(
    "hvd_perf_achieved_busbw_gbs",
    "latest achieved algorithmic bus bandwidth, GB/s",
    ("verb", "mode", "schedule", "tier"))
_m_expected = REGISTRY.gauge(
    "hvd_perf_expected_busbw_gbs",
    "model-expected bus bandwidth, GB/s (link model or rolling peak)",
    ("verb", "mode", "schedule", "tier"))
_m_obs = REGISTRY.counter(
    "hvd_perf_observations_total",
    "collective timings fed into the performance model", ("verb",))
_m_imbalance = REGISTRY.gauge(
    "hvd_perf_chunk_imbalance",
    "slowest/mean per-chunk comm window of the latest decomposed "
    "schedule (1.0 = perfectly balanced)")
_m_tier_excess = REGISTRY.gauge(
    "hvd_perf_tier_excess_seconds",
    "achieved-minus-expected time attributed to one hierarchy tier "
    "(positive = this tier is the straggler)", ("tier",))
_m_tier_frac = REGISTRY.gauge(
    "hvd_perf_tier_expected_fraction",
    "fraction of total expected collective time the model assigns to "
    "one hierarchy tier", ("tier",))


def wire_per_elem(mode: str, itemsize: int = 4, block: int = 512) -> float:
    """Ring-accounting wire bytes per logical element, both halves
    (reduce-scatter + allgather), before the (n-1)/n fraction."""
    if mode in _CAST_MODES:
        return 4.0
    if mode in _QUANT_MODES:
        return 3.0 + 8.0 / block
    return 2.0 * itemsize


def busbw_factor(verb: str, n: int) -> float:
    """NCCL-tests algbw -> busbw factor: what fraction of the payload
    each device's links actually move."""
    if n <= 1:
        return 0.0
    if verb in ("allreduce", "grouped_allreduce", "adasum_allreduce"):
        return 2.0 * (n - 1) / n
    # allgather / reducescatter / alltoall / broadcast rings all move
    # (n-1)/n of the full payload per device.
    return (n - 1) / n


@dataclasses.dataclass(frozen=True)
class TierCost:
    """Per-tier slice of an expected cost (hierarchical schedules)."""
    wire_bytes: float       # bytes per device moved on this tier
    steps: int              # serial latency steps on this tier


@dataclasses.dataclass(frozen=True)
class ExpectedCost:
    """Analytic cost of one collective on ``n`` ranks.

    ``wire_bytes`` is per device (ring accounting); ``steps`` is the
    serial latency-step count of the critical path; ``busbw_factor``
    converts ``payload_bytes / seconds`` (algbw) into busbw.
    """
    verb: str
    mode: str
    schedule: str
    n: int
    payload_bytes: int
    wire_bytes: float
    steps: int
    busbw_factor: float
    tiers: dict = dataclasses.field(default_factory=dict)

    def expected_seconds(self, gbs: float, latency_us: float) -> float:
        """Link-model time: serial step latency + wire transfer."""
        if gbs <= 0:
            raise ValueError("link GB/s must be positive")
        return (self.steps * latency_us * 1e-6
                + self.wire_bytes / (gbs * 1e9))


def expected_allreduce(payload_bytes: int, n: int, *, mode: str = "fp32",
                       chunks: int = 1, block: int = 512,
                       itemsize: int = 4,
                       compiled: bool = False) -> ExpectedCost:
    """Monolithic (chunks=1) or rs_ag-decomposed (chunks=k) allreduce.

    Chunking does not change total wire bytes — every chunk still rides
    a full reduce-scatter + allgather ring — but it multiplies latency
    steps (each chunk pays its own 2*(n-1) hops) while buying the
    executor room to overlap chunk c+1's comm under chunk c's compute.

    ``compiled=True`` models the single-program GSPMD backend: the same
    wire bytes, but the per-chunk dispatch latency collapses back to one
    ring's 2*(n-1) steps — XLA pipelines the chunks inside one
    executable, so the host pays one dispatch regardless of k.  That
    deleted ``(k-1) * 2*(n-1)`` step term is exactly the dispatch-bound
    overhead the compiled path exists to remove.
    """
    if n < 1 or payload_bytes < 0:
        raise ValueError(f"bad inputs n={n} bytes={payload_bytes}")
    mode = mode or "fp32"
    numel = payload_bytes / max(1, itemsize)
    frac = (n - 1) / n if n > 1 else 0.0
    wire = frac * wire_per_elem(mode, itemsize, block) * numel
    k = max(1, int(chunks))
    if compiled:
        steps = 2 * (n - 1) if n > 1 else 0
        sched = f"compiled:rs_ag:{k}"
    else:
        steps = 2 * (n - 1) * k if n > 1 else 0
        sched = "monolithic" if k == 1 else f"rs_ag:{k}"
    return ExpectedCost(verb="allreduce", mode=mode, schedule=sched,
                        n=n, payload_bytes=payload_bytes, wire_bytes=wire,
                        steps=steps, busbw_factor=busbw_factor(
                            "allreduce", n))


def expected_collective(verb: str, payload_bytes: int, n: int, *,
                        itemsize: int = 4) -> ExpectedCost:
    """Single-phase verbs: allgather / reducescatter / alltoall /
    broadcast.  ``payload_bytes`` is the full (gathered / scattered)
    logical payload; each device moves its (n-1)/n share once."""
    if n < 1 or payload_bytes < 0:
        raise ValueError(f"bad inputs n={n} bytes={payload_bytes}")
    frac = (n - 1) / n if n > 1 else 0.0
    wire = frac * payload_bytes
    steps = (n - 1) if n > 1 else 0
    return ExpectedCost(verb=verb, mode="fp32", schedule="monolithic",
                        n=n, payload_bytes=payload_bytes, wire_bytes=wire,
                        steps=steps, busbw_factor=busbw_factor(verb, n))


def expected_zero_step(payload_bytes: int, n: int, *, mode: str = "fp32",
                       chunks: int = 1, block: int = 512,
                       itemsize: int = 4, param_bytes: Optional[int] = None,
                       compiled: bool = False) -> ExpectedCost:
    """ZeRO-1 sharded-optimizer step (optim/zero.py): the gradient rides
    ONLY the reduce-scatter half of the rs_ag chain (no gradient
    allgather — the shard stays local for the sharded update), and one
    *parameter* allgather closes the step.

    Wire accounting per device: rs moves ``(n-1)/n`` of the gradient at
    half the allreduce per-element width (the rs half of
    :func:`wire_per_elem`); the parameter allgather moves ``(n-1)/n`` of
    ``param_bytes`` raw (parameters never quantize — the update must be
    bit-exact across ranks).  For fp32 with ``param_bytes ==
    payload_bytes`` this sums to exactly the dense allreduce wire — the
    ZeRO-1 claim: optimizer memory /n at identical wire bytes.  Under a
    quant wire mode only the rs half keeps the narrow width; the raw
    parameter allgather costs more than dense's quantized allgather
    half, so quant ZeRO trades some wire for the exactness of the
    parameter broadcast — the model makes that visible rather than
    hiding it.  Steps: ``(n-1)`` per rs chunk plus
    one allgather ring; ``compiled=True`` collapses the per-chunk
    dispatch latency the same way :func:`expected_allreduce` does.
    """
    if n < 1 or payload_bytes < 0:
        raise ValueError(f"bad inputs n={n} bytes={payload_bytes}")
    mode = mode or "fp32"
    pbytes = payload_bytes if param_bytes is None else param_bytes
    numel = payload_bytes / max(1, itemsize)
    frac = (n - 1) / n if n > 1 else 0.0
    rs_wire = frac * (wire_per_elem(mode, itemsize, block) / 2.0) * numel
    ag_wire = frac * float(pbytes)
    k = max(1, int(chunks))
    if compiled:
        steps = 2 * (n - 1) if n > 1 else 0
        sched = f"zero1:compiled:rs_ag:{k}"
    else:
        steps = ((n - 1) * k + (n - 1)) if n > 1 else 0
        sched = f"zero1:rs_ag:{k}"
    return ExpectedCost(verb="zero_step", mode=mode, schedule=sched,
                        n=n, payload_bytes=payload_bytes,
                        wire_bytes=rs_wire + ag_wire, steps=steps,
                        busbw_factor=busbw_factor("allreduce", n),
                        tiers={"rs": TierCost(rs_wire,
                                              (n - 1) * k if n > 1 else 0),
                               "param_ag": TierCost(ag_wire,
                                                    n - 1 if n > 1 else 0)})


def expected_hierarchical(payload_bytes: int, n_local: int, n_cross: int,
                          *, itemsize: int = 4, mode: str = "fp32",
                          cross_mode: str = "", chunks: int = 1,
                          block: int = 512) -> ExpectedCost:
    """Two-tier allreduce (ops/hierarchical.py, sched executor hier path):
    reduce_scatter@local -> all_reduce@cross -> all_gather@local.

    Per chip: the local tier carries a reduce-scatter plus an allgather
    of the full payload B (2 * (n_l-1)/n_l * B); the cross tier carries
    a full allreduce of the local shard B/n_l (2 * (n_c-1)/n_c * B/n_l)
    — the 1/n_local factor is THE hierarchy win on a slow cross fabric.

    Each tier rides its own wire mode (``cross_mode`` defaults to
    ``mode``; e.g. fp32 local + int8 cross) and chunking multiplies each
    tier's latency steps without changing wire bytes, exactly like
    :func:`expected_allreduce`.
    """
    if n_local < 1 or n_cross < 1:
        raise ValueError("tier sizes must be >= 1")
    mode = mode or "fp32"
    cmode = cross_mode or mode
    k = max(1, int(chunks))
    B = float(payload_bytes)
    numel = B / max(1, itemsize)
    fl = (n_local - 1) / n_local if n_local > 1 else 0.0
    fc = (n_cross - 1) / n_cross if n_cross > 1 else 0.0
    wl = wire_per_elem(mode, itemsize, block) / (2.0 * itemsize)
    wc = wire_per_elem(cmode, itemsize, block) / (2.0 * itemsize)
    local = TierCost(wire_bytes=2.0 * fl * B * wl,
                     steps=2 * (n_local - 1) * k if n_local > 1 else 0)
    cross = TierCost(wire_bytes=2.0 * fc * (B / n_local) * wc,
                     steps=2 * (n_cross - 1) * k if n_cross > 1 else 0)
    n = n_local * n_cross
    sched = "hier" if k == 1 else f"hier:{n_local}:{k}"
    label = mode if cmode == mode else f"{mode}/{cmode}"
    return ExpectedCost(
        verb="allreduce", mode=label, schedule=sched, n=n,
        payload_bytes=payload_bytes,
        wire_bytes=local.wire_bytes + cross.wire_bytes,
        steps=local.steps + cross.steps,
        busbw_factor=busbw_factor("allreduce", n),
        tiers={"local": local, "cross": cross})


def hier_split_table(payload_sizes, n: int, n_local: int, *,
                     mode: str = "fp32", cross_mode: str = "",
                     chunks: int = 1, block: int = 512, itemsize: int = 4,
                     gbs_local: float, gbs_cross: float,
                     latency_us: float = 1.0,
                     phase_overhead_us: float = 20.0) -> list:
    """Per-message-size flat-vs-hierarchical decision table (HiCCL's
    level-split selection, scored by this model's per-tier costs).

    A flat ring over a two-tier fabric is bottlenecked by its slowest
    hop — every ring step crosses the slow fabric at least once per
    round — so flat is scored at ``gbs_cross``; the hierarchical
    schedule pays the full local volume at ``gbs_local`` plus only the
    1/n_local shard at ``gbs_cross``.  Small messages go flat:
    ``phase_overhead_us`` charges the host-side dispatch of each
    pipeline phase (flat rides one fused program per chunk; the tiered
    path dispatches three per chunk), which dominates until the wire
    term takes over.  Returns one row per size: ``{payload_bytes,
    flat_seconds, hier_seconds, split}`` with ``split`` in
    ``("flat", "hier")``.
    """
    if n_local < 2 or n % n_local:
        raise ValueError(f"n_local={n_local} does not tier n={n}")
    n_cross = n // n_local
    k = max(1, int(chunks))
    rows = []
    for B in payload_sizes:
        flat = expected_allreduce(B, n, mode=mode, chunks=chunks,
                                  block=block, itemsize=itemsize)
        flat_s = (flat.expected_seconds(gbs_cross, latency_us)
                  + k * phase_overhead_us * 1e-6)
        hier = expected_hierarchical(
            B, n_local, n_cross, itemsize=itemsize, mode=mode,
            cross_mode=cross_mode, chunks=chunks, block=block)
        hier_s = 3 * k * phase_overhead_us * 1e-6
        for name, gbs in (("local", gbs_local), ("cross", gbs_cross)):
            tc = hier.tiers[name]
            hier_s += (tc.steps * latency_us * 1e-6
                       + tc.wire_bytes / (max(1e-9, gbs) * 1e9))
        rows.append({"payload_bytes": int(B),
                     "flat_seconds": flat_s,
                     "hier_seconds": hier_s,
                     "split": "hier" if hier_s < flat_s else "flat"})
    return rows


class PerfModel:
    """Process-wide expected-vs-achieved tracker behind the
    ``hvd_perf_*`` gauges.  Fed by the engine, the sched executor, the
    hierarchical path and the benchmarks; configured (link model) from
    ``hvd.init()``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._link_gbs = 0.0          # 0 = rolling-peak calibration
        self._link_latency_us = 1.0
        self._peaks: dict = {}        # (verb, tier) -> best busbw GB/s
        self._last: dict = {}         # (verb, mode, schedule, tier) -> row

    def configure(self, *, link_gbs: float = 0.0,
                  link_latency_us: float = 1.0) -> None:
        with self._lock:
            self._link_gbs = float(link_gbs)
            self._link_latency_us = float(link_latency_us)

    def reset(self) -> None:
        with self._lock:
            self._peaks.clear()
            self._last.clear()

    # -- core -------------------------------------------------------------

    def record(self, cost: ExpectedCost, seconds: float, *,
               tier: str = "flat") -> Optional[dict]:
        """Fold one achieved timing against its expected cost; returns
        the attribution row (also kept for :meth:`summary`).  n<=1 or
        degenerate timings are ignored — there is no wire to model."""
        if cost.n <= 1 or seconds <= 0 or cost.payload_bytes <= 0:
            return None
        achieved_busbw = (cost.busbw_factor * cost.payload_bytes
                          / seconds) / 1e9
        with self._lock:
            link_gbs = self._link_gbs
            latency_us = self._link_latency_us
            if link_gbs > 0:
                expected_s = cost.expected_seconds(link_gbs, latency_us)
                expected_busbw = (cost.busbw_factor * cost.payload_bytes
                                  / expected_s) / 1e9
                efficiency = expected_s / seconds
                basis = "link"
            else:
                pk = self._peaks.get((cost.verb, tier), 0.0)
                pk = max(pk, achieved_busbw)
                self._peaks[(cost.verb, tier)] = pk
                expected_busbw = pk
                efficiency = achieved_busbw / pk if pk > 0 else 0.0
                basis = "peak"
            row = {
                "verb": cost.verb, "mode": cost.mode,
                "schedule": cost.schedule, "tier": tier,
                "n": cost.n, "payload_bytes": cost.payload_bytes,
                "expected_wire_bytes": cost.wire_bytes,
                "expected_steps": cost.steps,
                "seconds": seconds,
                "achieved_busbw_gbs": achieved_busbw,
                "expected_busbw_gbs": expected_busbw,
                "efficiency": efficiency,
                "basis": basis,
            }
            self._last[(cost.verb, cost.mode, cost.schedule, tier)] = row
        lbl = dict(verb=cost.verb, mode=cost.mode,
                   schedule=cost.schedule, tier=tier)
        _m_eff.labels(**lbl).set(efficiency)
        _m_achieved.labels(**lbl).set(achieved_busbw)
        _m_expected.labels(**lbl).set(expected_busbw)
        _m_obs.labels(verb=cost.verb).inc()
        return row

    # -- call-site entry points ------------------------------------------

    def observe(self, verb: str, payload_bytes: int, n: int,
                seconds: float, *, mode: str = "fp32",
                schedule: str = "monolithic", chunks: int = 1,
                block: int = 512, itemsize: int = 4) -> Optional[dict]:
        """One fenced/monolithic timing (engine dispatch or bench loop)."""
        try:
            if verb in ("allreduce", "grouped_allreduce",
                        "adasum_allreduce"):
                cost = expected_allreduce(
                    payload_bytes, n, mode=mode, chunks=chunks,
                    block=block, itemsize=itemsize)
                if schedule not in ("", "monolithic") and chunks == 1:
                    cost = dataclasses.replace(cost, schedule=schedule)
            else:
                cost = expected_collective(verb, payload_bytes, n,
                                           itemsize=itemsize)
            return self.record(cost, seconds)
        except Exception:
            return None  # telemetry must never break the dispatch path

    def observe_schedule(self, *, descriptor: str, mode: str,
                         payload_bytes: int, n: int, chunks: int,
                         comm_windows, compute_windows,
                         block: int = 512,
                         itemsize: int = 4) -> Optional[dict]:
        """Achieved timing for a decomposed rs_ag schedule, from the
        executor's per-step dispatch windows.

        The achieved wall-clock is the union span of all windows (first
        open to last close) — the host-observed in-flight time of the
        whole pipeline; per-chunk comm windows additionally yield the
        chunk-imbalance straggler gauge (slowest chunk / mean chunk).
        """
        try:
            spans = list(comm_windows) + list(compute_windows)
            if not spans:
                return None
            t0 = min(s[0] for s in spans)
            t1 = max(s[1] for s in spans)
            seconds = t1 - t0
            cost = expected_allreduce(
                payload_bytes, n, mode=mode, chunks=max(1, chunks),
                block=block, itemsize=itemsize,
                compiled=(descriptor or "").startswith("compiled:"))
            if descriptor:
                cost = dataclasses.replace(cost, schedule=descriptor)
            row = self.record(cost, seconds)
            durs = [max(0.0, b - a) for a, b in comm_windows]
            if len(durs) >= 2:
                mean = sum(durs) / len(durs)
                if mean > 0:
                    _m_imbalance.set(max(durs) / mean)
            return row
        except Exception:
            return None

    def observe_tiers(self, payload_bytes: int, n_local: int,
                      n_cross: int, seconds: float, *,
                      tier_seconds: Optional[dict] = None,
                      mode: str = "fp32", cross_mode: str = "",
                      chunks: int = 1, schedule: str = "",
                      block: int = 512, itemsize: int = 4) -> dict:
        """Two-tier attribution (ROADMAP item 3's straggler feed).

        With measured per-tier times, excess = achieved - expected per
        tier directly; without, the total excess over the model is
        apportioned by each tier's expected share — coarse, but it
        points at the tier that dominates the bound, which is the
        decision the two-tier lowering needs.
        """
        cost = expected_hierarchical(
            payload_bytes, n_local, n_cross, itemsize=itemsize,
            mode=mode, cross_mode=cross_mode, chunks=chunks, block=block)
        if schedule:
            cost = dataclasses.replace(cost, schedule=schedule)
        total_wire = max(1e-12, cost.wire_bytes)
        out = {}
        with self._lock:
            link_gbs = self._link_gbs
            latency_us = self._link_latency_us
        for name, tc in cost.tiers.items():
            frac = tc.wire_bytes / total_wire
            _m_tier_frac.labels(tier=name).set(frac)
            # Expected seconds on this tier: link model when configured,
            # else the tier's proportional share of the achieved total
            # (excess then only shows up with measured per-tier times).
            if link_gbs > 0:
                exp_s = (tc.steps * latency_us * 1e-6
                         + tc.wire_bytes / (link_gbs * 1e9))
            else:
                exp_s = frac * max(0.0, seconds)
            achieved_s = (tier_seconds or {}).get(name, exp_s if
                                                  link_gbs <= 0 else
                                                  frac * seconds)
            excess = achieved_s - exp_s
            _m_tier_excess.labels(tier=name).set(excess)
            out[name] = {"expected_fraction": frac,
                         "expected_wire_bytes": tc.wire_bytes,
                         "steps": tc.steps, "excess_seconds": excess}
        self.record(cost, seconds, tier="hier")
        return out

    # -- views ------------------------------------------------------------

    def summary(self) -> list:
        """Latest attribution row per (verb, mode, schedule, tier)."""
        with self._lock:
            return [dict(v) for _, v in sorted(self._last.items())]


#: process-wide model instance every call site feeds
MODEL = PerfModel()

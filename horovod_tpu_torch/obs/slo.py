"""Declarative SLO engine: objectives over registry histograms, with
multi-window burn rates.

A copy of the JAX package's ``obs/slo.py`` for the port.  The signal
aliases name the same histograms in both packages: the engine's
``hvd_cycle_seconds``, the negotiator's ``hvd_negotiate_wait_seconds``
and serving's ``hvd_serving_{ttft,itl,queue_wait}_seconds``.

The metrics plane records *what happened*; an autoscaler or router needs
*is the job meeting its objective right now* as one number.  This module
evaluates declarative specs like ::

    p99(ttft) < 250ms over 5m

directly against the registry's log-bucketed histograms and publishes

- ``hvd_slo_attainment{slo}`` — fraction of events inside the threshold
  over the spec's window (1.0 = all good; the SLO is met while
  attainment >= the objective, e.g. 0.99 for a p99 spec);
- ``hvd_slo_burn_rate{slo,window}`` — error-budget burn per window
  (Google SRE multi-window convention: **fast 5m / slow 1h**).  Burn 1.0
  = consuming budget exactly at the allowed rate; >1 on both windows is
  the page condition (fast alone is noise, slow alone is stale);
- ``hvd_slo_objective{slo}`` — the target fraction, so dashboards need
  no out-of-band config;
- ``hvd_slo_violations_total{slo}`` — transitions from met to violated.

Because these land in the process registry, the existing
:mod:`.aggregate` snapshot path publishes them to
``/cluster`` for free: a router or an autoscaler gets one scrape to act
on.

**Windowing over cumulative histograms.**  Registry histograms are
cumulative since process start; the engine keeps a bounded ring of
periodic bucket snapshots per metric and evaluates each window as the
delta between "now" and the snapshot nearest ``now - window`` (partial
history is used while the process is younger than the window — standard
burn-rate behavior).  The good-event fraction below a threshold is read
from the cumulative bucket counts with linear interpolation inside the
containing bucket (the ``histogram_quantile`` convention), so log-spaced
edges cost at most one bucket's relative resolution, never a cliff.

Stdlib-only; specs are armed from config (``Config.slo`` /
``HOROVOD_TPU_SLO``, semicolon-separated ``[name=]spec`` entries) at
``hvd.init()`` or programmatically via :class:`SLOEngine`.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Callable, Optional, Sequence

from .registry import Histogram, MetricRegistry, REGISTRY

#: serving/engine signal aliases -> registry histogram names, so specs
#: read as intent ("ttft") rather than series plumbing.
SIGNALS = {
    "ttft": "hvd_serving_ttft_seconds",
    "itl": "hvd_serving_itl_seconds",
    "queue_wait": "hvd_serving_queue_wait_seconds",
    "negotiate_wait": "hvd_negotiate_wait_seconds",
    "cycle": "hvd_cycle_seconds",
}

_UNITS_S = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0}
_WINDOW_S = {"s": 1.0, "m": 60.0, "h": 3600.0}

#: the multi-window burn-rate pair (label, seconds): fast / slow.
BURN_WINDOWS = (("5m", 300.0), ("1h", 3600.0))

_SPEC_RE = re.compile(
    r"^\s*p(?P<q>\d+(?:\.\d+)?)\s*\(\s*(?P<sig>[a-zA-Z_:][\w:]*)\s*\)"
    r"\s*<=?\s*(?P<val>\d+(?:\.\d+)?)\s*(?P<unit>ns|us|ms|s)?"
    r"(?:\s+over\s+(?P<win>\d+(?:\.\d+)?)\s*(?P<winunit>[smh]))?\s*$")


class SLOError(ValueError):
    """Unparseable spec or unknown/unsuitable metric."""


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One parsed objective: ``quantile`` of ``metric`` must stay under
    ``threshold_s``, evaluated over ``window_s``."""

    name: str
    metric: str                 # registry histogram family name
    quantile: float             # 0.99 for p99
    threshold_s: float
    window_s: float = 300.0

    @property
    def objective(self) -> float:
        """Required good-event fraction (= the quantile)."""
        return self.quantile

    @property
    def budget(self) -> float:
        """Allowed bad-event fraction (1 - objective)."""
        return 1.0 - self.quantile

    def describe(self) -> str:
        return (f"p{self.quantile * 100:g}({self.metric}) < "
                f"{self.threshold_s:g}s over {self.window_s:g}s")


def parse_spec(spec: str, name: Optional[str] = None) -> SLOSpec:
    """``p99(ttft) < 250ms over 5m`` -> :class:`SLOSpec`.  The signal is
    an alias from :data:`SIGNALS` or a literal histogram family name;
    a bare value is seconds; ``over`` defaults to 5m."""
    m = _SPEC_RE.match(spec)
    if not m:
        raise SLOError(
            f"cannot parse SLO spec {spec!r} (want e.g. "
            "'p99(ttft) < 250ms over 5m')")
    q = float(m.group("q")) / 100.0
    if not 0.0 < q < 1.0:
        raise SLOError(f"quantile p{m.group('q')} out of range (0, 100)")
    sig = m.group("sig")
    metric = SIGNALS.get(sig, sig)
    threshold = float(m.group("val")) * _UNITS_S[m.group("unit") or "s"]
    if threshold <= 0:
        raise SLOError(f"threshold must be > 0 in {spec!r}")
    window = (float(m.group("win")) * _WINDOW_S[m.group("winunit")]
              if m.group("win") else 300.0)
    return SLOSpec(name=name or f"{sig}_p{m.group('q').replace('.', '_')}",
                   metric=metric, quantile=q, threshold_s=threshold,
                   window_s=window)


def parse_spec_list(specs: str) -> list:
    """``"a=p99(ttft)<250ms over 5m; p95(itl)<50ms"`` -> [SLOSpec, ...]
    (the ``Config.slo`` / env surface; ``name=`` optional)."""
    out = []
    for part in specs.split(";"):
        part = part.strip()
        if not part:
            continue
        name = None
        if "=" in part.split("(", 1)[0]:
            name, _, part = part.partition("=")
            name = name.strip()
        out.append(parse_spec(part.strip(), name))
    return out


# ---------------------------------------------------------------------------
# histogram math (pure; unit-tested against hand-built histograms)
# ---------------------------------------------------------------------------

def good_fraction(edges: Sequence[float], cum_counts: Sequence[int],
                  threshold: float) -> float:
    """Fraction of observations <= ``threshold`` from cumulative bucket
    counts (``cum_counts[i]`` = observations <= ``edges[i]``, with one
    final +Inf entry).  Linear interpolation inside the containing
    bucket; observations beyond the last finite edge count as bad when
    the threshold exceeds it (conservative).  1.0 on an empty window —
    no traffic cannot violate an SLO."""
    total = cum_counts[-1]
    if total <= 0:
        return 1.0
    i = bisect_left(edges, threshold)
    if i >= len(edges):                 # threshold past the last edge:
        good = cum_counts[len(edges) - 1]   # +Inf bucket is unknowable
    elif edges[i] == threshold:
        good = cum_counts[i]
    elif i == 0:
        good = cum_counts[0] * (threshold / edges[0])
    else:
        lo, hi = edges[i - 1], edges[i]
        span = cum_counts[i] - cum_counts[i - 1]
        good = cum_counts[i - 1] + span * (threshold - lo) / (hi - lo)
    return min(1.0, max(0.0, good / total))


def quantile(edges: Sequence[float], cum_counts: Sequence[int],
             q: float) -> Optional[float]:
    """Histogram quantile (the ``histogram_quantile`` convention: linear
    within the bucket, last finite edge when the quantile lands in
    +Inf).  None on an empty histogram."""
    total = cum_counts[-1]
    if total <= 0:
        return None
    target = q * total
    for i, c in enumerate(cum_counts[:-1]):
        if c >= target:
            lo = edges[i - 1] if i else 0.0
            prev = cum_counts[i - 1] if i else 0
            span = c - prev
            if span <= 0:
                return edges[i]
            return lo + (edges[i] - lo) * (target - prev) / span
    return edges[-1]


def attainment_of(values: Sequence[float], threshold: float) -> float:
    """Plain-list attainment (the serving bench's offline form)."""
    vals = list(values)
    if not vals:
        return 1.0
    return sum(1 for v in vals if v <= threshold) / len(vals)


def cum_counts(metric: str,
               registry: Optional[MetricRegistry] = None):
    """Children-summed cumulative bucket counts of one histogram family
    as ``(edges, counts)`` (finite edges; counts has one final +Inf
    entry), read atomically — ``(None, None)`` when the family is
    missing or not a histogram.  The one sanctioned way to read a
    registry histogram for SLO math (the engine and the serving bench
    both evaluate through this)."""
    reg = registry or REGISTRY
    fam = reg.get(metric)
    if not isinstance(fam, Histogram):
        return None, None
    with reg._lock:
        per_child = [c.cumulative_buckets()
                     for c in fam._children.values()]
    cum = [0] * (len(fam.buckets) + 1)
    for buckets in per_child:
        for i, (_, c) in enumerate(buckets):
            cum[i] += c
    return tuple(fam.buckets), cum


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class _HistHistory:
    """Bounded ring of (t, cumulative bucket counts) snapshots for one
    histogram family (children summed: SLO signals are process-level)."""

    __slots__ = ("edges", "snaps")

    def __init__(self, edges) -> None:
        self.edges = tuple(edges)
        self.snaps: deque = deque()

    def push(self, t: float, cum: list, horizon_s: float) -> None:
        self.snaps.append((t, cum))
        while len(self.snaps) > 2 and self.snaps[1][0] < t - horizon_s:
            self.snaps.popleft()

    def delta_since(self, t_from: float) -> Optional[list]:
        """Bucket-count delta between the newest snapshot and the newest
        snapshot taken at or before ``t_from`` (the oldest held snapshot
        when history is shorter than the window)."""
        if not self.snaps:
            return None
        base = self.snaps[0]
        for snap in self.snaps:
            if snap[0] <= t_from:
                base = snap
            else:
                break
        now = self.snaps[-1]
        return [n - b for n, b in zip(now[1], base[1])]


class SLOEngine:
    """Evaluates a set of :class:`SLOSpec` against one registry.

    Drive it manually (``tick()`` then ``evaluate()`` — the deterministic
    mode tests and the bench use, with an injectable ``clock``) or as a
    daemon thread (:meth:`start`), which does both every ``tick_s``."""

    def __init__(self, *, registry: Optional[MetricRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tick_s: float = 10.0,
                 burn_windows=BURN_WINDOWS) -> None:
        self.registry = registry or REGISTRY
        self._clock = clock
        self.tick_s = max(0.5, float(tick_s))
        self.burn_windows = tuple(burn_windows)
        self._specs: dict[str, SLOSpec] = {}
        self._hist: dict[str, _HistHistory] = {}
        self._met: dict[str, bool] = {}
        self._lock = threading.Lock()
        # Guards _hist (ring reads/writes): the daemon's tick/evaluate
        # and a caller's status() run concurrently by design.
        self._hist_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._g_attain = self.registry.gauge(
            "hvd_slo_attainment",
            "fraction of events meeting the SLO threshold over the "
            "spec window (SLO met while >= hvd_slo_objective)", ("slo",))
        self._g_burn = self.registry.gauge(
            "hvd_slo_burn_rate",
            "error-budget burn per window (1.0 = burning exactly the "
            "allowed budget; >1 on fast AND slow windows = page)",
            ("slo", "window"))
        self._g_objective = self.registry.gauge(
            "hvd_slo_objective",
            "required good-event fraction of the SLO", ("slo",))
        self._c_violations = self.registry.counter(
            "hvd_slo_violations_total",
            "met -> violated transitions of the SLO", ("slo",))

    # -- spec management --------------------------------------------------
    def add(self, spec, name: Optional[str] = None) -> SLOSpec:
        if isinstance(spec, str):
            spec = parse_spec(spec, name)
        elif name:
            spec = dataclasses.replace(spec, name=name)
        with self._lock:
            self._specs[spec.name] = spec
        self._g_objective.labels(slo=spec.name).set(spec.objective)
        return spec

    @property
    def specs(self) -> list:
        with self._lock:
            return list(self._specs.values())

    def _horizon_s(self) -> float:
        wins = [w for _, w in self.burn_windows]
        wins += [s.window_s for s in self.specs]
        return max(wins) + 2 * self.tick_s

    # -- sampling ---------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        """Snapshot every spec'd histogram into its history ring."""
        now = self._clock() if now is None else now
        horizon = self._horizon_s()
        for spec in self.specs:
            edges, cum = cum_counts(spec.metric, self.registry)
            if edges is None:
                continue            # not registered yet: no traffic
            with self._hist_lock:
                hist = self._hist.get(spec.metric)
                if hist is None or hist.edges != edges:
                    hist = self._hist[spec.metric] = _HistHistory(edges)
                    # Zero baseline: traffic recorded before the engine
                    # first saw this family counts toward the first
                    # window instead of vanishing into a zero delta.
                    hist.push(now, [0] * (len(edges) + 1), horizon)
                hist.push(now, cum, horizon)

    # -- evaluation -------------------------------------------------------
    def _window_attainment(self, spec: SLOSpec, window_s: float,
                           now: float) -> Optional[float]:
        with self._hist_lock:
            hist = self._hist.get(spec.metric)
            if hist is None:
                return None
            delta = hist.delta_since(now - window_s)
        if delta is None:
            return None
        return good_fraction(hist.edges, delta, spec.threshold_s)

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One pass: publish attainment / burn-rate / violation series
        for every spec; returns ``{slo: {...}}`` for programmatic use
        (the bench and ``status()``)."""
        now = self._clock() if now is None else now
        out: dict = {}
        for spec in self.specs:
            attain = self._window_attainment(spec, spec.window_s, now)
            attain = 1.0 if attain is None else attain
            self._g_attain.labels(slo=spec.name).set(attain)
            burns = {}
            for label, win_s in self.burn_windows:
                a = self._window_attainment(spec, win_s, now)
                a = 1.0 if a is None else a
                burn = (1.0 - a) / spec.budget if spec.budget > 0 else 0.0
                self._g_burn.labels(slo=spec.name, window=label).set(burn)
                burns[label] = burn
            met = attain >= spec.objective
            if self._met.get(spec.name, True) and not met:
                self._c_violations.labels(slo=spec.name).inc()
                from ..utils import logging as hvd_logging
                hvd_logging.get_logger().warning(
                    "SLO %s violated: attainment %.4f < objective %.4f "
                    "(%s; burn %s)", spec.name, attain, spec.objective,
                    spec.describe(),
                    ", ".join(f"{k}={v:.2f}" for k, v in burns.items()))
            self._met[spec.name] = met
            out[spec.name] = {"attainment": attain, "met": met,
                              "objective": spec.objective,
                              "burn_rate": burns,
                              "spec": spec.describe()}
        return out

    def status(self) -> dict:
        """Evaluate-and-return without waiting for the next tick (takes
        a fresh histogram sample first)."""
        self.tick()
        return self.evaluate()

    # -- daemon -----------------------------------------------------------
    def start(self) -> "SLOEngine":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                    self.evaluate()
                except Exception:   # telemetry never kills the job
                    from ..utils import logging as hvd_logging
                    hvd_logging.get_logger().exception(
                        "SLO engine tick failed")
                self._stop.wait(self.tick_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="hvdtpu-slo")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# process-wide wiring (context.init()/shutdown())
# ---------------------------------------------------------------------------

_engine: Optional[SLOEngine] = None
_wiring_lock = threading.Lock()


def arm(specs: str, *, tick_s: float = 10.0) -> Optional[SLOEngine]:
    """Start the process-wide SLO engine from a spec-list string
    (``Config.slo``); restarts cleanly on elastic re-init."""
    global _engine
    with _wiring_lock:
        if _engine is not None:
            _engine.stop()
            _engine = None
        parsed = parse_spec_list(specs)
        if not parsed:
            return None
        eng = SLOEngine(tick_s=tick_s)
        for spec in parsed:
            eng.add(spec)
        _engine = eng.start()
        return _engine


def disarm() -> None:
    global _engine
    with _wiring_lock:
        if _engine is not None:
            _engine.stop()
            _engine = None


def status() -> dict:
    """Current SLO evaluation of the armed engine ({} when unarmed)."""
    with _wiring_lock:
        eng = _engine
    return eng.status() if eng is not None else {}

"""Process-wide metrics registry: counters, gauges, log-bucketed histograms.

Upstream Horovod's operational surface stops at the Chrome-trace timeline
(† ``timeline.cc``), the stall inspector's log lines and
``HOROVOD_LOG_LEVEL`` — there is no queryable runtime state.  This module
is the telemetry plane the rebuild's three hot subsystems (fusion engine,
paged-KV serving, elastic runner) report into: a single process-wide
registry of named metrics, snapshotted atomically.  In this package the
serving plane reports into it; Prometheus/JSON exposition arrives with the
observability slice.

Design constraints:

- **Dependency-free** — stdlib only, importable before (and without)
  torch; the instrumented modules import it at module scope, so anything
  heavier would tax every ``import horovod_tpu_torch``.
- **Cheap on the hot path** — one enabled-flag check plus one lock'd
  float add per event.  ``MetricRegistry.disable()`` turns every
  recording call into a no-op (the serving benchmark measures the
  enabled-vs-disabled overhead; budget <2%).
- **Prometheus-shaped** — counter / gauge / histogram with labels,
  histogram buckets are cumulative-ready upper edges, so exposition is a
  straight serialization, no adaptation layer.

Histograms default to log-spaced (power-of-two) bucket edges: latency and
byte-size distributions span orders of magnitude, and log buckets give
constant relative resolution with a bounded series count.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Optional, Sequence

#: default log-spaced bucket edges for seconds-valued histograms:
#: 2^-17 (~7.6 us) .. 2^6 (64 s), constant x2 relative resolution.
DEFAULT_TIME_BUCKETS = tuple(2.0 ** e for e in range(-17, 7))

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class MetricError(ValueError):
    """Registry misuse: bad name, kind conflict, wrong label set."""


# ---------------------------------------------------------------------------
# Children: one per label combination, holding the actual values.
# ---------------------------------------------------------------------------

class _CounterChild:
    __slots__ = ("_reg", "_value")

    def __init__(self, reg: "MetricRegistry") -> None:
        self._reg = reg
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricError("counters only go up; use a gauge")
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0


class _GaugeChild:
    __slots__ = ("_reg", "_value")

    def __init__(self, reg: "MetricRegistry") -> None:
        self._reg = reg
        self._value = 0.0

    def set(self, value: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0


class _HistogramChild:
    __slots__ = ("_reg", "_edges", "_counts", "_sum", "_count")

    def __init__(self, reg: "MetricRegistry",
                 edges: Sequence[float]) -> None:
        self._reg = reg
        self._edges = tuple(edges)
        # counts[i] = observations in (edges[i-1], edges[i]];
        # counts[-1] = observations above the last edge (the +Inf bucket).
        self._counts = [0] * (len(self._edges) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        v = float(value)
        # Prometheus ``le`` is an inclusive upper bound: a value exactly on
        # an edge lands in that edge's bucket (bisect_left gives its index).
        i = bisect_left(self._edges, v)
        with reg._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    def cumulative_buckets(self) -> list:
        """``[(upper_edge, cumulative_count), ...]`` ending at +Inf."""
        out = []
        acc = 0
        for edge, c in zip(self._edges, self._counts):
            acc += c
            out.append((edge, acc))
        out.append((math.inf, acc + self._counts[-1]))
        return out

    def _reset(self) -> None:
        self._counts = [0] * (len(self._edges) + 1)
        self._sum = 0.0
        self._count = 0


# ---------------------------------------------------------------------------
# Families: name + help + labelnames; label() fans out to children.
# ---------------------------------------------------------------------------

class MetricFamily:
    kind = "untyped"

    def __init__(self, registry: "MetricRegistry", name: str,
                 help: str = "", labelnames: Sequence[str] = ()) -> None:
        if not _NAME_RE.match(name):
            raise MetricError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise MetricError(f"bad label name {ln!r} on {name}")
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **labelvalues):
        """Child metric for one label combination (created on first use)."""
        if set(labelvalues) != set(self.labelnames):
            raise MetricError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        with self._registry._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
        return child

    def _default(self):
        if self.labelnames:
            raise MetricError(
                f"{self.name} has labels {self.labelnames}; call "
                ".labels(...) first")
        return self._children[()]

    def total(self) -> float:
        """Sum of all children's scalar values (counter/gauge families);
        feeds the Timeline-v2 counter events."""
        with self._registry._lock:
            return sum(c.value for c in self._children.values())

    def _samples(self) -> list:
        out = []
        for key, child in sorted(self._children.items()):
            labels = dict(zip(self.labelnames, key))
            out.append(self._sample_of(labels, child))
        return out

    def _sample_of(self, labels: dict, child) -> dict:
        return {"labels": labels, "value": child.value}


class Counter(MetricFamily):
    kind = "counter"

    def _make_child(self):
        return _CounterChild(self._registry)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(MetricFamily):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild(self._registry)

    def zero_all(self) -> None:
        """Set every label child to 0 (children stay registered).  For
        identity-style gauges whose label values change over the process
        lifetime (e.g. build-info relabeled on elastic re-init): zero the
        stale identities so only the current one reads 1."""
        with self._registry._lock:
            for child in self._children.values():
                child._reset()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(MetricFamily):
    kind = "histogram"

    def __init__(self, registry, name, help="", labelnames=(),
                 buckets: Optional[Sequence[float]] = None) -> None:
        edges = tuple(buckets) if buckets is not None else \
            DEFAULT_TIME_BUCKETS
        if not edges or list(edges) != sorted(set(edges)):
            raise MetricError(
                f"{name}: bucket edges must be strictly increasing")
        self.buckets = edges
        super().__init__(registry, name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self._registry, self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    @property
    def sum(self) -> float:
        return self._default().sum

    @property
    def count(self) -> int:
        return self._default().count

    def _sample_of(self, labels: dict, child) -> dict:
        return {"labels": labels,
                "buckets": child.cumulative_buckets(),
                "sum": child.sum, "count": child.count}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class MetricRegistry:
    """Named-metric table with atomic snapshot/reset and a global
    enable/disable switch (the <2%-overhead escape hatch)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._families: dict[str, MetricFamily] = {}
        self.enabled = True

    # -- registration (get-or-create, kind-checked) ----------------------
    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.labelnames != tuple(labelnames):
                    raise MetricError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.labelnames}")
                return fam
            fam = cls(self, name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    # -- switches ---------------------------------------------------------
    def disable(self) -> None:
        """Make every recording call a no-op (overhead measurement /
        opt-out); registration and snapshots keep working."""
        self.enabled = False

    def enable(self) -> None:
        self.enabled = True

    # -- snapshot / reset -------------------------------------------------
    def snapshot(self) -> list:
        """Atomic point-in-time copy of every metric, as plain data
        (name/type/help/labelnames/samples) — the single input both
        exposition formats serialize."""
        with self._lock:
            return [{
                "name": fam.name,
                "type": fam.kind,
                "help": fam.help,
                "labelnames": list(fam.labelnames),
                "samples": fam._samples(),
            } for _, fam in sorted(self._families.items())]

    def reset(self) -> None:
        """Zero every metric (families and label children stay
        registered) — deterministic-test support."""
        with self._lock:
            for fam in self._families.values():
                for child in fam._children.values():
                    child._reset()


#: the process-wide default registry every instrumented subsystem reports to
REGISTRY = MetricRegistry()


def get_registry() -> MetricRegistry:
    return REGISTRY

"""Telemetry of the port: the metrics registry and its exposition.

Copies of the JAX package's stdlib-only modules (``horovod_tpu/obs``):

- :mod:`.registry` — process-wide counters, gauges and log-bucketed
  histograms that the runtime and the serving plane report into;
- :mod:`.export` — Prometheus text and JSON of a registry snapshot
  (``hvd.metrics(fmt)``);
- :mod:`.server` — the HTTP pull endpoint (``/metrics``, ``/cluster``,
  ``/query``, ``/healthz``), started by ``hvd.init()`` when
  ``HVDTPU_METRICS_PORT`` is set;
- :mod:`.aggregate` — every rank publishes its snapshot into the job's
  KV store, and any rank merges them (``hvd.cluster_metrics(fmt)``);
- :mod:`.tsdb` — bounded in-memory history of the registry behind
  ``/query``;
- :mod:`.trace` — request-scoped span chains (QUEUE → PREFILL → DECODE);
- :mod:`.flightrec` — the bounded event ring and postmortem bundles
  (``hvd.flight_record(path)``);
- :mod:`.slo` — declarative objectives over registry histograms with
  multi-window burn rates (``HVDTPU_SLO``);
- :mod:`.alerts` — declarative alert rules over the time-series tier
  (``HVDTPU_ALERTS``, ``/alertz``);
- :mod:`.prof` — the always-on sampling profiler (``HVDTPU_PROF_HZ``,
  ``/profz``);
- :mod:`.perfmodel` — expected-vs-achieved collective cost, fed by the
  engine (``hvd_perf_*``);
- :mod:`.tracemerge` — every rank's spans published and merged,
  clock-aligned, behind ``/tracez``;
- :mod:`.smoke` — the plane's end-to-end check, ``python -m
  horovod_tpu_torch.obs.smoke`` (imported on use, not here).

``hvd.init()`` arms them from the config; importing this package imports
neither torch nor jax, and starts nothing.
"""

from . import (  # noqa: F401
    aggregate, alerts, export, flightrec, perfmodel, prof, server, slo,
    trace, tracemerge, tsdb)
from .registry import (  # noqa: F401
    Counter,
    DEFAULT_TIME_BUCKETS,
    Gauge,
    Histogram,
    MetricError,
    MetricRegistry,
    REGISTRY,
    get_registry,
)

__all__ = [
    "aggregate", "alerts", "export", "flightrec", "perfmodel", "prof",
    "server", "slo", "smoke", "trace", "tracemerge", "tsdb",
    "Counter", "DEFAULT_TIME_BUCKETS", "Gauge", "Histogram", "MetricError",
    "MetricRegistry", "REGISTRY", "get_registry",
]

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
  (``hvd.flight_record(path)``).

SLOs, the profiler, the performance model, the fleet trace merge and
alerting wait for later slices (ROADMAP section A 'Observability').
Importing this package imports neither torch nor jax, and starts nothing.
"""

from . import aggregate, export, flightrec, server, trace, tsdb  # noqa: F401
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

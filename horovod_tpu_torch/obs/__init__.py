"""Telemetry of the port: metrics registry, request tracing, flight recorder.

Copies of the JAX package's stdlib-only modules (``horovod_tpu/obs``) that
the serving plane reports into:

- :mod:`.registry` — process-wide counters, gauges and log-bucketed
  histograms (TTFT, ITL, queue depth, KV utilization, preemptions);
- :mod:`.trace` — request-scoped span chains (QUEUE → PREFILL → DECODE);
- :mod:`.flightrec` — the bounded event ring and postmortem bundles.

Exposition (Prometheus, the HTTP endpoint), cross-rank aggregation, SLOs,
the profiler, the time-series tier and alerting wait for later slices.
Importing this package imports neither torch nor jax.
"""

from . import flightrec, trace  # noqa: F401
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

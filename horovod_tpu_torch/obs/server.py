"""Stdlib HTTP pull endpoint for the metrics registry.

A copy of the JAX package's ``obs/server.py`` for the port.
``GET /metrics`` returns Prometheus text (content type
``text/plain; version=0.0.4``), ``GET /metrics.json`` the JSON form —
both snapshot the registry atomically per request; ``/cluster`` and
``/cluster.json`` the merged job view (:mod:`.aggregate`), ``/query``
the time-series tier (:mod:`.tsdb`), ``/alertz`` the alert rules
(:mod:`.alerts`), ``/tracez`` the clock-aligned fleet trace
(:mod:`.tracemerge`), ``/profz`` the sampling profiler (:mod:`.prof`)
and ``/healthz`` the readiness probe.
The server is a daemon-threaded ``http.server`` (no extra dependency),
started explicitly (``MetricsServer(port)`` / :func:`start`) or by
``hvd.init()`` when ``metrics_port`` is set (``HVDTPU_METRICS_PORT``).

Unlike the reference, importing the package starts nothing: a launcher
process that imports ``horovod_tpu_torch`` with the knob in its env must
not take the port its worker is to bind.

Binds all interfaces by default (a scrape endpoint); pass
``addr="127.0.0.1"`` to keep it local.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import export
from .registry import REGISTRY, MetricRegistry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: the one route table: every endpoint this server answers, with the
#: one-liner shown on the ``/`` index — the 404 help body is derived
#: from it too, so the endpoint list cannot drift.
ROUTES = (
    ("/metrics", "Prometheus text exposition of the process registry"),
    ("/metrics.json", "JSON form of /metrics"),
    ("/cluster", "merged fleet snapshot, Prometheus text (rank-labeled)"),
    ("/cluster.json", "JSON form of /cluster"),
    ("/query", "time-series query: ?expr=rate(m[1m])&source=local|cluster"),
    ("/query.json", "JSON form of /query"),
    ("/query.csv", "CSV form of /query"),
    ("/alertz", "alert rule states (pending/firing) from HVDTPU_ALERTS"),
    ("/alertz.json", "JSON form of /alertz"),
    ("/tracez", "clock-aligned fleet trace (Perfetto-loadable JSON)"),
    ("/tracez.json", "alias of /tracez"),
    ("/profz", "self-profiler hotspot table, text"),
    ("/profz.json", "JSON form of /profz"),
    ("/healthz", "readiness probe: 200 ready / 503 unready"),
)


def _index_text() -> str:
    width = max(len(p) for p, _ in ROUTES)
    lines = ["horovod_tpu_torch metrics endpoint", ""]
    lines += [f"{p:<{width}}  {desc}" for p, desc in ROUTES]
    return "\n".join(lines) + "\n"


def _routes_help() -> str:
    return "try " + ", ".join(p for p, _ in ROUTES)

_cluster_provider = None
_cluster_lock = threading.Lock()


def set_cluster_provider(fn) -> None:
    """Register (or clear, with ``None``) the callable that produces the
    merged cluster snapshot served at ``/cluster``.  Module-global so the
    env-autostarted server (up since import) gains the route the moment
    ``hvd.init()`` arms aggregation."""
    global _cluster_provider
    with _cluster_lock:
        _cluster_provider = fn


_health_provider = None
_health_lock = threading.Lock()


def set_health_provider(fn) -> None:
    """Register (or clear) the callable behind ``GET /healthz``.

    ``fn()`` returns a dict; its ``ready`` key decides 200 vs 503.
    ``hvd.init()`` arms it and ``shutdown()`` clears it, so a process
    whose runtime is down answers 503 and a router probe drops it from
    rotation instead of sending it requests it cannot serve."""
    global _health_provider
    with _health_lock:
        _health_provider = fn


_trace_provider = None
_trace_lock = threading.Lock()


def set_trace_provider(fn) -> None:
    """Register (or clear) the callable behind ``GET /tracez``: the
    fleet trace collector (:mod:`.tracemerge`), whose result is one
    clock-aligned Perfetto-loadable JSON object.  Armed by
    ``hvd.init()`` next to the cluster provider."""
    global _trace_provider
    with _trace_lock:
        _trace_provider = fn


def _make_handler(registry: MetricRegistry):
    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            path, _, query_string = self.path.partition("?")
            if path == "/":
                body = _index_text()
                ctype = "text/plain; charset=utf-8"
            elif path == "/metrics":
                body = export.to_prometheus(registry.snapshot())
                ctype = PROMETHEUS_CONTENT_TYPE
            elif path == "/metrics.json":
                body = export.to_json(registry.snapshot())
                ctype = "application/json"
            elif path == "/healthz":
                with _health_lock:
                    provider = _health_provider
                if provider is None:
                    health = {"ready": False, "status": "unready",
                              "reason": "runtime not initialized"}
                else:
                    try:
                        health = dict(provider())
                    except Exception as e:  # probe must answer, not 500
                        health = {"ready": False, "status": "unready",
                                  "reason": f"health provider failed: {e}"}
                code = 200 if health.get("ready") else 503
                payload = json.dumps(health).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            elif path in ("/cluster", "/cluster.json"):
                with _cluster_lock:
                    provider = _cluster_provider
                if provider is None:
                    self.send_error(
                        503, "cluster aggregation not armed on this "
                             "process (hvd.init() arms it; per-process "
                             "series stay on /metrics)")
                    return
                snap = provider()
                if path == "/cluster":
                    body = export.to_prometheus(snap)
                    ctype = PROMETHEUS_CONTENT_TYPE
                else:
                    body = export.to_json(snap)
                    ctype = "application/json"
            elif path in ("/tracez", "/tracez.json"):
                with _trace_lock:
                    provider = _trace_provider
                if provider is None:
                    self.send_error(
                        503, "fleet trace collection not armed on this "
                             "process (hvd.init() arms it; per-process "
                             "traces stay in the tracer's export)")
                    return
                try:
                    merged = provider()
                except Exception as e:   # scrape must answer, not 500
                    merged = {"traceEvents": [], "error": str(e)}
                body = json.dumps(merged)
                ctype = "application/json"
            elif path in ("/profz", "/profz.json"):
                from .prof import PROFILER
                if path == "/profz":
                    body = PROFILER.render_text()
                    ctype = "text/plain; charset=utf-8"
                else:
                    body = json.dumps(PROFILER.snapshot())
                    ctype = "application/json"
            elif path in ("/query", "/query.json", "/query.csv"):
                from . import tsdb
                params = urllib.parse.parse_qs(query_string)
                expr = (params.get("expr") or [""])[0]
                source = (params.get("source") or ["local"])[0]
                try:
                    result = tsdb.query(expr, source=source)
                except tsdb.QueryError as e:
                    self.send_error(400, str(e))
                    return
                if path == "/query.json":
                    body = json.dumps(result)
                    ctype = "application/json"
                elif path == "/query.csv":
                    body = tsdb.render_csv(result)
                    ctype = "text/csv; charset=utf-8"
                else:
                    body = tsdb.render_text(result)
                    ctype = "text/plain; charset=utf-8"
            elif path in ("/alertz", "/alertz.json"):
                from . import alerts
                payload = alerts.status()
                if payload is None:
                    self.send_error(
                        503, "alerting not armed on this process "
                             "(set HVDTPU_ALERTS and hvd.init() arms it)")
                    return
                if path == "/alertz.json":
                    body = json.dumps(payload)
                    ctype = "application/json"
                else:
                    body = alerts.render_text(payload)
                    ctype = "text/plain; charset=utf-8"
            else:
                self.send_error(404, _routes_help())
                return
            payload = body.encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *args):  # scrapes are not log events
            pass

    return _Handler


class MetricsServer:
    """One listening endpoint over one registry; ``port=0`` binds an
    ephemeral port (read it back from ``.port``)."""

    def __init__(self, port: int = 0, *, addr: str = "",
                 registry: Optional[MetricRegistry] = None) -> None:
        self.registry = registry or REGISTRY
        self._httpd = ThreadingHTTPServer(
            (addr, port), _make_handler(self.registry))
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="hvdtpu-metrics")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_singleton: Optional[MetricsServer] = None
_singleton_lock = threading.Lock()


def start(port: int, *, addr: str = "") -> MetricsServer:
    """Start (or return) the process-wide endpoint on the default
    registry.  Idempotent: the first call wins; later calls return the
    running server regardless of port.

    The bind retries briefly on the shared backoff policy: after a
    relaunch the previous incarnation's socket can sit in TIME_WAIT for
    a moment, and losing the scrape endpoint for the whole next life of
    the job over that is silly.  A port some OTHER
    process really owns still fails (and multi-worker jobs expect that
    on all but one worker) — three quick attempts lose ~0.15s."""
    global _singleton
    with _singleton_lock:
        if _singleton is None:
            from ..utils import retry as _retry
            _singleton = _retry.retry_call(
                lambda: MetricsServer(port, addr=addr),
                op="metrics_bind",
                policy=_retry.RetryPolicy(max_attempts=3,
                                          base_delay_s=0.05,
                                          max_delay_s=0.2,
                                          retryable=(OSError,)))
            from ..utils import logging as hvd_logging
            hvd_logging.get_logger().info(
                "metrics endpoint listening on :%d (/metrics, "
                "/metrics.json)", _singleton.port)
        return _singleton


def stop() -> None:
    global _singleton
    with _singleton_lock:
        if _singleton is not None:
            _singleton.close()
            _singleton = None

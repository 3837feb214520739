"""CI smoke for the observability plane: ``python -m horovod_tpu_torch.obs.smoke``.

A copy of the JAX package's ``obs/smoke.py`` for the port.  Neither pass
needs a card: the cluster pass starts the port's native KV store and two
worker processes of this module.

Two self-contained passes:

1. **Process pass** — register metrics of all three kinds, generate
   traffic, run one sampled request trace and one SLO evaluation, start
   the HTTP endpoint (env port or ephemeral), scrape both formats plus
   ``/healthz`` (ready AND unready answers), and validate the Prometheus
   text with the same :func:`.export.validate_prometheus`
   the unit tests use.
2. **Cluster pass** — start the native KV store, spawn two real worker
   processes that each publish a rank-tagged registry snapshot
   (``--worker <rank>`` re-entry) carrying a sampled trace's counters
   and an SLO engine's gauges, aggregate them, serve the merged view
   at ``/cluster``, scrape it, and validate: per-rank ``rank``-labeled
   series from both ranks, cluster-summed counters, SLO attainment and
   trace series from both ranks, valid exposition.

Exit code 0 = the telemetry plane works end to end, single- and
multi-process.
"""

from __future__ import annotations

import json
import os
import secrets
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

from . import alerts, export, server, slo, trace, tsdb
from .registry import REGISTRY, MetricRegistry

#: the endpoint's port knob under its three prefixes (first set wins);
#: unset, the process pass serves on an ephemeral port
_PORT_ENV_VARS = ("HVDTPU_METRICS_PORT", "HOROVOD_TPU_METRICS_PORT",
                  "HOROVOD_METRICS_PORT")


def _query_json(base: str, expr: str, source: str = "local") -> dict:
    url = (f"{base}/query.json?source={source}&expr="
           + urllib.parse.quote(expr))
    return json.loads(urllib.request.urlopen(url, timeout=10)
                      .read().decode())


def _wait_for(pred, timeout_s: float = 10.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _healthz(base: str):
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _process_pass() -> int:
    reg = MetricRegistry()
    c = reg.counter("smoke_events_total", "smoke traffic", ("kind",))
    c.labels(kind="scrape").inc()
    c.labels(kind="request").inc(3)
    reg.gauge("smoke_queue_depth", "smoke gauge").set(2)
    h = reg.histogram("smoke_latency_seconds", "smoke histogram")
    for v in (1e-4, 3e-3, 0.2):
        h.observe(v)

    # One sampled trace: connected span chain, shared id, exportable.
    tr = trace.Tracer(sample_rate=1.0)
    root = tr.start_trace("smoke.request", lane="req0")
    q = root.child("QUEUE")
    q.end()
    root.child("PREFILL", after=q).end()
    root.end(outcome="finished")
    exp = tr.export()
    if exp is None or {s["trace_id"] for s in exp["spans"]} \
            != {exp["trace_id"]}:
        print(f"obs smoke FAILED: trace export broken: {exp}",
              file=sys.stderr)
        return 1

    # One SLO evaluation against the same registry: the gauges must ride
    # the exposition the endpoint serves.
    eng = slo.SLOEngine(registry=reg, tick_s=3600)
    eng.add("p99(smoke_latency_seconds) < 1s over 5m", name="smoke")
    eng.tick()
    out = eng.evaluate()
    if not out["smoke"]["met"]:
        print(f"obs smoke FAILED: SLO unexpectedly violated: {out}",
              file=sys.stderr)
        return 1

    port = 0
    for var in _PORT_ENV_VARS:
        if os.environ.get(var):
            port = int(os.environ[var])
            break
    srv = server.MetricsServer(port, addr="127.0.0.1", registry=reg)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(
            f"{base}/metrics", timeout=10).read().decode()
        export.validate_prometheus(text)
        for needle in ('smoke_events_total{kind="request"} 3',
                       "smoke_queue_depth 2",
                       "smoke_latency_seconds_count 3",
                       'hvd_slo_attainment{slo="smoke"} 1',
                       'hvd_slo_burn_rate{slo="smoke",window="5m"}',
                       'hvd_slo_objective{slo="smoke"} 0.99'):
            if needle not in text:
                print(f"obs smoke FAILED: {needle!r} missing from "
                      f"exposition:\n{text}", file=sys.stderr)
                return 1
        blob = json.loads(urllib.request.urlopen(
            f"{base}/metrics.json", timeout=10).read().decode())
        names = {m["name"] for m in blob["metrics"]}
        if not {"smoke_events_total", "smoke_latency_seconds",
                "hvd_slo_attainment"} <= names:
            print(f"obs smoke FAILED: JSON exposition missing families "
                  f"({names})", file=sys.stderr)
            return 1
        # /healthz: 503 without a provider (the re-rendezvous window),
        # 200 once armed, 503 again when cleared.
        saved = server._health_provider
        try:
            server.set_health_provider(None)
            code, body = _healthz(base)
            if code != 503 or body.get("ready"):
                print(f"obs smoke FAILED: unarmed /healthz answered "
                      f"{code} {body}", file=sys.stderr)
                return 1
            server.set_health_provider(
                lambda: {"ready": True, "status": "ok",
                         "rank": 0, "size": 1})
            code, body = _healthz(base)
            if code != 200 or not body.get("ready"):
                print(f"obs smoke FAILED: armed /healthz answered "
                      f"{code} {body}", file=sys.stderr)
                return 1
        finally:
            server.set_health_provider(saved)
        # Time-series tier: /query over sampled history + a firing
        # alert on /alertz, end to end through the HTTP surface.
        qc = REGISTRY.counter("smoke_tsdb_events_total",
                              "tsdb smoke traffic")
        try:
            tsdb.arm(interval_s=0.05, retention_s=60.0)
            alerts.arm("smoke_hot: smoke_tsdb_events_total >= 4 : warn",
                       tick_s=0.05)
            qc.inc(2)
            tsdb.sample_now()
            time.sleep(0.12)
            qc.inc(2)
            tsdb.sample_now()
            res = _wait_for(
                lambda: _query_json(
                    base, "rate(smoke_tsdb_events_total[1m])")["series"],
                what="/query rate series")
            if res[0]["value"] <= 0:
                print(f"obs smoke FAILED: /query rate not positive: "
                      f"{res}", file=sys.stderr)
                return 1
            payload = _wait_for(
                lambda: (lambda p: p if p["firing"] else None)(
                    json.loads(urllib.request.urlopen(
                        f"{base}/alertz.json", timeout=10)
                        .read().decode())),
                what="/alertz firing alert")
            states = {a["alert"]: a["state"] for a in payload["alerts"]}
            if states.get("smoke_hot") != "firing":
                print(f"obs smoke FAILED: /alertz states {states}",
                      file=sys.stderr)
                return 1
            alert_text = urllib.request.urlopen(
                f"{base}/alertz", timeout=10).read().decode()
            if "smoke_hot" not in alert_text:
                print(f"obs smoke FAILED: /alertz text missing rule:\n"
                      f"{alert_text}", file=sys.stderr)
                return 1
        finally:
            alerts.disarm()
            tsdb.disarm()
    finally:
        srv.close()
    print(f"obs smoke OK: scraped :{srv.port}/metrics "
          f"({len(text.splitlines())} lines, exposition valid; trace "
          f"chain + SLO gauges + /healthz 200/503 + /query rate + "
          f"/alertz firing verified)")
    return 0


def _worker(rank: int) -> int:
    """Re-entry for the cluster pass: record rank-distinct traffic into
    the process-default registry and publish one snapshot to the KV
    store the parent armed via the environment."""
    from . import aggregate

    REGISTRY.counter(
        "smoke_cluster_events_total", "cluster smoke traffic"
    ).inc(rank + 1)
    REGISTRY.gauge("smoke_cluster_depth", "per-rank gauge").set(rank * 10)
    h = REGISTRY.histogram("smoke_cluster_latency_seconds",
                           "per-rank latency", buckets=(0.01, 0.1, 1.0))
    h.observe(0.05 * (rank + 1))
    # One sampled trace (counters land in the published registry) and
    # one SLO evaluation (gauges ditto): /cluster must carry both.
    sp = trace.TRACER.start_trace("smoke.req", lane=f"req{rank}")
    sp.child("QUEUE").end()
    sp.end()
    if trace.TRACER.export() is None:
        return 1
    eng = slo.SLOEngine(tick_s=3600)
    eng.add("p99(smoke_cluster_latency_seconds) < 2s over 5m",
            name="smoke")
    eng.tick()
    if not eng.evaluate()["smoke"]["met"]:
        return 1
    pub = aggregate.RankPublisher(rank, 2, interval_s=3600)
    ok = pub.publish_now()
    pub.stop(retract=False)   # the parent aggregates after we exit
    return 0 if ok else 1


def _cluster_pass() -> int:
    from . import aggregate
    try:
        from .._native import KvServer
        kv_srv = KvServer(secret=os.environ.setdefault(
            "HVDTPU_SECRET", secrets.token_hex(8)))
    except OSError as e:
        # The native-build CI job owns build failures; the obs smoke
        # reports (not fails) when the control plane is absent.
        print(f"obs smoke: cluster pass SKIPPED (native core "
              f"unavailable: {e})", file=sys.stderr)
        return 0
    srv = None
    try:
        os.environ["HVDTPU_RENDEZVOUS_ADDR"] = f"127.0.0.1:{kv_srv.port}"
        for rank in range(2):
            res = subprocess.run(
                [sys.executable, "-m", "horovod_tpu_torch.obs.smoke",
                 "--worker", str(rank)],
                env=dict(os.environ), timeout=60)
            if res.returncode != 0:
                print(f"obs smoke FAILED: worker {rank} exited "
                      f"{res.returncode}", file=sys.stderr)
                return 1
        agg = aggregate.ClusterAggregator(own_size=2, include_local=False)
        server.set_cluster_provider(agg.collect)
        srv = server.MetricsServer(0, addr="127.0.0.1")
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/cluster", timeout=10
        ).read().decode()
        export.validate_prometheus(text)
        for needle in ('smoke_cluster_events_total{rank="0"} 1',
                       'smoke_cluster_events_total{rank="1"} 2',
                       "smoke_cluster_events_total 3",   # cluster sum
                       'smoke_cluster_depth{rank="1"} 10',
                       "smoke_cluster_latency_seconds_count 2",
                       "horovod_tpu_cluster_ranks_reporting 2",
                       # SLO gauges + trace counters from BOTH workers
                       # ride the same snapshot path (the router/
                       # autoscaler single-scrape contract).
                       'hvd_slo_attainment{rank="0",slo="smoke"} 1',
                       'hvd_slo_attainment{rank="1",slo="smoke"} 1',
                       'hvd_traces_total{rank="0",sampled="true"} 1',
                       'hvd_traces_total{rank="1",sampled="true"} 1',
                       'hvd_traces_total{sampled="true"} 2'):
            if needle not in text:
                print(f"obs smoke FAILED: {needle!r} missing from "
                      f"/cluster exposition:\n{text}", file=sys.stderr)
                return 1
        # /healthz next to /cluster on the same endpoint.
        saved = server._health_provider
        try:
            server.set_health_provider(
                lambda: {"ready": True, "status": "ok",
                         "rank": 0, "size": 2})
            code, body = _healthz(f"http://127.0.0.1:{srv.port}")
        finally:
            server.set_health_provider(saved)
        if code != 200 or not body.get("ready"):
            print(f"obs smoke FAILED: /healthz answered {code} {body}",
                  file=sys.stderr)
            return 1
        blob = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/cluster.json", timeout=10
        ).read().decode())
        names = {m["name"] for m in blob["metrics"]}
        if "smoke_cluster_events_total" not in names:
            print(f"obs smoke FAILED: /cluster.json missing families "
                  f"({names})", file=sys.stderr)
            return 1
        # Time-series tier over the fleet: every /cluster merge above
        # also landed in the cluster history, so /query?source=cluster
        # answers rank-labeled instant selectors; /alertz fires on a
        # local series the armed sampler picked up.
        base = f"http://127.0.0.1:{srv.port}"
        try:
            tsdb.arm(interval_s=0.05, retention_s=60.0)
            alerts.arm("smoke_armed: smoke_cluster_armed == 1 : info",
                       tick_s=0.05)
            REGISTRY.gauge("smoke_cluster_armed",
                           "cluster-pass alert input").set(1)
            urllib.request.urlopen(f"{base}/cluster",
                                   timeout=10).read()   # one ingest
            res = _query_json(base, 'smoke_cluster_depth{rank="1"}',
                              source="cluster")
            if not res["series"] or res["series"][0]["value"] != 10:
                print(f"obs smoke FAILED: cluster /query answered "
                      f"{res}", file=sys.stderr)
                return 1
            payload = _wait_for(
                lambda: (lambda p: p if p["firing"] else None)(
                    json.loads(urllib.request.urlopen(
                        f"{base}/alertz.json", timeout=10)
                        .read().decode())),
                what="cluster-pass /alertz firing alert")
            states = {a["alert"]: a["state"] for a in payload["alerts"]}
            if states.get("smoke_armed") != "firing":
                print(f"obs smoke FAILED: cluster-pass /alertz states "
                      f"{states}", file=sys.stderr)
                return 1
        finally:
            alerts.disarm()
            tsdb.disarm()
        agg.close()
    finally:
        server.set_cluster_provider(None)
        if srv is not None:
            srv.close()
        kv_srv.stop()
    print("obs smoke OK: /cluster aggregated 2 worker processes "
          "(rank-labeled + summed series incl. SLO attainment + trace "
          "counters, /healthz ready, /query over the fleet history, "
          "/alertz firing, exposition valid)")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--worker"]:
        return _worker(int(argv[1]))
    rc = _process_pass()
    if rc != 0:
        return rc
    return _cluster_pass()


if __name__ == "__main__":
    sys.exit(main())

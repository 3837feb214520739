"""Port parity: the job's metrics plane in ``horovod_tpu_torch.obs``.

Held against the JAX package's ``horovod_tpu.obs`` on the same inputs,
with equality as the tolerance:

- ``export``: one registry filled the same way in both packages gives the
  same Prometheus text and JSON, byte for byte (the golden of
  ``tests/test_obs.py``, plus label escapes and non-finite values);
- ``aggregate.merge_snapshots`` on the same per-rank snapshots (the cases
  of ``tests/test_obs.py``: counter sums, per-rank gauges, bucket merges,
  a family with its own ``rank`` label, diverging buckets, a stale rank),
  and a snapshot published by one package's ``RankPublisher`` read by the
  other's ``ClusterAggregator`` over one KV server;
- ``tsdb``: the answers of queries over the same ingested series.

Then the port's own surface: the HTTP endpoint's routes, ``hvd.metrics``,
``cluster_metrics`` and ``flight_record`` at one rank, ``init`` starting
and ``shutdown`` stopping the endpoint, and the plane under the launcher:
at np=2 rank 0's ``cluster_metrics()`` holds both ranks'
``hvd_collectives_total`` and their sum; at np=1 with
``HVDTPU_METRICS_PORT`` the served ``/metrics`` equals
``hvd.metrics("prometheus")`` byte for byte.
"""

from __future__ import annotations

import json
import os
import socket
import urllib.error
import urllib.request

import pytest

import mp_torch_port_worker as W
from horovod_tpu.obs import aggregate as ref_aggregate
from horovod_tpu.obs import export as ref_export
from horovod_tpu.obs import tsdb as ref_tsdb
from horovod_tpu.obs.registry import MetricRegistry as RefRegistry
from horovod_tpu_torch.obs import aggregate, export, server, tsdb
from horovod_tpu_torch.obs.registry import MetricRegistry

PKGS = {"ref": (RefRegistry, ref_export, ref_aggregate, ref_tsdb),
        "port": (MetricRegistry, export, aggregate, tsdb)}
T0 = 1_000_000.0


def _golden(registry_cls):
    reg = registry_cls()
    c = reg.counter("req_total", "requests by code", ("code",))
    c.labels(code="200").inc(3)
    c.labels(code="500").inc()
    reg.gauge("depth", "queue depth").set(2.5)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    odd = reg.gauge("odd_values", 'help with \\ and\nnewline', ("who",))
    odd.labels(who='quote " back \\ nl \n').set(float("inf"))
    odd.labels(who="nan").set(float("nan"))
    odd.labels(who="small").set(1e-300)
    odd.labels(who="big").set(3e15)
    return reg


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_prometheus_text_matches_reference():
    text = export.to_prometheus(_golden(MetricRegistry).snapshot())
    assert text == ref_export.to_prometheus(_golden(RefRegistry).snapshot())
    export.validate_prometheus(text)
    assert 'req_total{code="200"} 3\n' in text


def test_json_matches_reference():
    blob = export.to_json(_golden(MetricRegistry).snapshot())
    assert blob == ref_export.to_json(_golden(RefRegistry).snapshot())
    fams = {m["name"]: m for m in json.loads(blob)["metrics"]}
    assert fams["lat_seconds"]["samples"][0]["buckets"][-1] == ["+Inf", 2]


@pytest.mark.parametrize("bad", ["no_type_header 1\n",
                                 "# TYPE x counter\nx 1 2 3\n",
                                 "# TYPE h histogram\nh_bucket{le=\"1\"} 2\n"
                                 "h_bucket{le=\"0.5\"} 1\n"])
def test_validate_rejects_in_both(bad):
    for mod in (ref_export, export):
        with pytest.raises(ValueError):
            mod.validate_prometheus(bad)


# ---------------------------------------------------------------------------
# merge_snapshots
# ---------------------------------------------------------------------------

def _fill_basic(reg, r):
    reg.counter("m_events_total", "ev", ("kind",)).labels(kind="x").inc(r + 1)
    reg.gauge("m_depth").set(r * 5)
    reg.histogram("m_lat_seconds", buckets=(0.1, 1.0)).observe(0.05 * (r + 1))


def _fill_own_rank(reg, r):
    reg.gauge("straggler_age", "g", ("rank", "tensor")) \
        .labels(rank="3", tensor="t").set(10.0 + r)


def _fill_divergent(reg, r):
    reg.histogram("h_seconds", buckets=((0.1, 1.0), (0.2, 2.0))[r]) \
        .observe(0.5)


def _fill_stale(reg, r):
    reg.counter("st_events_total").inc(r + 1)
    reg.histogram("st_lat_seconds", buckets=(0.1, 1.0)).observe(0.05)


FILLS = {"basic": _fill_basic, "own_rank_label": _fill_own_rank,
         "divergent_buckets": _fill_divergent, "stale_rank": _fill_stale}


def _merged_text(pkg, fill, now):
    registry_cls, exp, agg, _ = PKGS[pkg]
    snaps = []
    for r in range(2):
        reg = registry_cls()
        FILLS[fill](reg, r)
        snap = json.loads(agg.local_snapshot_blob(
            r, 2, registry=reg, extra_meta={"interval_s": 2.0}).decode())
        # identity fields that differ between two processes or calls
        snap.update(time=now, uptime_s=1.5, pid=1, hostname="h")
        snaps.append(snap)
    if fill == "stale_rank":
        snaps[1]["time"] = now - 100.0
    return exp.to_prometheus(agg.merge_snapshots(snaps))


@pytest.mark.parametrize("fill", sorted(FILLS))
def test_merge_snapshots_matches_reference(monkeypatch, fill):
    import time
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)   # one clock for both
    text = _merged_text("port", fill, now)
    assert text == _merged_text("ref", fill, now)
    export.validate_prometheus(text)
    if fill == "basic":
        assert 'm_events_total{kind="x",rank="1"} 2' in text
        assert 'm_events_total{kind="x"} 3' in text
        assert "m_lat_seconds_count 2" in text
    if fill == "stale_rank":
        assert "horovod_tpu_cluster_ranks_stale 1" in text
        assert "\nst_events_total 1\n" in "\n" + text


@pytest.mark.parametrize("publisher", ["port", "ref"])
def test_snapshot_published_by_one_package_merges_in_the_other(publisher):
    """The obs/rank/<r> blob on the KV store is one format: a rank of
    either package can feed the other's aggregator."""
    from horovod_tpu_torch._native import KvClient, KvServer
    reader = "ref" if publisher == "port" else "port"
    registry_cls, _, pub_agg, _ = PKGS[publisher]
    _, read_exp, read_agg, _ = PKGS[reader]
    with KvServer() as srv:
        reg = registry_cls()
        _fill_basic(reg, 1)
        pub = pub_agg.RankPublisher(
            1, 2, interval_s=600, registry=reg,
            kv_factory=lambda: KvClient("127.0.0.1", srv.port))
        assert pub.publish_now()
        own = PKGS[reader][0]()
        _fill_basic(own, 0)
        agg = read_agg.ClusterAggregator(
            own_rank=0, own_size=2, registry=own,
            kv_factory=lambda: KvClient("127.0.0.1", srv.port))
        text = read_exp.to_prometheus(agg.collect())
        agg.close()
        pub.stop()
    assert 'm_events_total{kind="x",rank="0"} 1' in text
    assert 'm_events_total{kind="x",rank="1"} 2' in text
    assert 'm_events_total{kind="x"} 3' in text
    assert "horovod_tpu_cluster_ranks_reporting 2" in text


# ---------------------------------------------------------------------------
# tsdb
# ---------------------------------------------------------------------------

def _ingest_all(store_mod):
    store = store_mod.SeriesStore(interval_s=1.0, retention_s=10.0)
    vals = [0.0, 5.0, 10.0, 15.0, 2.0, 7.0, 12.0]       # a counter reset
    for i in range(300):
        fams = [
            {"name": "g", "type": "gauge", "help": "", "labelnames": ("rank",),
             "samples": [{"labels": {"rank": str(r)},
                          "value": float((i * (r + 3)) % 11)}
                         for r in range(2)]},
            {"name": "c_total", "type": "counter", "help": "",
             "labelnames": (),
             "samples": [{"labels": {}, "value": vals[i] if i < 7
                          else 12.0 + 3 * (i - 6)}]},
            {"name": "lat", "type": "histogram", "help": "", "labelnames": (),
             "samples": [{"labels": {},
                          "buckets": [[0.01, i], [0.1, 2 * i],
                                      [float("inf"), 3 * i]],
                          "sum": 0.1 * i, "count": 3 * i}]}]
        store.ingest(fams, now=T0 + i)
    return store


QUERIES = ["g", 'g{rank="1"}', "max_over_time(g[4m])",
           "min_over_time(g[4m])", "avg_over_time(g[90s])",
           "rate(c_total[5m])", "increase(c_total[10m])",
           "rate(lat_count[1m])", "quantile(0.5, lat[1m])",
           "quantile(0.99, lat[5m])", "forecast(g[60s], 30)"]


@pytest.mark.parametrize("expr", QUERIES)
def test_tsdb_query_matches_reference(expr):
    got = tsdb.eval_expr(_ingest_all(tsdb), expr, now=T0 + 299)
    want = ref_tsdb.eval_expr(_ingest_all(ref_tsdb), expr, now=T0 + 299)
    assert got == want
    assert got["series"], expr
    assert tsdb.render_text(got) == ref_tsdb.render_text(want)
    assert tsdb.render_csv(got) == ref_tsdb.render_csv(want)


@pytest.mark.parametrize("bad", ["", "rate(m)", "m[1m]",
                                 "quantile(1.5, h[1m])", "nope(m[1m])"])
def test_tsdb_rejects_in_both(bad):
    for mod in (ref_tsdb, tsdb):
        with pytest.raises(mod.QueryError):
            mod.parse_expr(bad)


# ---------------------------------------------------------------------------
# the endpoint and the root surface, in this process
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def test_endpoint_routes():
    srv = server.MetricsServer(0, addr="127.0.0.1",
                               registry=_golden(MetricRegistry))
    try:
        code, ctype, text = _get(srv.port, "/metrics")
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert text == ref_export.to_prometheus(_golden(RefRegistry)
                                                .snapshot())
        code, _, body = _get(srv.port, "/metrics.json")
        assert code == 200 and json.loads(body)["metrics"]
        code, _, body = _get(srv.port, "/")
        assert all(p in body for p, _ in server.ROUTES)
        code, _, body = _get(srv.port, "/nope")
        assert code == 404 and "/cluster" in body
        code, _, body = _get(srv.port, "/query?expr=rate(")
        assert code == 400
    finally:
        srv.close()


@pytest.fixture
def one_rank(monkeypatch):
    import horovod_tpu_torch as hvd
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    port = _free_port()
    hvd.init(config=hvd.Config(platform="cpu", metrics_port=port))
    yield hvd, port
    hvd.shutdown()


def test_init_serves_metrics_equal_to_hvd_metrics(one_rank):
    import torch
    from horovod_tpu_torch.obs import prof
    hvd, port = one_rank
    hvd.allreduce(torch.ones(3), hvd.Sum, name="obs.one")
    # the sampling profiler counts its ticks into the registry: paused
    prof.PROFILER.stop()
    text = hvd.metrics("prometheus")
    code, _, served = _get(port, "/metrics")
    json_body = hvd.metrics("json")
    snapshot = hvd.metrics()
    prof.PROFILER.start()
    assert code == 200 and served == text
    assert 'hvd_collectives_total{verb="allreduce"}' in text
    assert json.loads(json_body)["metrics"] == \
        json.loads(export.to_json(snapshot))["metrics"]
    code, _, body = _get(port, "/healthz")
    health = json.loads(body)
    assert code == 200 and health["ready"] and health["rank"] == 0
    code, _, body = _get(port, "/cluster")
    assert code == 200 and 'rank="0"' in body
    code, _, body = _get(port, "/query?expr=hvd_collectives_total")
    assert code == 200
    with pytest.raises(ValueError, match="fmt"):
        hvd.metrics("yaml")


def test_shutdown_stops_the_endpoint_and_health(one_rank):
    hvd, port = one_rank
    hvd.shutdown()
    with pytest.raises(OSError):
        _get(port, "/metrics")
    assert server._health_provider is None
    assert server._cluster_provider is None


def test_cluster_metrics_single_process_world(one_rank):
    hvd, _ = one_rank
    snap = hvd.cluster_metrics()
    fam = {f["name"]: f for f in snap}["hvd_collectives_total"]
    own = {s["labels"]["verb"]: s["value"]
           for s in {f["name"]: f for f in hvd.metrics()}
           ["hvd_collectives_total"]["samples"]}
    ranked = {s["labels"]["verb"]: s["value"] for s in fam["samples"]
              if s["labels"].get("rank") == "0"}
    assert ranked == own
    text = hvd.cluster_metrics("prometheus")
    export.validate_prometheus(text)
    assert "horovod_tpu_cluster_ranks_reporting 1" in text
    build = {f["name"]: f for f in hvd.metrics()}["horovod_tpu_build_info"]
    [live] = [s for s in build["samples"] if s["value"] == 1]
    assert live["labels"]["device_kind"] == "cpu"


def test_flight_record_writes_a_bundle(one_rank, tmp_path):
    hvd, _ = one_rank
    path = hvd.flight_record(str(tmp_path / "fr.json"))
    bundle = json.loads(open(path).read())
    assert (bundle["rank"], bundle["size"], bundle["reason"]) == \
        (0, 1, "manual")
    assert {f["name"] for f in bundle["metrics"]} >= {"hvd_collectives_total"}
    assert "tsdb" in bundle


# ---------------------------------------------------------------------------
# the plane under the launcher
# ---------------------------------------------------------------------------

def _launched(mode_dir, np_, extra_env):
    res = W.launch("obs", str(mode_dir), np_=np_, timeout=120,
                   extra_env=extra_env)
    for rc, text in res:
        assert rc == 0, text
    return [json.loads((mode_dir / f"obs.rank{r}.json").read_text())
            for r in range(np_)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    # a long cadence: each rank publishes at init and at publish_now()
    return _launched(tmp_path_factory.mktemp("obs2"), 2,
                     {"HVDTPU_OBS_PUBLISH_INTERVAL": "600"})


def test_cluster_view_holds_both_ranks_and_their_sum(two_ranks):
    r0, r1 = two_ranks
    assert r0["published"] and r1["published"]
    cluster = r0["cluster"]
    assert cluster["1.allreduce"] == r1["own"]["allreduce"] == \
        W.OBS_ALLREDUCES
    # rank 0's own series is read live, after its barrier
    assert cluster["0.allreduce"] == r0["registry_at_cluster"]["allreduce"]
    for verb in r0["own"]:
        assert cluster[f"sum.{verb}"] == \
            cluster[f"0.{verb}"] + cluster[f"1.{verb}"]
    assert [r["flight"] for r in two_ranks] == \
        [[0, 2, "manual"], [1, 2, "manual"]]


def test_launched_ranks_hold_the_jobs_env_and_no_jax(two_ranks):
    for info in two_ranks:
        assert info["launcher_env"] == ["HVDTPU_CONTROLLER_ADDR",
                                        "HVDTPU_RENDEZVOUS_ADDR",
                                        "HVDTPU_SECRET"]
        assert info["jax_loaded"] is False


def test_one_launched_rank_serves_metrics_equal_to_hvd_metrics(
        tmp_path):
    [info] = _launched(tmp_path, 1, {"HVDTPU_METRICS_PORT":
                                     str(_free_port())})
    assert info["bound_metrics_port"] and info["metrics_equal"]
    assert info["cluster_http_ok"]
    assert info["cluster"]["0.allreduce"] == \
        info["registry_at_cluster"]["allreduce"] >= W.OBS_ALLREDUCES
    assert info["flight"] == [0, 1, "manual"]

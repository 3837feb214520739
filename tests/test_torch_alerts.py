"""Port parity: declarative alerting, ``horovod_tpu_torch.obs.alerts``.

Held against the JAX package's ``horovod_tpu.obs.alerts`` on the same
inputs, with equality as the tolerance: the rule grammar and its rejects,
the pending -> firing -> resolved lifecycle under a fake clock over series
made from a seed (the cases of ``tests/test_tsdb.py``), the firing gauges
and flight-recorder transitions, and ``/alertz`` on the port's server.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from horovod_tpu.obs import alerts as ref_alerts
from horovod_tpu.obs import tsdb as ref_tsdb
from horovod_tpu_torch.obs import REGISTRY, alerts, flightrec, server, tsdb

MODS = {"ref": (ref_alerts, ref_tsdb), "port": (alerts, tsdb)}
T0 = 1_000_000.0


def _fam(kind, name, value, labels=None):
    return {"name": name, "type": kind, "help": "",
            "labelnames": tuple((labels or {}).keys()),
            "samples": [{"labels": dict(labels or {}), "value": value}]}


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t


RULES = [
    "queue: avg_over_time(hvd_serving_queue_depth[1m]) > 8 for 30s : warn;"
    " burn: max_over_time(b[5m]) >= 14.4 : page; floor: q < 1",
    "busy: rate(hvd_collectives_total[10s]) > 0 : info",
    "a.b-c: forecast(g[30s], 5) != 2.5e-3 for 1.5m : crit",
    "x: quantile(0.99, h[5m]) <= -1 for 2h",
    "m:with:colons > 3 : warn",
]
BAD = ["rate(m[1m]) > 2", "a: m >", "a: m > 1 : sideways",
       "a: nope(m[1m]) > 1", "a: m > 1; a: m > 2", "bad name: m > 1",
       "a: m >> 1", "a: m > 1 for 3d"]


def _rules(mod, spec):
    return [(r.name, r.expr, r.op, r.threshold, r.for_s, r.severity)
            for r in mod.parse_rules(spec)]


@pytest.mark.parametrize("spec", RULES)
def test_grammar_matches_reference(spec):
    assert _rules(alerts, spec) == _rules(ref_alerts, spec)


@pytest.mark.parametrize("bad", BAD)
def test_rejects_in_both(bad):
    msgs = []
    for mod, tsdb_mod in MODS.values():
        with pytest.raises(tsdb_mod.QueryError) as err:
            mod.parse_rules(bad)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _lifecycle(pkg: str, spec: str, seed: int) -> list:
    """One engine over a store fed from a seed: every tick's /alertz
    payload and the transitions on the flight-recorder ring."""
    mod, tsdb_mod = MODS[pkg]
    clk = FakeClock()
    store = tsdb_mod.SeriesStore(interval_s=1.0)
    eng = mod.AlertEngine(mod.parse_rules(spec), store=store, clock=clk)
    rng = np.random.RandomState(seed)
    seen, total, high = [], 0.0, False
    for _ in range(40):
        total += float(rng.choice([0.0, 0.0, 3.0, 40.0]))
        high = rng.rand() < (0.85 if high else 0.3)   # runs of breaches
        q = float(rng.choice([9.0, 9.5])) if high else 0.5
        store.ingest([_fam("gauge", "q", q),
                      _fam("gauge", "q", float(rng.uniform(0, 3)),
                           {"rank": "1"}),
                      _fam("counter", "c_total", total)], now=clk())
        eng.tick()
        seen.append(eng.status())
        clk.t += float(rng.choice([1.0, 3.0, 5.0]))
    return seen


LIFECYCLES = ["hot: q > 8 for 10s : crit", "hot: q > 8 for 6s",
              "now: q >= 5 : page", "low: q < 1 for 4s",
              "busy: rate(c_total[10s]) > 2 : info; hot: q > 9 for 3s"]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("spec", LIFECYCLES)
def test_lifecycle_under_a_fake_clock_matches_reference(spec, seed):
    ref, port = _lifecycle("ref", spec, seed), _lifecycle("port", spec, seed)
    assert port == ref
    states = {a["state"] for s in port for a in s["alerts"]}
    assert states <= {"inactive", "pending", "firing"}


def test_pending_hold_then_firing_then_resolve():
    """tests/test_tsdb.py's lifecycle, step by step, in both packages."""
    runs = []
    for mod, tsdb_mod in MODS.values():
        clk = FakeClock()
        store = tsdb_mod.SeriesStore(interval_s=1.0)
        eng = mod.AlertEngine(mod.parse_rules("hot: q > 8 for 10s : crit"),
                              store=store, clock=clk)
        seen = []
        for dt, v in ((0, 9.0), (5, 9.5), (5, 9.5), (1, 2.0)):
            clk.t += dt
            store.ingest([_fam("gauge", "q", v)], now=clk())
            eng.tick()
            st = eng.status()["alerts"][0]
            seen.append((st["state"], st["fired_total"],
                         st["resolved_total"]))
        runs.append(seen)
    assert runs[0] == runs[1] == [("pending", 0, 0), ("pending", 0, 0),
                                  ("firing", 1, 0), ("inactive", 1, 1)]


def test_firing_sets_gauges_and_records_transitions():
    clk = FakeClock()
    store = tsdb.SeriesStore(interval_s=1.0)
    eng = alerts.AlertEngine(alerts.parse_rules("hot_now: q >= 5 : page"),
                             store=store, clock=clk)
    store.ingest([_fam("gauge", "q", 5.0)], now=clk())
    eng.tick()
    snap = {f["name"]: f for f in REGISTRY.snapshot()}
    [s] = [s for s in snap["hvd_alerts_firing"]["samples"]
           if s["labels"].get("alert") == "hot_now"]
    assert s["value"] == 1.0 and s["labels"]["severity"] == "page"
    clk.t += 1
    store.ingest([_fam("gauge", "q", 1.0)], now=clk())
    eng.tick()
    kinds = [(e["kind"], e["name"]) for e in flightrec.RECORDER.snapshot()]
    assert ("alert_fired", "hot_now") in kinds
    assert ("alert_resolved", "hot_now") in kinds
    assert alerts.render_text(eng.status()) == \
        ref_alerts.render_text(eng.status())


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read().decode()


def test_alertz_endpoint_serves_engine_state():
    srv = server.MetricsServer(0, addr="127.0.0.1")
    try:
        alerts.disarm()
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv.port, "/alertz")
        assert err.value.code == 503
        tsdb.arm(interval_s=3600.0, retention_s=60.0)
        REGISTRY.gauge("torch_alertz_gauge", "alertz acceptance").set(9.0)
        tsdb.sample_now()
        eng = alerts.arm("http_hot: torch_alertz_gauge > 5 : warn",
                         tick_s=3600.0)
        eng.tick()
        blob = json.loads(_get(srv.port, "/alertz.json"))
        assert blob["firing"] == 1
        [a] = [a for a in blob["alerts"] if a["alert"] == "http_hot"]
        assert a["state"] == "firing"
        assert "http_hot" in _get(srv.port, "/alertz")
        assert all(p in _get(srv.port, "/") for p in
                   ("/alertz", "/tracez", "/profz"))
    finally:
        alerts.disarm()
        tsdb.disarm()
        srv.close()

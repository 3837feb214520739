"""Port parity: the fleet trace plane, ``horovod_tpu_torch.obs.tracemerge``.

Held against the JAX package's ``horovod_tpu.obs.tracemerge`` on the same
inputs, with equality as the tolerance, for its pure parts: the blob a
rank publishes (from one tracer and one timeline file), the clock-aligned
Perfetto merge and the critical-path report over per-rank blobs made from
a seed (missing ranks, skewed clocks, cross-process parents, crash-cut
timeline tails: the cases of ``tests/test_tracemerge.py``), and a blob
published by one package's publisher merged by the other's collector over
one KV store.  Rank 0's ``/tracez`` at two ranks under the port's
launcher is ``tests/test_torch_obs_plane.py``'s.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest

from horovod_tpu.obs import tracemerge as ref_tm
from horovod_tpu.obs.trace import Tracer as RefTracer
from horovod_tpu_torch.obs import REGISTRY, tracemerge as tm
from horovod_tpu_torch.obs.trace import Tracer


class _KV:
    """In-process KV with the client surface the trace plane uses."""

    def __init__(self) -> None:
        self._data: dict = {}
        self._cond = threading.Condition()

    def set(self, key, value):
        with self._cond:
            self._data[key] = bytes(value)
            self._cond.notify_all()

    def get(self, key):
        with self._cond:
            return self._data.get(key)

    def wait(self, key, timeout_ms=10000):
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cond:
            while key not in self._data:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"no {key!r}")
                self._cond.wait(left)
            return self._data[key]

    def delete(self, key):
        with self._cond:
            self._data.pop(key, None)

    def close(self):
        pass


PHASES = ("INGRESS", "QUEUE", "PREFILL", "DECODE", "serving.migrated",
          "allreduce")


def _blobs(seed: int) -> tuple:
    """Per-rank blobs from a seed: traces whose spans nest, some parented
    on another rank, on clocks skewed per rank, a rank or two missing,
    and each rank's offset."""
    rng = np.random.RandomState(seed)
    ranks = sorted(rng.choice(6, size=rng.randint(1, 5), replace=False))
    blobs, offsets = {}, {}
    roots = []
    for r in ranks:
        r = int(r)
        skew = float(rng.uniform(-5, 5))
        offsets[r] = skew * 1e6
        traces = []
        for t in range(rng.randint(1, 4)):
            tid = f"t{rng.randint(3)}"
            spans, t0 = [], 0.0
            root = f"s{r}-{t}-0"
            parent = roots[rng.randint(len(roots))] if roots and \
                rng.rand() < 0.5 else None
            spans.append({"span_id": root, "name": "req", "t_offset_s": 0.0,
                          "duration_s": float(rng.uniform(0.5, 2.0)),
                          **({"parent_id": parent} if parent else {})})
            for k in range(1, rng.randint(2, 6)):
                t0 += float(rng.uniform(0, 0.3))
                spans.append({"span_id": f"s{r}-{t}-{k}",
                              "name": PHASES[rng.randint(len(PHASES))],
                              "t_offset_s": t0,
                              "duration_s": float(rng.uniform(0.01, 0.4)),
                              "parent_id": root})
            roots.append(root)
            traces.append({"trace_id": tid, "name": "req",
                           "lane": f"req{r}-{t}",
                           "t_start_unix": 100.0 + skew
                           + float(rng.uniform(0, 1)),
                           "spans": spans})
        tail = []
        if rng.rand() < 0.5:
            tail = [{"name": "clock_sync", "ph": "M", "pid": 0, "tid": 0,
                     "args": {"rank": r, "epoch_us": (100.0 + skew) * 1e6}},
                    {"name": "thread_name", "ph": "M", "pid": 0, "tid": 7,
                     "args": {"name": "allreduce.grad"}}]
            tail += [{"name": "DISPATCH", "ph": "X", "pid": 0, "tid": 7,
                      "ts": float(rng.uniform(0, 1e6)),
                      "dur": float(rng.uniform(1, 1e5))}
                     for _ in range(rng.randint(1, 4))]
        blobs[r] = {"rank": r, "pool": ["router", None, "decode"][r % 3],
                    "traces": traces, "timeline_tail": tail}
    return blobs, offsets


@pytest.mark.parametrize("seed", range(10))
def test_merge_and_critical_path_match_reference(seed):
    blobs, offsets = _blobs(seed)
    for offs in (None, offsets):
        merged = tm.merge_fleet_trace(blobs, offsets_us=offs)
        assert merged == ref_tm.merge_fleet_trace(blobs, offsets_us=offs)
        json.dumps(merged)
        assert tm.critical_path_report(blobs, offsets_us=offs) == \
            ref_tm.critical_path_report(blobs, offsets_us=offs)
    assert {e["pid"] for e in merged["traceEvents"] if e.get("ph") == "X"} \
        <= set(blobs)


def test_critical_gauges_export_as_reference():
    blobs, offsets = _blobs(3)
    report = tm.critical_path_report(blobs, offsets_us=offsets)
    tm.export_critical_gauges(report)
    fam = REGISTRY.get("hvd_trace_critical_phase_seconds")
    for row in report["slowest"][0]["phases"]:
        assert fam.labels(phase=row["phase"],
                          rank=str(row["rank"])).value >= 0


def _finish(tracer, lane):
    root = tracer.start_trace("req", lane=lane)
    for ch in ("QUEUE", "PREFILL"):
        root.child(ch).end()
    root.end()
    return root


def test_local_blob_matches_reference(tmp_path):
    """One tracer and one crash-cut timeline file, read by both packages'
    ``local_trace_blob``: the same blob but for its publication time."""
    t = RefTracer(sample_rate=1.0)
    for lane in ("a", "b"):
        _finish(t, lane)
    path = os.path.join(str(tmp_path), "tl.r1.json")
    evs = [{"name": "clock_sync", "ph": "M", "pid": 0, "tid": 0,
            "args": {"rank": 1, "epoch_us": 100.0e6}}]
    evs += [{"name": f"E{i}", "ph": "X", "pid": 0, "tid": 1,
             "ts": 10.0 * i, "dur": 1.0} for i in range(40)]
    with open(path, "w") as fh:                  # crash-cut: no ']'
        fh.write("[\n" + ",\n".join(json.dumps(e) for e in evs) + ",\n")
    blobs = [mod.decode_trace_blob(mod.local_trace_blob(
        1, pool="p", tracer=t, timeline_path=path, tail_events=8))
        for mod in (ref_tm, tm)]
    for b in blobs:
        b.pop("time")
    assert blobs[0] == blobs[1]
    assert len(blobs[1]["timeline_tail"]) == 9 and len(blobs[1]["traces"]) == 2
    for mod in (ref_tm, tm):
        with pytest.raises(ValueError):
            mod.decode_trace_blob(b"[]")


@pytest.mark.parametrize("publisher", ["ref", "port"])
def test_blob_published_by_one_package_merges_in_the_other(publisher):
    kv = _KV()
    pub_mod, col_mod = (ref_tm, tm) if publisher == "ref" else (tm, ref_tm)
    remote = (RefTracer if publisher == "ref" else Tracer)(sample_rate=1.0)
    r_root = _finish(remote, "remote")
    pub = pub_mod.TracePublisher(1, pool="decode", tracer=remote,
                                 kv_factory=lambda: kv,
                                 echo_poll_s=0.005).start()
    local = (Tracer if publisher == "ref" else RefTracer)(sample_rate=1.0)
    l_root = _finish(local, "local")
    col = col_mod.TraceCollector(own_rank=0, own_pool="router",
                                 tracer=local, kv_factory=lambda: kv)
    try:
        assert pub.publish_now()
        merged = col.collect()
        off = col_mod.estimate_clock_offset(kv, 1, timeout_s=2.0)
    finally:
        col.close()
        pub.stop()
    assert merged["ranks"] == [0, 1]
    tids = {e["args"].get("trace_id") for e in merged["traceEvents"]
            if e.get("ph") == "X"}
    assert {r_root.trace_id, l_root.trace_id} <= tids
    assert off is not None and abs(off) < 5e5


def test_publish_interval_from_env_matches_reference(monkeypatch):
    for raw in (None, "0", "0.5", "-1", "banana"):
        for k in ("HVDTPU_TRACE_PUBLISH_INTERVAL",
                  "HVDTPU_OBS_PUBLISH_INTERVAL"):
            monkeypatch.delenv(k, raising=False)
        if raw is not None:
            monkeypatch.setenv("HVDTPU_TRACE_PUBLISH_INTERVAL", raw)
        assert tm.publish_interval_from_env() == \
            ref_tm.publish_interval_from_env()


def test_fleet_trace_unarmed_falls_back_to_the_local_tracer():
    tm.stop()
    merged = tm.fleet_trace()
    assert merged["ranks"] == [0] and "report" in merged
    names = [e for e in merged["traceEvents"]
             if e.get("name") == "process_name"]
    assert names and names[0]["pid"] == 0

"""Cross-rank metric aggregation: the job-level half of the obs plane.

A copy of the JAX package's ``obs/aggregate.py`` for the port.

A Horovod-style job is only as fast as its slowest rank, and per-process
``/metrics`` endpoints (:mod:`.server`) cannot answer
"which rank is slow" without scraping N processes and joining by hand.
This module turns the per-process registries into one cluster view using
the job's existing authenticated KV control plane — the same store the
rendezvous and ``run_func`` ride — so no new network surface appears:

- every rank runs a :class:`RankPublisher` (started from ``hvd.init()``
  in multi-process mode) that periodically serializes its registry
  snapshot, tagged with rank/size/hostname/pid/uptime, and publishes it
  under ``obs/rank/<r>`` via the chunked-blob helpers of
  :mod:`horovod_tpu_torch.runner.api`;
- any rank (canonically rank 0) merges the published snapshots with
  :func:`merge_snapshots` — counters keep per-rank ``rank``-labeled
  series **and** gain a cluster-summed series, gauges stay per-rank,
  histograms get a bucket-merged cluster series when edges agree — and
  serves the result from the existing HTTP endpoint at ``/cluster`` /
  ``/cluster.json`` next to the per-process ``/metrics``;
- ``hvd.cluster_metrics(fmt)`` returns the same merged view in-process.

Single-process jobs degrade gracefully: with no KV store configured the
cluster view is the local snapshot labeled ``rank="0"`` — the same shape
at world size 1, so dashboards need no special case.

Stdlib-only at import (like the rest of ``obs``); the KV client binding
loads lazily on first use.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Callable, Optional

from . import export
from .registry import REGISTRY, MetricRegistry

#: KV key prefix one rank's snapshot blob lives under (chunked, see
#: runner.api.kv_put_blob: ``obs/rank/<r>/{meta,0,1,...}``).
SNAP_PREFIX = "obs/rank/"

#: default seconds between snapshot publishes (env OBS_PUBLISH_INTERVAL).
DEFAULT_PUBLISH_INTERVAL_S = 2.0

_START_TIME = time.monotonic()


# ---------------------------------------------------------------------------
# snapshot encode/decode
# ---------------------------------------------------------------------------

def _jsonsafe(o):
    """+/-Inf and NaN encode as strings so snapshots are strict JSON
    (the same convention :func:`.export.to_json` uses)."""
    if isinstance(o, float) and (o != o or o in (float("inf"),
                                                 float("-inf"))):
        return export._fmt_value(o)
    if isinstance(o, dict):
        return {k: _jsonsafe(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonsafe(v) for v in o]
    return o


def _num(o):
    """Inverse of :func:`_jsonsafe` for bucket edges."""
    if o == "+Inf":
        return float("inf")
    if o == "-Inf":
        return float("-inf")
    if o == "NaN":
        return float("nan")
    return o


def local_snapshot_blob(rank: int, size: int, *,
                        registry: Optional[MetricRegistry] = None,
                        extra_meta: Optional[dict] = None) -> bytes:
    """One rank's publishable snapshot: registry contents plus the
    identity envelope the aggregator tags series with."""
    payload = {
        "rank": int(rank),
        "size": int(size),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "uptime_s": round(time.monotonic() - _START_TIME, 3),
        "time": time.time(),
        "snapshot": _jsonsafe((registry or REGISTRY).snapshot()),
    }
    if extra_meta:
        payload.update(extra_meta)
    return json.dumps(payload, separators=(",", ":")).encode()


def decode_snapshot_blob(blob: bytes) -> dict:
    """Parse a published snapshot; raises ``ValueError`` on garbage (a
    reader racing a concurrent re-publish skips that rank this scrape)."""
    d = json.loads(blob.decode())
    if not isinstance(d, dict) or "rank" not in d or "snapshot" not in d:
        raise ValueError("not a rank snapshot")
    return d


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def snapshot_is_stale(snap: dict, now: Optional[float] = None) -> bool:
    """True when a rank snapshot's age exceeds 2x its publish interval —
    the publisher has missed two cadences, so the rank is crashed,
    shrunk away, or wedged.  The single staleness definition shared by
    :func:`merge_snapshots` (cluster-sum exclusion, ``stale`` labels)
    and the serving router (a stale replica is ineligible for new
    placements).  The aggregator's fetch path separately hard-drops at
    4x/10s; this is the earlier, advisory threshold."""
    ts = snap.get("time")
    if not ts:
        return False
    interval = float(snap.get("interval_s", DEFAULT_PUBLISH_INTERVAL_S))
    age = max(0.0, (time.time() if now is None else now) - float(ts))
    return age > 2 * interval


def merge_snapshots(rank_snaps: list) -> list:
    """Merge per-rank snapshot envelopes into one cluster-level snapshot
    (same plain-data shape as :meth:`MetricRegistry.snapshot`, so both
    exposition formats serialize it unchanged).

    Per family: every sample reappears with a ``rank`` label; counter
    families additionally get cluster-summed samples (per original label
    set, no ``rank`` label); histogram families get a bucket-merged
    cluster series when every rank agrees on the edges.  Synthetic
    ``horovod_tpu_cluster_*`` gauges describe the aggregation itself
    (world size, ranks reporting, per-rank uptime/snapshot age).

    **Staleness:** a rank whose snapshot age exceeds 2x its publish
    interval is a rank that stopped publishing (crash, shrink, wedge).
    Its per-rank series still appear (the last known state is postmortem
    signal), but the synthetic uptime/age gauges carry ``stale="true"``,
    it is EXCLUDED from the cluster-summed counter and bucket-merged
    histogram series, and it no longer counts toward
    ``ranks_reporting`` — a dead rank's frozen snapshot must not keep
    padding cluster totals and masking the stragglers among the live
    ranks.  (The aggregator's fetch path separately hard-drops snapshots
    older than 4x/10s; this covers the 2x–4x window and aggregations fed
    directly, e.g. tests and the smoke job.)
    """
    fams: dict[str, dict] = {}
    order: list[str] = []
    now = time.time()
    meta_reg = MetricRegistry()
    g_size = meta_reg.gauge(
        "horovod_tpu_cluster_size",
        "world size the aggregator expected this scrape")
    g_reporting = meta_reg.gauge(
        "horovod_tpu_cluster_ranks_reporting",
        "ranks whose snapshot was present, parseable and fresh "
        "(within 2x the publish interval)")
    g_stale = meta_reg.gauge(
        "horovod_tpu_cluster_ranks_stale",
        "ranks whose last snapshot outlived 2x its publish interval "
        "(crashed or wedged; excluded from cluster sums)")
    g_uptime = meta_reg.gauge(
        "horovod_tpu_rank_uptime_seconds",
        "per-rank process uptime at snapshot time", ("rank", "stale"))
    g_age = meta_reg.gauge(
        "horovod_tpu_rank_snapshot_age_seconds",
        "per-rank staleness of the aggregated snapshot",
        ("rank", "stale"))

    size = 0
    n_stale = 0
    for snap in rank_snaps:
        r = str(snap["rank"])
        size = max(size, int(snap.get("size", 0)))
        age = (max(0.0, now - float(snap["time"]))
               if snap.get("time") else 0.0)
        stale = snapshot_is_stale(snap, now)
        n_stale += stale
        st = "true" if stale else "false"
        g_uptime.labels(rank=r, stale=st).set(
            float(snap.get("uptime_s", 0.0)))
        g_age.labels(rank=r, stale=st).set(age)
        for fam in snap["snapshot"]:
            name = fam["name"]
            merged = fams.get(name)
            if merged is None:
                labelnames = list(fam.get("labelnames", ()))
                # The reporting rank is tagged "rank"; a family that
                # already owns a "rank" label of its own (e.g. the
                # straggler gauge, where rank = the straggler) gets
                # "from_rank" instead — otherwise several ranks
                # reporting the same straggler would collapse into
                # duplicate series and invalidate the exposition.
                rep = "rank" if "rank" not in labelnames else "from_rank"
                labelnames.append(rep)
                merged = {
                    "name": name, "type": fam["type"],
                    "help": fam.get("help", ""),
                    "labelnames": labelnames, "samples": [],
                    "_totals": {}, "_hist": {}, "_hist_ok": True,
                    "_rep": rep,
                }
                fams[name] = merged
                order.append(name)
            rep = merged["_rep"]
            for s in fam["samples"]:
                labels = dict(s.get("labels", {}))
                labels[rep] = r
                key = tuple(sorted(
                    (k, v) for k, v in labels.items() if k != rep))
                if fam["type"] == "counter":
                    merged["samples"].append(
                        {"labels": labels, "value": s["value"]})
                    if not stale:    # dead ranks don't pad cluster sums
                        merged["_totals"][key] = \
                            merged["_totals"].get(key, 0.0) + \
                            float(s["value"])
                elif fam["type"] == "histogram":
                    buckets = [(_num(le), c) for le, c in s["buckets"]]
                    merged["samples"].append(
                        {"labels": labels, "buckets": buckets,
                         "sum": s["sum"], "count": s["count"]})
                    if stale:        # per-rank series only
                        continue
                    edges = tuple(le for le, _ in buckets)
                    acc = merged["_hist"].get(key)
                    if acc is None:
                        merged["_hist"][key] = {
                            "edges": edges,
                            "counts": [c for _, c in buckets],
                            "sum": float(s["sum"]),
                            "count": int(s["count"])}
                    elif acc["edges"] == edges:
                        acc["counts"] = [a + c for a, (_, c)
                                         in zip(acc["counts"], buckets)]
                        acc["sum"] += float(s["sum"])
                        acc["count"] += int(s["count"])
                    else:   # bucket layouts diverged across ranks
                        merged["_hist_ok"] = False
                else:
                    merged["samples"].append(
                        {"labels": labels, "value": s["value"]})

    out = []
    for name in order:
        fam = fams[name]
        samples = fam["samples"]
        if fam["type"] == "counter":
            for key, total in sorted(fam["_totals"].items()):
                samples.append({"labels": dict(key), "value": total})
        elif fam["type"] == "histogram" and fam["_hist_ok"]:
            for key, acc in sorted(fam["_hist"].items()):
                samples.append({
                    "labels": dict(key),
                    "buckets": list(zip(acc["edges"], acc["counts"])),
                    "sum": acc["sum"], "count": acc["count"]})
        out.append({"name": fam["name"], "type": fam["type"],
                    "help": fam["help"],
                    "labelnames": fam["labelnames"], "samples": samples})

    g_size.set(float(size or len(rank_snaps)))
    g_reporting.set(float(len(rank_snaps) - n_stale))
    g_stale.set(float(n_stale))
    out.extend(meta_reg.snapshot())
    return sorted(out, key=lambda f: f["name"])


# ---------------------------------------------------------------------------
# KV transport (publisher + aggregator)
# ---------------------------------------------------------------------------

def _kv_from_env():
    """KV client for the job's rendezvous store, or None outside a job.
    Lazy import: the native binding must not load at ``import
    horovod_tpu_torch.obs`` time."""
    addr = os.environ.get("HVDTPU_RENDEZVOUS_ADDR")
    if not addr:
        return None
    from .._native import KvClient
    host, _, port = addr.rpartition(":")
    return KvClient(host or "127.0.0.1", int(port), timeout_ms=5000)


class RankPublisher:
    """Daemon thread publishing this rank's snapshot to ``obs/rank/<r>``
    every ``interval_s`` seconds (and once immediately at start, so a
    fresh world is scrapeable before the first interval elapses)."""

    def __init__(self, rank: int, size: int, *,
                 interval_s: float = DEFAULT_PUBLISH_INTERVAL_S,
                 registry: Optional[MetricRegistry] = None,
                 kv_factory: Callable = _kv_from_env) -> None:
        self.rank = int(rank)
        self.size = int(size)
        self._interval = max(0.1, float(interval_s))
        self._registry = registry or REGISTRY
        self._kv_factory = kv_factory
        self._kv = None
        self._kv_lock = threading.Lock()
        self._stop = threading.Event()
        self._warned = False
        self._thread = threading.Thread(
            target=self._loop, name="hvdtpu-obs-publish", daemon=True)

    def start(self) -> "RankPublisher":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.publish_now()
            self._stop.wait(self._interval)

    def publish_now(self) -> bool:
        """One publish attempt; False (never an exception) on transport
        trouble — telemetry must not take the job down.  Transient KV
        errors retry under the shared backoff policy, but only within
        half a publish cadence: a slow store must drop THIS snapshot
        rather than make the publisher fall permanently behind."""
        from ..runner.api import kv_put_blob
        blob = local_snapshot_blob(
            self.rank, self.size, registry=self._registry,
            # The aggregator uses the cadence to age out snapshots of
            # ranks that stopped publishing (elastic shrink, crash).
            extra_meta={"interval_s": self._interval})
        with self._kv_lock:
            try:
                if self._kv is None:
                    self._kv = self._kv_factory()
                if self._kv is None:
                    return False
                kv_put_blob(self._kv, f"{SNAP_PREFIX}{self.rank}", blob,
                            deadline_s=max(0.25, self._interval / 2))
                return True
            except (ConnectionError, OSError, TimeoutError) as e:
                self._drop_kv()
                if not self._warned:
                    self._warned = True
                    from ..utils import logging as hvd_logging
                    hvd_logging.get_logger().warning(
                        "obs: snapshot publish failed (%s); cluster view "
                        "will miss rank %d until the KV store returns",
                        e, self.rank)
                return False

    def _drop_kv(self) -> None:
        if self._kv is not None:
            try:
                self._kv.close()
            except OSError:
                pass
            self._kv = None

    def stop(self, *, retract: bool = True) -> None:
        """Stop publishing.  ``retract`` (default) also deletes this
        rank's snapshot on a clean stop (elastic shrink within one
        KV-store lifetime): a stopped rank must not keep contributing
        frozen values to the cluster view.  The staleness filter in
        :class:`ClusterAggregator` covers ranks that crash instead.
        Pass ``retract=False`` when the snapshot should outlive the
        publisher (one-shot publishers, tests)."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        with self._kv_lock:
            if retract and self._kv is not None:
                try:
                    self._kv.delete(f"{SNAP_PREFIX}{self.rank}/meta")
                except (ConnectionError, OSError):
                    pass
            self._drop_kv()


class ClusterAggregator:
    """Reads every rank's published snapshot and merges them.

    The caller's own rank (if any) is read live from the local registry
    instead of the KV store, so the aggregating process is never stale
    about itself and the path also works with no KV store at all
    (single-process: the "cluster" is this process)."""

    def __init__(self, *, own_rank: int = 0, own_size: int = 1,
                 registry: Optional[MetricRegistry] = None,
                 kv_factory: Callable = _kv_from_env,
                 include_local: bool = True) -> None:
        self.own_rank = int(own_rank)
        self.own_size = int(own_size)
        self._registry = registry or REGISTRY
        self._kv_factory = kv_factory
        self._include_local = include_local
        self._kv = None
        self._lock = threading.Lock()

    def collect(self, timeout_ms: int = 500) -> list:
        """Fetch + merge; always returns a valid snapshot (at minimum the
        local rank's).  ``include_local=False`` aggregators (a driver
        process that is not itself a rank) merge KV snapshots only."""
        snaps = {}
        if self._include_local:
            snaps[self.own_rank] = json.loads(local_snapshot_blob(
                self.own_rank, self.own_size,
                registry=self._registry).decode())
        with self._lock:
            try:
                if self._kv is None:
                    self._kv = self._kv_factory()
            except (ConnectionError, OSError):
                self._kv = None
            if self._kv is not None:
                try:
                    snaps.update(self._fetch_remote(timeout_ms, snaps))
                except (ConnectionError, OSError):
                    # server gone mid-scrape: serve what we have, drop the
                    # client so the next scrape reconnects.
                    try:
                        self._kv.close()
                    except OSError:
                        pass
                    self._kv = None
        merged = merge_snapshots(
            [snaps[r] for r in sorted(snaps)])
        # Every merge this process serves also extends its longitudinal
        # fleet history (no-op unless the tsdb tier is armed) — so
        # rank 0 / the driver can answer /query?source=cluster over the
        # same rank-labeled series /cluster exposes instantaneously.
        from . import tsdb
        tsdb.ingest_cluster(merged)
        return merged

    def _fetch_remote(self, timeout_ms: int, have: dict) -> dict:
        from ..runner.api import kv_get_blob
        out: dict = {}
        # World size: start from our own knowledge, and grow the sweep
        # as fetched snapshots report a larger world — a grown elastic
        # job's new ranks re-publish with the new size, so a scrape
        # served before this process re-armed still covers them.
        size = max(self.own_size, 1)
        r = 0
        while r < size:
            if r in have:
                size = max(size, int(have[r].get("size", 0)))
                r += 1
                continue
            try:
                if self._kv.get(f"{SNAP_PREFIX}{r}/meta") is None:
                    r += 1
                    continue
                snap = decode_snapshot_blob(
                    kv_get_blob(self._kv, f"{SNAP_PREFIX}{r}",
                                timeout_ms=timeout_ms))
            except (ValueError, TimeoutError):
                r += 1
                continue    # mid-rewrite or stale; skip this scrape
            if int(snap["rank"]) == r and not self._is_stale(snap):
                out[r] = snap
                size = max(size, int(snap.get("size", 0)))
            r += 1
        return out

    @staticmethod
    def _is_stale(snap: dict) -> bool:
        """A snapshot whose publisher has missed several cadences is a
        dead rank's leftover (crash; shrink without a clean stop) — drop
        it so the cluster view, its summed counters, and the
        ranks-reporting gauge reflect the live world.  The 10s floor
        absorbs modest wall-clock skew across hosts."""
        ts = snap.get("time")
        if not ts:
            return False
        interval = float(snap.get("interval_s",
                                  DEFAULT_PUBLISH_INTERVAL_S))
        return (time.time() - float(ts)) > max(4 * interval, 10.0)

    def close(self) -> None:
        with self._lock:
            if self._kv is not None:
                try:
                    self._kv.close()
                except OSError:
                    pass
                self._kv = None


# ---------------------------------------------------------------------------
# process-wide wiring (context.init()/shutdown() call these)
# ---------------------------------------------------------------------------

_publisher: Optional[RankPublisher] = None
_aggregator: Optional[ClusterAggregator] = None
_wiring_lock = threading.Lock()


def publish_interval_from_env() -> float:
    """``HVDTPU_/HOROVOD_TPU_/HOROVOD_ OBS_PUBLISH_INTERVAL`` seconds;
    <= 0 disables publishing."""
    for prefix in ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_"):
        raw = os.environ.get(prefix + "OBS_PUBLISH_INTERVAL")
        if raw:
            try:
                return float(raw)
            except ValueError:
                return DEFAULT_PUBLISH_INTERVAL_S
    return DEFAULT_PUBLISH_INTERVAL_S


def start_for_rank(rank: int, size: int) -> None:
    """Arm the obs plane for this process's place in the job: every rank
    publishes; every rank can also aggregate (``/cluster`` answers
    everywhere, though rank 0 is the canonical scrape target).  Restarts
    cleanly on elastic re-init with a new world size."""
    global _publisher, _aggregator
    with _wiring_lock:
        if _publisher is not None:
            _publisher.stop()
            _publisher = None
        if _aggregator is not None:
            _aggregator.close()
        interval = publish_interval_from_env()
        if os.environ.get("HVDTPU_RENDEZVOUS_ADDR") and interval > 0:
            _publisher = RankPublisher(rank, size,
                                       interval_s=interval).start()
        _aggregator = ClusterAggregator(own_rank=rank, own_size=size)
        from . import server
        server.set_cluster_provider(_aggregator.collect)


def publish_now() -> bool:
    """Force an immediate publish (elastic grow/shrink republish; tests).
    False when no publisher is armed or the publish failed."""
    with _wiring_lock:
        pub = _publisher
    return pub.publish_now() if pub is not None else False


def stop() -> None:
    global _publisher, _aggregator
    with _wiring_lock:
        if _publisher is not None:
            _publisher.stop()
            _publisher = None
        if _aggregator is not None:
            _aggregator.close()
            _aggregator = None
        from . import server
        server.set_cluster_provider(None)


def cluster_snapshot() -> list:
    """The merged cluster snapshot (plain data).  Works before/without
    ``init()``: the un-armed fallback serves the local registry only
    (labeled rank 0) — it does NOT touch the KV store, since without
    init() this process doesn't know its own rank and must not pass off
    its local series as some other rank's, nor leak a throwaway client
    per call."""
    with _wiring_lock:
        agg = _aggregator
    if agg is not None:
        return agg.collect()
    fallback = ClusterAggregator(kv_factory=lambda: None)
    try:
        return fallback.collect()
    finally:
        fallback.close()

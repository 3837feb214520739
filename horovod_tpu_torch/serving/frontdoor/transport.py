"""Router <-> replica request transport over the job's KV store.

Replicas are dp serving processes; the router is one process placing
requests across them.  Like the obs plane (``obs/aggregate``), the
transport rides the job's existing authenticated KV control plane — no
new network surface.  Key layout (replica rank ``r``, router-assigned
sequence number ``q``):

- ``fd/member/<r>`` — membership record (JSON), written at replica
  start and re-published after an elastic re-init
  (:func:`republish_membership` hooks the elastic rejoin path);
- ``fd/req/<r>/<q>`` — one request, a chunked blob
  (:func:`~horovod_tpu_torch.runner.api.kv_put_blob`: the meta key lands
  last, so a replica that sees it can read the whole payload);
- ``fd/res/<r>/<q>`` — the matching result blob;
- ``fd/prog/<r>/<q>`` — plain JSON progress record (tokens emitted so
  far), re-set on every streamed token for router-side relays.

Sequence numbers are assigned by the router and consumed in order by
the replica — a SINGLE-ROUTER assumption (one placement authority per
job), which buys a poll loop with no key listing.

Replica-side readiness rides the obs plane: :class:`ReplicaServer`
mirrors ``context.component_health("serving")`` into the
``hvd_replica_ready`` gauge, which the rank's
:class:`~horovod_tpu_torch.obs.aggregate.RankPublisher` snapshot carries to
the router along with queue depth, TTFT p99 and SLO burn — the router
never scrapes replicas directly.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

import numpy as np

from ...obs import REGISTRY as _obs
from ...obs.aggregate import (SNAP_PREFIX, _kv_from_env,
                              decode_snapshot_blob, snapshot_is_stale)
from ...obs.aggregate import _num as _edge_num

MEMBER_PREFIX = "fd/member/"
REQ_PREFIX = "fd/req/"
RES_PREFIX = "fd/res/"
PROG_PREFIX = "fd/prog/"

_m_ready = _obs.gauge(
    "hvd_replica_ready",
    "this replica accepts new placements (serving component healthy); "
    "published to the router through the rank's obs snapshot")
_m_pool_info = _obs.gauge(
    "hvd_serving_pool_info",
    "pool this replica serves (value 1; the pool is the label) — merged "
    "cluster snapshots add the rank label, giving the autoscaler its "
    "rank->pool map", ("pool",))
_m_served = _obs.counter(
    "hvd_replica_requests_served_total",
    "requests this replica completed for the router")

#: live ReplicaServers in this process, for membership republish after
#: an elastic re-init (the KV store may be a fresh one).
_servers: list = []
_servers_lock = threading.Lock()


def republish_membership() -> None:
    """Re-register every live replica server (elastic rejoin hook —
    called from the runner's re-initialize path; must never raise)."""
    with _servers_lock:
        servers = list(_servers)
    for s in servers:
        try:
            s.register()
        except (ConnectionError, OSError, TimeoutError):
            pass


# ---------------------------------------------------------------------------
# signal extraction (router side)
# ---------------------------------------------------------------------------

def _hist_quantile(fam: Optional[dict], q: float) -> Optional[float]:
    """Upper-edge quantile estimate from a snapshot histogram family
    (cumulative buckets); None when absent or empty.  Multiple labeled
    series merge by bucket — the router wants the replica-wide view."""
    if not fam or not fam.get("samples"):
        return None
    acc: dict[float, int] = {}
    total = 0
    for s in fam["samples"]:
        total += int(s.get("count", 0))
        for le, c in s.get("buckets", ()):
            le = _edge_num(le)
            acc[le] = acc.get(le, 0) + int(c)
    if total == 0:
        return None
    target = q * total
    last_finite = 0.0
    for le in sorted(acc):
        if le != float("inf"):
            last_finite = le
        if acc[le] >= target:
            return le if le != float("inf") else last_finite
    return last_finite


def signals_from_snapshot(snap: dict) -> dict:
    """Placement signals out of one rank's published obs snapshot:
    queue depth, batch occupancy, readiness, TTFT p99, worst SLO burn
    rate, and the shared 2x-interval staleness verdict."""
    fams = {f["name"]: f for f in snap.get("snapshot", ())}

    def gauge(name: str, default: float = 0.0) -> float:
        fam = fams.get(name)
        if not fam or not fam.get("samples"):
            return default
        return float(fam["samples"][0]["value"])

    burn = 0.0
    burn_fam = fams.get("hvd_slo_burn_rate")
    if burn_fam:
        burn = max((float(s["value"]) for s in burn_fam["samples"]),
                   default=0.0)
    pool = None
    pool_fam = fams.get("hvd_serving_pool_info")
    if pool_fam and pool_fam.get("samples"):
        pool = pool_fam["samples"][0].get("labels", {}).get("pool")
    return {
        "rank": int(snap.get("rank", -1)),
        "alive": True,
        "stale": snapshot_is_stale(snap),
        "ready": gauge("hvd_replica_ready") >= 1.0,
        "pool": pool,
        "queue_depth": gauge("hvd_serving_queue_depth"),
        "occupancy": gauge("hvd_serving_batch_occupancy"),
        "ttft_p99": _hist_quantile(
            fams.get("hvd_serving_ttft_seconds"), 0.99),
        "itl_p99": _hist_quantile(
            fams.get("hvd_serving_itl_seconds"), 0.99),
        "slo_burn": burn,
        "time": float(snap.get("time", 0.0)),
    }


#: reads of a replica's snapshot before a torn one counts as no snapshot
TORN_SNAPSHOT_READS = 3

#: the signal record for a replica the router cannot see at all
DEAD_SIGNALS = {"alive": False, "stale": True, "ready": False,
                "pool": None, "queue_depth": float("inf"),
                "occupancy": 1.0, "ttft_p99": None, "itl_p99": None,
                "slo_burn": 0.0}


# ---------------------------------------------------------------------------
# replica side
# ---------------------------------------------------------------------------

class ReplicaServer:
    """One replica's transport endpoint: polls ``fd/req/<rank>/<seq>``
    in sequence order, submits into the local
    :class:`~horovod_tpu_torch.serving.api.ServingSession`, streams progress,
    and publishes results.  Start the session's background thread (or
    drain it elsewhere) — this class only moves requests, it does not
    step the engine."""

    def __init__(self, session, rank: int, *,
                 kv_factory: Callable = _kv_from_env,
                 poll_interval_s: float = 0.05,
                 pool: Optional[str] = None) -> None:
        kv = kv_factory()
        if kv is None:
            raise RuntimeError(
                "ReplicaServer needs the job KV store "
                "(HVDTPU_RENDEZVOUS_ADDR unset?)")
        self._kv = kv
        self._kv_lock = threading.Lock()
        self.session = session
        self.rank = int(rank)
        #: which pool this replica serves (disaggregated serving):
        #: "prefill", "decode", or "mixed" (the default — eligible for
        #: everything, the pre-disagg behavior).
        self.pool = pool or os.environ.get("HVDTPU_SERVING_POOL", "mixed")
        self._poll = poll_interval_s
        self._seq = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name=f"hvdtpu-fd-replica{rank}",
            daemon=True)

    def register(self) -> None:
        rec = {"rank": self.rank, "pid": os.getpid(),
               "pool": self.pool, "time": time.time()}
        _m_pool_info.labels(pool=self.pool).set(1.0)
        with self._kv_lock:
            self._kv.set(f"{MEMBER_PREFIX}{self.rank}",
                         json.dumps(rec).encode())

    def start(self) -> "ReplicaServer":
        self.register()
        self._sample_ready()
        with _servers_lock:
            _servers.append(self)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        with _servers_lock:
            if self in _servers:
                _servers.remove(self)
        with self._kv_lock:
            try:
                self._kv.delete(f"{MEMBER_PREFIX}{self.rank}")
            except (ConnectionError, OSError):
                pass

    def _sample_ready(self) -> None:
        from ...context import component_health
        _m_ready.set(1.0 if component_health("serving") else 0.0)

    def _loop(self) -> None:
        from ...runner.api import kv_get_blob
        while not self._stop.is_set():
            self._sample_ready()
            key = f"{REQ_PREFIX}{self.rank}/{self._seq}"
            try:
                with self._kv_lock:
                    has = self._kv.get(f"{key}/meta") is not None
                if not has:
                    self._stop.wait(self._poll)
                    continue
                with self._kv_lock:
                    payload = json.loads(
                        kv_get_blob(self._kv, key).decode())
            except (ConnectionError, OSError, TimeoutError, ValueError):
                self._stop.wait(self._poll)
                continue
            seq = self._seq
            self._seq += 1
            self._dispatch(seq, payload)

    def _dispatch(self, seq: int, payload: dict) -> None:
        prog_key = f"{PROG_PREFIX}{self.rank}/{seq}"
        tokens: list[int] = []

        def on_token(req_id: int, token: int) -> None:
            # Runs on the serving thread; the lock serializes against
            # the poll loop's KV use.
            tokens.append(int(token))
            try:
                with self._kv_lock:
                    self._kv.set(prog_key, json.dumps(tokens).encode())
            except (ConnectionError, OSError, TimeoutError):
                pass             # progress is best-effort; results are not

        mode = payload.get("mode", "generate")
        # Trace context carried over the transport: the router's ingress
        # span; the engine joins its trace instead of opening a new one
        # (decode_import gets it from the migration manifest instead).
        trace_ctx = payload.get("trace")
        extra = {}
        try:
            if mode == "generate":
                fut = self.session.submit(
                    payload["prompt"], payload["max_tokens"],
                    eos_token=payload.get("eos_token"),
                    stream_cb=on_token, trace_ctx=trace_ctx)
            elif mode == "prefill_export":
                # Prefill-pool leg of a disaggregated request: run the
                # prefill, export the KV blocks, publish them under the
                # router-assigned migration id, and resolve with
                # finish_reason="migrated".
                from ..disagg import transport as mig_transport
                mig_id = payload["mig_id"]
                extra["mig_id"] = mig_id

                def publish(manifest, k_bytes, v_bytes):
                    with self._kv_lock:
                        mig_transport.publish_migration(
                            self._kv, mig_id, manifest, k_bytes, v_bytes)

                fut = self.session.submit(
                    payload["prompt"], payload["max_tokens"],
                    eos_token=payload.get("eos_token"),
                    stream_cb=on_token, migrate_cb=publish,
                    trace_ctx=trace_ctx)
            elif mode == "decode_import":
                # Decode-pool leg: fetch the migrated blocks, attach
                # them to the local pool, resume decoding.  The
                # progress stream is seeded with the tokens the prefill
                # replica already emitted.
                from ..disagg import transport as mig_transport
                mig_id = payload["mig_id"]
                with self._kv_lock:
                    manifest, k_bytes, v_bytes = \
                        mig_transport.fetch_migration(
                            self._kv, mig_id,
                            timeout_ms=int(payload.get(
                                "fetch_timeout_ms", 15000)))
                tokens.extend(int(t) for t in manifest["generated"])
                with self._kv_lock:
                    self._kv.set(prog_key, json.dumps(tokens).encode())
                fut = self.session.import_migrated(
                    manifest, k_bytes, v_bytes, stream_cb=on_token)
            else:
                raise ValueError(f"unknown request mode {mode!r}")
        except Exception as e:
            self._publish_error(seq, e, extra)
            return
        fut.add_done_callback(
            lambda f: self._publish_result(seq, f, extra))

    def _publish_error(self, seq: int, exc: Exception,
                       extra: Optional[dict] = None) -> None:
        out = {"ok": False, "error": str(exc),
               "error_kind": type(exc).__name__}
        out.update(extra or {})
        from ...runner.api import kv_put_blob
        try:
            with self._kv_lock:
                kv_put_blob(self._kv, f"{RES_PREFIX}{self.rank}/{seq}",
                            json.dumps(out).encode())
        except (ConnectionError, OSError, TimeoutError):
            pass

    def _publish_result(self, seq: int, fut,
                        extra: Optional[dict] = None) -> None:
        from ...runner.api import kv_put_blob
        try:
            res = fut.result()
            out = {"ok": True, "tokens": list(res.tokens),
                   "finish_reason": res.metrics.get("finish_reason"),
                   "metrics": res.metrics}
        except Exception as e:               # replica-side failure
            out = {"ok": False, "error": str(e),
                   "error_kind": type(e).__name__}
        out.update(extra or {})
        _m_served.inc()
        try:
            with self._kv_lock:
                kv_put_blob(self._kv, f"{RES_PREFIX}{self.rank}/{seq}",
                            json.dumps(out).encode())
        except (ConnectionError, OSError, TimeoutError):
            pass   # the router's staleness/failover path covers the loss


# ---------------------------------------------------------------------------
# router side
# ---------------------------------------------------------------------------

class KVReplicaClient:
    """Router-side handle to one replica rank, implementing the replica
    protocol the :class:`~horovod_tpu_torch.serving.frontdoor.router.Router`
    places against (``signals``/``submit``/``result``/``partial_tokens``
    /``drive``).  Submit handles are the transport sequence numbers."""

    def __init__(self, rank: int, kv=None, *,
                 kv_factory: Callable = _kv_from_env) -> None:
        self.rank = int(rank)
        self.replica_id = str(rank)
        self._kv = kv if kv is not None else kv_factory()
        if self._kv is None:
            raise RuntimeError(
                "KVReplicaClient needs the job KV store "
                "(HVDTPU_RENDEZVOUS_ADDR unset?)")
        self._seq = 0          # single-router assumption (module doc)
        self._pool: Optional[str] = None

    @property
    def pool(self) -> str:
        """Pool tag from the replica's published membership record
        ("mixed" until the record is visible); cached after first
        read — a replica's pool does not change within a job."""
        if self._pool is None:
            try:
                raw = self._kv.get(f"{MEMBER_PREFIX}{self.rank}")
                if raw is not None:
                    self._pool = json.loads(raw.decode()).get(
                        "pool", "mixed")
            except (ConnectionError, OSError, TimeoutError, ValueError):
                pass
        return self._pool or "mixed"

    def drive(self) -> None:
        """Remote replicas step themselves."""

    def signals(self) -> dict:
        from ...runner.api import kv_get_blob
        try:
            if self._kv.get(f"{MEMBER_PREFIX}{self.rank}") is None:
                return dict(DEAD_SIGNALS, rank=self.rank)
            if self._kv.get(f"{SNAP_PREFIX}{self.rank}/meta") is None:
                return dict(DEAD_SIGNALS, rank=self.rank)
            # A torn read (ValueError: the publisher rewrote the snapshot
            # while it was read) shows a live publisher, so it is read
            # again; reported dead, it would take a live replica out of
            # its pool for a pass.
            for attempt in range(TORN_SNAPSHOT_READS):
                try:
                    snap = decode_snapshot_blob(kv_get_blob(
                        self._kv, f"{SNAP_PREFIX}{self.rank}",
                        timeout_ms=2000))
                    break
                except ValueError:
                    if attempt == TORN_SNAPSHOT_READS - 1:
                        raise
        except (ConnectionError, OSError, TimeoutError, ValueError):
            return dict(DEAD_SIGNALS, rank=self.rank)
        return signals_from_snapshot(snap)

    def submit(self, prompt, max_tokens: int, *,
               eos_token: Optional[int] = None,
               trace_ctx: Optional[dict] = None) -> int:
        payload = {"prompt": [int(t) for t in np.asarray(prompt)],
                   "max_tokens": int(max_tokens),
                   "eos_token": eos_token}
        if trace_ctx is not None:
            payload["trace"] = trace_ctx
        return self._submit_payload(payload)

    def submit_prefill(self, prompt, max_tokens: int, *,
                       eos_token: Optional[int] = None,
                       mig_id: str,
                       trace_ctx: Optional[dict] = None) -> int:
        """Disaggregated prefill leg: the replica prefills, publishes
        the KV export under ``mig_id``, and resolves with
        ``finish_reason="migrated"``."""
        payload = {"prompt": [int(t) for t in np.asarray(prompt)],
                   "max_tokens": int(max_tokens),
                   "eos_token": eos_token,
                   "mode": "prefill_export", "mig_id": str(mig_id)}
        if trace_ctx is not None:
            payload["trace"] = trace_ctx
        return self._submit_payload(payload)

    def submit_import(self, mig_id: str, *,
                      fetch_timeout_ms: int = 15000) -> int:
        """Disaggregated decode leg: the replica fetches the migration
        blob, attaches it, and decodes to completion."""
        return self._submit_payload(
            {"mode": "decode_import", "mig_id": str(mig_id),
             "fetch_timeout_ms": int(fetch_timeout_ms)})

    def _submit_payload(self, payload: dict) -> int:
        from ...runner.api import kv_put_blob
        seq = self._seq
        self._seq += 1
        kv_put_blob(self._kv, f"{REQ_PREFIX}{self.rank}/{seq}",
                    json.dumps(payload).encode())
        return seq

    def partial_tokens(self, handle: int) -> list[int]:
        try:
            raw = self._kv.get(f"{PROG_PREFIX}{self.rank}/{handle}")
        except (ConnectionError, OSError, TimeoutError):
            return []
        return json.loads(raw.decode()) if raw else []

    def result(self, handle: int) -> Optional[dict]:
        try:
            key = f"{RES_PREFIX}{self.rank}/{handle}"
            if self._kv.get(f"{key}/meta") is None:
                return None
            from ...runner.api import kv_get_blob
            return json.loads(
                kv_get_blob(self._kv, key, timeout_ms=2000).decode())
        except (ConnectionError, OSError, TimeoutError, ValueError):
            return None

"""Migration blobs over the KV-store control plane.

A migration is three chunked blobs under ``fd/mig/<mig_id>/`` — the K
payload, the V payload, and the JSON manifest, written in that order so
a reader that sees the manifest can fetch complete payloads.  All
chunks of one migration share ONE
:class:`~horovod_tpu_torch.utils.retry.RetryPolicy` deadline (the same
budget-shape fix :func:`~horovod_tpu_torch.runner.api.kv_put_blob` got for
run_func blobs): a flaky store degrades the whole publish, never
stretches it to ``chunks x timeout``.

Torn-read detection is two-layered: each blob's meta record carries its
byte length (:func:`kv_get_blob` checks it), and the manifest's
``version`` field is re-read after the payload fetch — a republish of
the same mig_id mid-fetch (failover replaying the export) flips the
version and the importer retries from the manifest instead of attaching
spliced pages.

Chaos sites: ``mig_export`` fires once per published blob (so
``after=N`` lands a fault genuinely mid-migration, between chunks) and
``mig_import`` once per fetched blob.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from ... import chaos
from ...obs import REGISTRY as _obs
from ...runner.api import kv_get_blob, kv_put_blob

#: migration blobs live here in the job KV namespace.
MIG_PREFIX = "fd/mig/"

_m_migrations = _obs.counter(
    "hvd_disagg_migrations_total",
    "migration transfers by stage outcome", ("outcome",))
_m_publish_s = _obs.histogram(
    "hvd_disagg_publish_seconds",
    "export-side publish latency (all chunks of one migration)")
_m_fetch_s = _obs.histogram(
    "hvd_disagg_fetch_seconds",
    "import-side fetch latency (all chunks of one migration)")


class MigrationUnavailable(Exception):
    """The migration blob is absent, torn, or expired — the caller
    replays from an earlier durable point (usually the prompt)."""


def _keys(mig_id: str) -> tuple[str, str, str]:
    base = f"{MIG_PREFIX}{mig_id}"
    return f"{base}/k", f"{base}/v", f"{base}/manifest"


def publish_migration(kv, mig_id: str, manifest: dict, k_bytes: bytes,
                      v_bytes: bytes, *,
                      deadline_s: Optional[float] = None) -> None:
    """Publish one migration under ``fd/mig/<mig_id>`` — payloads first,
    manifest last, ONE shared deadline across every chunk of all three
    blobs."""
    k_key, v_key, m_key = _keys(mig_id)
    n_chunks = sum(max(1, (len(b) + (4 << 20) - 1) // (4 << 20))
                   for b in (k_bytes, v_bytes)) + 1
    if deadline_s is None:
        deadline_s = max(10.0, 2.0 * n_chunks)
    t0 = time.monotonic()
    deadline = t0 + deadline_s
    try:
        for key, blob in ((k_key, k_bytes), (v_key, v_bytes)):
            chaos.fire("mig_export")
            kv_put_blob(kv, key, blob,
                        deadline_s=max(0.001, deadline - time.monotonic()))
        chaos.fire("mig_export")
        kv_put_blob(kv, m_key,
                    json.dumps(manifest, sort_keys=True).encode(),
                    deadline_s=max(0.001, deadline - time.monotonic()))
    except Exception:
        _m_migrations.labels(outcome="publish_error").inc()
        raise
    _m_migrations.labels(outcome="published").inc()
    _m_publish_s.observe(time.monotonic() - t0)


def fetch_migration(kv, mig_id: str, *, timeout_ms: int = 15000
                    ) -> tuple[dict, bytes, bytes]:
    """Fetch one migration; ONE overall deadline across the manifest
    wait and every payload chunk.  Raises
    :class:`MigrationUnavailable` on absence/timeout and on a torn read
    (payload length or manifest version contradicting the manifest that
    started the fetch)."""
    k_key, v_key, m_key = _keys(mig_id)
    t0 = time.monotonic()
    deadline = t0 + timeout_ms / 1000.0

    def remaining_ms() -> int:
        return max(1, int((deadline - time.monotonic()) * 1000))

    try:
        chaos.fire("mig_import")
        manifest = json.loads(kv_get_blob(kv, m_key,
                                          timeout_ms=remaining_ms()))
        chaos.fire("mig_import")
        k_bytes = kv_get_blob(kv, k_key, timeout_ms=remaining_ms())
        chaos.fire("mig_import")
        v_bytes = kv_get_blob(kv, v_key, timeout_ms=remaining_ms())
        # Version re-check: a concurrent republish of this mig_id
        # (failover re-running the export) may have swapped the payload
        # blobs under us after we read the manifest.
        manifest2 = json.loads(kv_get_blob(kv, m_key,
                                           timeout_ms=remaining_ms()))
    except (TimeoutError, ConnectionError, OSError, ValueError) as e:
        _m_migrations.labels(outcome="fetch_error").inc()
        raise MigrationUnavailable(
            f"migration {mig_id!r} unavailable: {e}") from e
    if manifest2.get("version") != manifest.get("version"):
        _m_migrations.labels(outcome="torn").inc()
        raise MigrationUnavailable(
            f"migration {mig_id!r} torn: manifest version flipped "
            f"{manifest.get('version')!r} -> {manifest2.get('version')!r} "
            "mid-fetch")
    if len(k_bytes) != manifest.get("k_len") or \
            len(v_bytes) != manifest.get("v_len"):
        _m_migrations.labels(outcome="torn").inc()
        raise MigrationUnavailable(
            f"migration {mig_id!r} torn: payload bytes "
            f"{len(k_bytes)}/{len(v_bytes)} != manifest "
            f"{manifest.get('k_len')}/{manifest.get('v_len')}")
    _m_migrations.labels(outcome="fetched").inc()
    _m_fetch_s.observe(time.monotonic() - t0)
    return manifest, k_bytes, v_bytes


def migration_published(kv, mig_id: str) -> bool:
    """Cheap non-blocking durability probe: has this migration's
    manifest landed?  (The manifest is written LAST, so a visible
    manifest means complete payloads.)  The router's failover logic
    branches on this — a published manifest is the durable replay
    point; an unpublished one means replay from the prompt."""
    _, _, m_key = _keys(mig_id)
    try:
        return kv.get(f"{m_key}/meta") is not None
    except (ConnectionError, OSError, TimeoutError):
        return False


def delete_migration(kv, mig_id: str) -> None:
    """Best-effort cleanup once the decode replica owns the request."""
    k_key, v_key, m_key = _keys(mig_id)
    try:
        # Manifest first: a racing fetch then fails fast on the absent
        # manifest instead of reading half-deleted payload chunks.
        for prefix in (m_key, k_key, v_key):
            meta = kv.get(f"{prefix}/meta")
            if meta is None:
                continue
            n = int(meta.decode().partition(":")[0])
            kv.delete(f"{prefix}/meta")
            for i in range(n):
                kv.delete(f"{prefix}/{i}")
    except (ConnectionError, OSError, ValueError):
        pass


class DictKV:
    """In-process KV fake with the client surface the blob helpers use
    (``set``/``get``/``wait``/``delete``) — lets the disagg router,
    smoke script, and tests run the real transport path without a KV
    server."""

    def __init__(self) -> None:
        self._data: dict[str, bytes] = {}
        self._cond = threading.Condition()

    def set(self, key: str, value: bytes) -> None:
        if isinstance(value, str):
            value = value.encode()
        with self._cond:
            self._data[key] = bytes(value)
            self._cond.notify_all()

    def get(self, key: str) -> Optional[bytes]:
        with self._cond:
            return self._data.get(key)

    def wait(self, key: str, timeout_ms: int = 10000) -> bytes:
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cond:
            while key not in self._data:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"DictKV: timeout waiting for {key!r}")
                self._cond.wait(left)
            return self._data[key]

    def delete(self, key: str) -> None:
        with self._cond:
            self._data.pop(key, None)

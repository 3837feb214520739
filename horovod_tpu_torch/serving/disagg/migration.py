"""KV-block export/import for cross-replica request migration.

The migration unit is the pager block, not the request tensor: a
prefill replica exports exactly the blocks its request's table spans
(``blocks_for(context_len)`` of them, per layer), and the decode
replica re-attaches them through the same refcounted
:class:`~horovod_tpu_torch.serving.kv_pager.KVPager` machinery the radix
prefix cache uses — a cached prompt prefix on the importing side
attaches shared (no payload write), only the remainder is scattered
into fresh blocks, and the request joins the running decode batch with
zero re-prefill.  Greedy decode is deterministic, so the resumed
continuation is token-identical to an unmigrated run.

The manifest is a plain JSON-able dict (schema-versioned, geometry +
payload lengths included) so the transport layer can detect torn reads
and geometry mismatches before any pool write happens.  Manifests and
payloads are those of the JAX package (``horovod_tpu.serving.disagg``):
C-contiguous ``[L, nb, BS, KV, Dh]`` dumps, the dtype named as numpy
names it, so a migration crosses between the two packages either way.

The payload legs, each its own function (``chip_smoke.py`` times them
apart): :func:`gather_pages` (a device-side gather of the request's
pages, then one copy to the host), :func:`payload_bytes` (the host copy's
bytes, through an integer view: plain numpy has no bfloat16), and on the
import side :func:`payload_tensor` (the bytes back into a tensor, copied
to the device) and the engine's scatter.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ...obs import REGISTRY as _obs
from ...obs import trace as _trace
from ..kv_pager import OutOfBlocks
from ..scheduler import Request, RequestState

#: manifest wire-format version; importers reject anything else.
MANIFEST_SCHEMA = 1

#: the manifest's ``dtype`` strings (numpy's names, as the JAX package
#: writes them) and the torch dtypes they stand for.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}

_m_exports = _obs.counter(
    "hvd_disagg_exports_total", "KV-block exports by outcome", ("outcome",))
_m_imports = _obs.counter(
    "hvd_disagg_imports_total", "KV-block imports by outcome", ("outcome",))
_m_bytes = _obs.counter(
    "hvd_disagg_kv_bytes_total", "KV payload bytes exported for migration")
_m_blocks_attached = _obs.counter(
    "hvd_disagg_blocks_attached_total",
    "migrated blocks attached on import, by source",
    ("source",))          # source=payload | prefix_cache


def gather_pages(engine, blocks) -> tuple:
    """``blocks`` of ``engine``'s K and V pools, ``[L, nb, BS, KV, Dh]``
    each, gathered on the device (never the whole pool) and copied to
    host memory."""
    idx = torch.as_tensor(list(blocks), dtype=torch.long,
                          device=engine.device)
    return tuple(pool.index_select(1, idx).cpu()
                 for pool in (engine.k_pool, engine.v_pool))


def payload_bytes(t: torch.Tensor) -> bytes:
    """A host tensor's bytes in C order, through an integer view (numpy
    cannot hold bfloat16 without ``ml_dtypes``)."""
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def payload_tensor(raw: bytes, dtype_name: str, shape: tuple,
                   device) -> torch.Tensor:
    """The inverse of :func:`payload_bytes`, copied to ``device``."""
    if dtype_name not in _DTYPES:
        raise ValueError(f"migration payload dtype {dtype_name!r} is not "
                         f"one of {sorted(_DTYPES)}")
    with warnings.catch_warnings():
        # The tensor only reads the immutable bytes before its copy.
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.frombuffer(raw, dtype=_DTYPES[dtype_name])
    return t.reshape(shape).to(device)


def export_request(engine, req: Request):
    """Snapshot ``req``'s KV blocks out of ``engine``'s pool.

    Must run while the pager still holds the request's table (i.e.
    before ``scheduler.finish`` releases the blocks).  Returns
    ``(manifest, k_bytes, v_bytes)`` — the payloads are C-contiguous
    ``[L, nb, BS, KV, Dh]`` dumps, one whole block per page, so the
    importer can attach any prefix of them shared and scatter the rest.
    """
    if not req.generated:
        raise ValueError(f"request {req.req_id} has no prefill emission "
                         "yet; export runs after the first token")
    cache = engine.cache
    ctx = req.context_len
    nb = cache.blocks_for(ctx)
    blocks = engine.pager.table(req.req_id)[:nb]
    try:
        k, v = gather_pages(engine, blocks)
    except Exception:
        _m_exports.labels(outcome="error").inc()
        raise
    k_bytes, v_bytes = payload_bytes(k), payload_bytes(v)
    manifest = {
        "schema": MANIFEST_SCHEMA,
        # Torn-read sentinel: the transport re-checks this + the payload
        # lengths after fetching, so a half-rewritten manifest can never
        # reach the pool-write path.
        "version": f"{req.req_id}.{len(req.generated)}.{ctx}",
        "prompt": [int(t) for t in req.prompt],
        "prefill_tokens": [int(t) for t in (
            req.prefill_tokens if req.prefill_tokens is not None
            else req.prompt)],
        "generated": list(req.generated),
        "max_new_tokens": int(req.max_new_tokens),
        "eos_token": (None if req.eos_token is None
                      else int(req.eos_token)),
        "context_len": int(ctx),
        "n_blocks": int(nb),
        "block_size": cache.block_size,
        "n_layers": cache.n_layers,
        "kv_heads": cache.kv_heads,
        "head_dim": cache.head_dim,
        "dtype": _DTYPE_NAMES[k.dtype],
        "k_len": len(k_bytes),
        "v_len": len(v_bytes),
        # Trace context rides the manifest so the decode-side import
        # joins the exporting request's trace instead of opening a
        # fresh orphan (sampling decided once at ingress).
        "trace": req.trace.context(),
    }
    _m_exports.labels(outcome="ok").inc()
    _m_bytes.inc(len(k_bytes) + len(v_bytes))
    return manifest, k_bytes, v_bytes


def _check_geometry(engine, manifest: dict) -> None:
    cache = engine.cache
    if manifest.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(
            f"migration manifest schema {manifest.get('schema')!r} != "
            f"supported {MANIFEST_SCHEMA}")
    for field, want in (("block_size", cache.block_size),
                        ("n_layers", cache.n_layers),
                        ("kv_heads", cache.kv_heads),
                        ("head_dim", cache.head_dim)):
        if manifest.get(field) != want:
            raise ValueError(
                f"migration geometry mismatch: manifest {field}="
                f"{manifest.get(field)} but this pool has {want}")
    for field in ("k_len", "v_len", "context_len", "n_blocks"):
        if field not in manifest:
            raise ValueError(f"migration manifest missing {field}")


def import_request(engine, manifest: dict, k_bytes: bytes,
                   v_bytes: bytes, *, stream_cb=None) -> Request:
    """Attach a migrated request to ``engine`` and resume decoding.

    The longest cached prefix of the migrated prompt attaches shared
    from this replica's radix cache (those pages are never written);
    the remaining blocks come off the free list and receive the
    exported payload through the engine's prefill scatter.  The
    returned request is RUNNING in the decode batch.  Raises
    :class:`~horovod_tpu_torch.serving.kv_pager.OutOfBlocks` when this
    engine lacks a slot or blocks right now — callers (the router)
    retry another decode replica.
    """
    _check_geometry(engine, manifest)
    if len(k_bytes) != manifest["k_len"] or \
            len(v_bytes) != manifest["v_len"]:
        _m_imports.labels(outcome="torn").inc()
        raise ValueError(
            f"migration payload torn: got {len(k_bytes)}/{len(v_bytes)} "
            f"bytes, manifest says {manifest['k_len']}/{manifest['v_len']}")
    if not manifest["generated"]:
        raise ValueError("migration manifest has no generated tokens")

    cache = engine.cache
    ctx = int(manifest["context_len"])
    nb = int(manifest["n_blocks"])
    if nb != cache.blocks_for(ctx):
        raise ValueError(f"manifest n_blocks={nb} inconsistent with "
                         f"context_len={ctx}")
    if engine.spec is not None:
        raise NotImplementedError(
            "migrated import into a speculative-decoding engine is not "
            "supported (draft cache has no migrated state)")
    if None not in engine._slots or \
            len(engine.scheduler.running) >= engine.ecfg.max_active:
        _m_imports.labels(outcome="no_slot").inc()
        raise OutOfBlocks("no free decode slot for migrated request")

    prefill = np.asarray(manifest["prefill_tokens"], np.int32)
    # Longest-prefix attach, same machinery as local admission: matched
    # blocks are shared (refcount bump, no write), and the eviction
    # valve protects them while making room for the rest.
    cached, cached_blocks = (
        engine.prefix_cache.match(prefill)
        if engine.prefix_cache is not None else (0, []))
    need = cache.blocks_for(ctx + 1) - len(cached_blocks)
    if need > engine.pager.free_blocks and engine.prefix_cache is not None:
        engine.prefix_cache.evict(need - engine.pager.free_blocks,
                                  protect=cached_blocks)
    req_id = engine._next_id
    engine._next_id += 1
    try:
        engine.pager.allocate(req_id, ctx + 1, prefix_blocks=cached_blocks)
    except OutOfBlocks:
        _m_imports.labels(outcome="no_blocks").inc()
        raise

    table = engine.pager.table(req_id)
    ncb = len(cached_blocks)
    if ncb < nb:
        L, BS = cache.n_layers, cache.block_size
        shape = (L, nb, BS, cache.kv_heads, cache.head_dim)
        tail_nb = nb - ncb
        # [L, tail_nb, BS, KV, Dh] -> [L, 1, tail_nb*BS, KV, Dh]: the
        # prefill scatter's pad-and-reshape is then an exact identity.
        # A payload of another dtype than the pool is cast, as the JAX
        # package's scatter casts.
        ks, vs = (
            payload_tensor(raw, manifest["dtype"], shape, engine.device)
            [:, ncb:].to(engine.k_pool.dtype).reshape(
                L, 1, tail_nb * BS, cache.kv_heads, cache.head_dim)
            for raw in (k_bytes, v_bytes))
        engine._scatter(ks, vs, table[ncb:nb], (engine.k_pool,
                                                engine.v_pool))
    _m_blocks_attached.labels(source="payload").inc(nb - ncb)
    _m_blocks_attached.labels(source="prefix_cache").inc(ncb)

    now = time.monotonic()
    req = Request(
        req_id=req_id,
        prompt=np.asarray(manifest["prompt"], np.int32),
        max_new_tokens=int(manifest["max_new_tokens"]),
        eos_token=manifest["eos_token"],
        stream_cb=stream_cb,
        state=RequestState.RUNNING,
        generated=list(manifest["generated"]),
        prefill_tokens=prefill,
        context_len=ctx,
        cached_tokens=cached,
        t_submit=now, t_admitted=now, t_enqueued=now)
    # Adopt the trace context the exporter stamped into the manifest:
    # same trace_id across the handoff, parented under the prefill-side
    # span, and its sampling decision honored.  Manifests without the
    # field fall back to a fresh local trace.
    req.trace = _trace.TRACER.start_trace(
        "serving.migrated", lane=f"req{req_id}",
        timeline=engine.timeline, parent=manifest.get("trace"),
        req_id=req_id, migrated=True, context_len=ctx, cached_blocks=ncb)
    req.open_phase("decode", migrated=True)
    engine.scheduler.running.append(req)
    engine._assign_slot(req)
    if engine.prefix_cache is not None:
        # The migrated prompt's pages are now first-class local pages;
        # share them so future local admissions (or re-imports of the
        # same request after a decode-replica failover) prefix-attach.
        engine.prefix_cache.insert(prefill, table)
    _m_imports.labels(outcome="ok").inc()
    return req

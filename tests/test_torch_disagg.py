"""Port parity: disaggregated prefill/decode in ``horovod_tpu_torch`` —
KV-block export and import between engines, the migration transport and
the pool-aware ``DisaggRouter``.

Each case of ``tests/test_disagg.py`` runs here as one case, on the JAX
package and on the port with the same inputs: the JAX package's tiny fp32
model (moved across with ``params_from_jax``), prompts drawn with numpy
from the reference's seeds, the reference's engine knobs.  The reference's
own assertions hold on both packages, and their outcomes must be equal:

- tokens and ``finish_reason``, every one equal to the JAX ``generate``
  oracle's continuation;
- manifests, field for field, but ``trace`` (a trace id is random);
- payloads: equal lengths and values within ``PAYLOAD_RTOL`` /
  ``PAYLOAD_ATOL`` (two fp32 forwards of two frameworks; the bytes are
  not bitwise equal), and bitwise equal where both packages write the
  same bytes (the transport's fake migrations);
- the deltas of every ``hvd_disagg_*``, serving and prefix-cache counter,
  label by label.

Then what only the port can show: a migration exported by one package
and imported by the other decodes to the JAX ``generate`` continuation,
both ways, and a bfloat16 migration round-trips bit for bit in a process
where ``ml_dtypes`` cannot be imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu import serving as jserving
from horovod_tpu.models import llama as jllama
from horovod_tpu.obs import REGISTRY as JREG
from horovod_tpu.obs import trace as jtrace
from horovod_tpu.serving import disagg as jdisagg
from horovod_tpu.serving import kv_pager as jkv
from horovod_tpu.serving.disagg import transport as jmig_transport
from horovod_tpu_torch import serving as tserving
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.obs import REGISTRY as TREG
from horovod_tpu_torch.obs import trace as ttrace
from horovod_tpu_torch.serving import disagg as tdisagg
from horovod_tpu_torch.serving import kv_pager as tkv
from horovod_tpu_torch.serving.disagg import transport as tmig_transport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the payloads' K and V from the two packages' fp32 forwards
PAYLOAD_RTOL = 1e-5
PAYLOAD_ATOL = 1e-5

#: the counters whose deltas the two packages must share, label by label
COUNTERS = (
    "hvd_disagg_exports_total", "hvd_disagg_imports_total",
    "hvd_disagg_kv_bytes_total", "hvd_disagg_blocks_attached_total",
    "hvd_disagg_migrations_total", "hvd_disagg_placed_total",
    "hvd_disagg_requests_total", "hvd_disagg_failovers_total",
    "hvd_serving_prefill_tokens_total", "hvd_serving_decode_tokens_total",
    "hvd_serving_prefill_skipped_tokens_total",
    "hvd_serving_requests_total", "hvd_prefix_cache_hits_total",
    "hvd_prefix_cache_misses_total", "hvd_prefix_cache_blocks_shared_total")


@pytest.fixture(scope="module")
def packs():
    jcfg = jllama.LlamaConfig.tiny()            # v256 d64 L2 H4 KV2 fp32
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    common = dict(jcfg=jcfg, jparams=jparams)
    jns = types.SimpleNamespace(
        name="jax", serving=jserving, REG=JREG, trace=jtrace,
        disagg=jdisagg, mig=jmig_transport, kvp=jkv, cfg=jcfg,
        params=jparams, serve_kw={}, **common)
    tns = types.SimpleNamespace(
        name="torch", serving=tserving, REG=TREG, trace=ttrace,
        disagg=tdisagg, mig=tmig_transport, kvp=tkv,
        cfg=tllama.LlamaConfig.tiny(), params=tparams,
        serve_kw=dict(device="cpu"), **common)
    return jns, tns


_oracles: dict = {}


def _oracle(ns, prompt, max_new):
    key = (np.asarray(prompt).tobytes(), max_new)
    if key not in _oracles:
        full = np.asarray(jllama.generate(
            ns.jparams, jnp.asarray(np.asarray(prompt)[None]), ns.jcfg,
            max_new_tokens=max_new))[0]
        _oracles[key] = [int(t) for t in full[len(prompt):]]
    return _oracles[key]


def _sess(ns, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_active", 4)
    kw.setdefault("prefix_cache", True)
    return ns.serving.serve(ns.params, ns.cfg, **ns.serve_kw, **kw)


def _export_one(sess, prompt, max_new, **submit_kw):
    box = {}

    def grab(manifest, k_bytes, v_bytes):
        box["mig"] = (manifest, k_bytes, v_bytes)

    toks: list[int] = []
    fut = sess.submit(prompt, max_new, migrate_cb=grab,
                      stream_cb=lambda rid, t: toks.append(int(t)),
                      **submit_kw)
    sess.drain()
    res = fut.result(timeout=5)
    assert res.metrics["finish_reason"] == "migrated", res.metrics
    assert "mig" in box, "migrate_cb never ran"
    assert toks == list(res.tokens)
    return (*box["mig"], list(res.tokens))


def _counter_value(ns, name, **labels):
    fam = ns.REG.get(name)
    return fam.labels(**labels).value if labels else fam.value


def _counters(reg) -> dict:
    out = {}
    for fam in reg.snapshot():
        if fam["name"] in COUNTERS:
            for s in fam["samples"]:
                key = (fam["name"], tuple(sorted(s["labels"].items())))
                out[key] = s["value"]
    return out


def _manifest_view(manifest: dict) -> dict:
    return {k: v for k, v in manifest.items() if k != "trace"}


def _payload(manifest, k_bytes, v_bytes) -> dict:
    assert manifest["dtype"] == "float32"
    return {"payload": (np.frombuffer(k_bytes, np.float32),
                        np.frombuffer(v_bytes, np.float32))}


def _assert_same(got, want, where="outcome"):
    if isinstance(want, dict) and "payload" in want:
        for a, b in zip(got["payload"], want["payload"]):
            assert a.shape == b.shape, where
            np.testing.assert_allclose(a, b, rtol=PAYLOAD_RTOL,
                                       atol=PAYLOAD_ATOL, err_msg=where)
        got = {k: v for k, v in got.items() if k != "payload"}
        want = {k: v for k, v in want.items() if k != "payload"}
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), (where, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _both(packs, case):
    """Run ``case(ns)`` on the JAX package, then on the port; their
    outcomes and counter deltas must be equal."""
    outs = []
    for ns in packs:
        before = _counters(ns.REG)
        out = case(ns)
        after = _counters(ns.REG)
        moved = {k: v - before.get(k, 0.0) for k, v in after.items()
                 if v - before.get(k, 0.0)}
        outs.append((out, moved))
    (jout, jmoved), (tout, tmoved) = outs
    _assert_same(tout, jout)
    assert tmoved == jmoved
    return tout


# ---------------------------------------------------------------------------
# pager: export/import refcount interleavings (tests/test_disagg.py:81-144)
# ---------------------------------------------------------------------------

def _pager(ns, num_blocks=16, block_size=4):
    return ns.kvp.KVPager(ns.kvp.PagedKVCache(
        n_layers=2, num_blocks=num_blocks, block_size=block_size,
        kv_heads=2, head_dim=8))


def _import_attach_bumps_refcounts(ns):
    p = _pager(ns)
    t1 = p.allocate(1, 16)
    t2 = p.allocate(2, 17, prefix_blocks=t1[:2])
    assert t2[:2] == t1[:2]
    assert p.refcount(t1[0]) == 2 and p.refcount(t1[1]) == 2
    assert p.refcount(t1[2]) == 1
    p.check_invariants()
    free_before = p.free_blocks
    p.release(1)
    assert p.free_blocks == free_before + 2
    assert p.refcount(t2[0]) == 1, "shared pages must survive the export"
    p.check_invariants()
    p.release(2)
    p.check_invariants()
    return [t1, t2, free_before, p.free_blocks]


def _truncate_keeps_shared_across_export(ns):
    p = _pager(ns)
    t1 = p.allocate(1, 12)
    t2 = p.allocate(2, 20, prefix_blocks=t1)
    assert all(p.refcount(b) == 2 for b in t1)
    kept = p.truncate(2, 8)
    assert kept == t1[:2]
    assert p.refcount(t1[2]) == 1
    assert p.table(1) == t1
    p.check_invariants()
    p.release(1)
    assert p.refcount(t1[0]) == 1
    p.check_invariants()
    return [t1, t2, kept, p.free_blocks]


def _double_attach_is_refcounted_not_copied(ns):
    p = _pager(ns)
    t1 = p.allocate(1, 16)
    free_after_first = None
    tables = []
    for rid in (2, 3):
        tables.append(p.allocate(rid, 17, prefix_blocks=t1[:3]))
        if free_after_first is None:
            free_after_first = p.free_blocks
    assert all(p.refcount(b) == 3 for b in t1[:3])
    assert free_after_first - p.free_blocks == 2
    p.check_invariants()
    for rid in (1, 2, 3):
        p.release(rid)
    assert p.free_blocks == p.cache.num_blocks - 1
    p.check_invariants()
    return [t1, tables, free_after_first]


@pytest.mark.parametrize("case", [
    _import_attach_bumps_refcounts, _truncate_keeps_shared_across_export,
    _double_attach_is_refcounted_not_copied],
    ids=["import_attach_bumps_refcounts",
         "truncate_keeps_shared_across_export",
         "double_attach_is_refcounted_not_copied"])
def test_pager_cases_match_jax(packs, case):
    _both(packs, case)


# ---------------------------------------------------------------------------
# transport: publish/fetch, shared deadline, torn reads (:151-250)
# ---------------------------------------------------------------------------

def _fake_migration(n=512):
    manifest = {"schema": 1, "version": "7.1.8", "k_len": n, "v_len": n,
                "generated": [3], "context_len": 8, "n_blocks": 2}
    return manifest, bytes(range(256)) * (n // 256), b"\x01" * n


def _roundtrip_and_cleanup(ns):
    kv = ns.disagg.DictKV()
    manifest, k, v = _fake_migration()
    assert not ns.disagg.migration_published(kv, "7.1")
    ns.disagg.publish_migration(kv, "7.1", manifest, k, v)
    assert ns.disagg.migration_published(kv, "7.1")
    m2, k2, v2 = ns.disagg.fetch_migration(kv, "7.1", timeout_ms=2000)
    assert (m2, k2, v2) == (manifest, k, v)
    stored = dict(kv._data)                      # every key, bitwise
    ns.disagg.delete_migration(kv, "7.1")
    assert not ns.disagg.migration_published(kv, "7.1")
    with pytest.raises(ns.disagg.MigrationUnavailable):
        ns.disagg.fetch_migration(kv, "7.1", timeout_ms=100)
    return {"stored": stored, "after_delete": dict(kv._data)}


def _publish_shares_one_deadline(ns):
    seen = []
    real = ns.mig.kv_put_blob

    def spy(kv, key, blob, **kw):
        seen.append((key, kw["deadline_s"]))
        return real(kv, key, blob, **kw)

    manifest, k, v = _fake_migration()
    ns.mig.kv_put_blob = spy
    try:
        ns.disagg.publish_migration(ns.disagg.DictKV(), "9.1", manifest,
                                    k, v, deadline_s=5.0)
    finally:
        ns.mig.kv_put_blob = real
    budgets = [d for _, d in seen]
    assert len(seen) == 3
    assert all(d <= 5.0 for d in budgets), budgets
    assert budgets == sorted(budgets, reverse=True), budgets
    return [key for key, _ in seen]


def _fetch_shares_one_deadline(ns):
    seen = []
    real = ns.mig.kv_get_blob

    def spy(kv, key, timeout_ms=10000):
        seen.append((key, timeout_ms))
        return real(kv, key, timeout_ms=timeout_ms)

    kv = ns.disagg.DictKV()
    manifest, k, v = _fake_migration()
    ns.disagg.publish_migration(kv, "9.2", manifest, k, v)
    ns.mig.kv_get_blob = spy
    try:
        ns.disagg.fetch_migration(kv, "9.2", timeout_ms=4000)
    finally:
        ns.mig.kv_get_blob = real
    budgets = [t for _, t in seen]
    assert len(seen) == 4
    assert all(t <= 4000 for t in budgets), budgets
    assert budgets == sorted(budgets, reverse=True), budgets
    return [key for key, _ in seen]


def _torn_payload_length_detected(ns):
    kv = ns.disagg.DictKV()
    manifest, k, v = _fake_migration()
    ns.disagg.publish_migration(kv, "9.3", manifest, k, v)
    kv.set("fd/mig/9.3/k/0", k[: len(k) // 2])
    kv.set("fd/mig/9.3/k/meta", f"1:{len(k) // 2}".encode())
    with pytest.raises(ns.disagg.MigrationUnavailable, match="torn") as e:
        ns.disagg.fetch_migration(kv, "9.3", timeout_ms=2000)
    return str(e.value)


def _version_flip_mid_fetch_detected(ns):
    class FlippingKV(ns.disagg.DictKV):
        def __init__(self):
            super().__init__()
            self.manifest_reads = 0
            self.armed = False

        def wait(self, key, timeout_ms=10000):
            if self.armed and key == "fd/mig/9.4/manifest/0":
                self.manifest_reads += 1
                if self.manifest_reads >= 2:
                    m = dict(_fake_migration()[0], version="7.2.9")
                    blob = json.dumps(m, sort_keys=True).encode()
                    self.set("fd/mig/9.4/manifest/meta",
                             f"1:{len(blob)}".encode())
                    self.set(key, blob)
            return super().wait(key, timeout_ms)

    kv = FlippingKV()
    manifest, k, v = _fake_migration()
    ns.disagg.publish_migration(kv, "9.4", manifest, k, v)
    kv.armed = True
    with pytest.raises(ns.disagg.MigrationUnavailable,
                       match="version flipped") as e:
        ns.disagg.fetch_migration(kv, "9.4", timeout_ms=2000)
    return str(e.value)


@pytest.mark.parametrize("case", [
    _roundtrip_and_cleanup, _publish_shares_one_deadline,
    _fetch_shares_one_deadline, _torn_payload_length_detected,
    _version_flip_mid_fetch_detected],
    ids=["roundtrip_and_cleanup", "publish_shares_one_deadline",
         "fetch_shares_one_deadline", "torn_payload_length_detected",
         "version_flip_mid_fetch_detected"])
def test_transport_cases_match_jax(packs, case):
    _both(packs, case)


# ---------------------------------------------------------------------------
# engine: export -> import parity (:257-448)
# ---------------------------------------------------------------------------

def _result_view(res) -> dict:
    return {"tokens": [int(t) for t in res.tokens],
            "finish_reason": res.metrics["finish_reason"]}


def _migrated_decode_matches_generate(ns):
    rng = np.random.RandomState(21)
    prompt = rng.randint(0, ns.cfg.vocab_size, size=(9,)).astype(np.int32)
    sess_a, sess_b = _sess(ns), _sess(ns)
    manifest, k_bytes, v_bytes, head = _export_one(sess_a, prompt, 12)
    assert len(head) == 1
    streamed: list[int] = []
    fut = sess_b.import_migrated(
        manifest, k_bytes, v_bytes,
        stream_cb=lambda rid, t: streamed.append(int(t)))
    sess_b.drain()
    res = fut.result(timeout=5)
    want = _oracle(ns, prompt, 12)
    assert list(res.tokens) == want, (res.tokens, want)
    assert res.metrics["finish_reason"] == "length"
    assert head + streamed == want, (head, streamed)
    return {"manifest": _manifest_view(manifest),
            **_payload(manifest, k_bytes, v_bytes),
            "head": head, "streamed": streamed, "result": _result_view(res)}


def _migrated_decode_honors_eos(ns):
    rng = np.random.RandomState(22)
    prompt = rng.randint(0, ns.cfg.vocab_size, size=(7,)).astype(np.int32)
    want = _oracle(ns, prompt, 10)
    eos = want[4]
    sess_a, sess_b = _sess(ns), _sess(ns)
    manifest, k_bytes, v_bytes, _ = _export_one(sess_a, prompt, 10,
                                                eos_token=eos)
    fut = sess_b.import_migrated(manifest, k_bytes, v_bytes)
    sess_b.drain()
    res = fut.result(timeout=5)
    assert res.metrics["finish_reason"] == "stop"
    assert list(res.tokens) == want[:5], (res.tokens, want)
    return {"manifest": _manifest_view(manifest),
            **_payload(manifest, k_bytes, v_bytes),
            "result": _result_view(res)}


def _migrated_parity_with_radix_partial_prefix(ns):
    rng = np.random.RandomState(23)
    stem = rng.randint(0, ns.cfg.vocab_size, size=(8,)).astype(np.int32)
    prompt = np.concatenate(
        [stem, rng.randint(0, ns.cfg.vocab_size, size=(5,))]
    ).astype(np.int32)
    sess_a, sess_b = _sess(ns), _sess(ns)
    for warm_sess in (sess_a, sess_b):
        warm_sess.submit(stem, 2)
        warm_sess.drain()
    manifest, k_bytes, v_bytes, head = _export_one(sess_a, prompt, 11)
    before = _counter_value(ns, "hvd_disagg_blocks_attached_total",
                            source="prefix_cache")
    fut = sess_b.import_migrated(manifest, k_bytes, v_bytes)
    attached = _counter_value(ns, "hvd_disagg_blocks_attached_total",
                              source="prefix_cache") - before
    assert attached >= 1
    sess_b.drain()
    res = fut.result(timeout=5)
    assert list(res.tokens) == _oracle(ns, prompt, 11)
    sess_b.engine.pager.check_invariants()
    return {"manifest": _manifest_view(manifest),
            **_payload(manifest, k_bytes, v_bytes),
            "attached": attached, "result": _result_view(res),
            "cached_tokens": res.metrics["cached_tokens"]}


def _double_import_is_idempotent(ns):
    rng = np.random.RandomState(24)
    prompt = rng.randint(0, ns.cfg.vocab_size, size=(10,)).astype(np.int32)
    sess_a, sess_b = _sess(ns), _sess(ns)
    manifest, k_bytes, v_bytes, _ = _export_one(sess_a, prompt, 9)
    before = _counter_value(ns, "hvd_disagg_blocks_attached_total",
                            source="prefix_cache")
    fut1 = sess_b.import_migrated(manifest, k_bytes, v_bytes)
    fut2 = sess_b.import_migrated(manifest, k_bytes, v_bytes)
    attached = _counter_value(ns, "hvd_disagg_blocks_attached_total",
                              source="prefix_cache") - before
    assert attached >= 1
    sess_b.drain()
    want = _oracle(ns, prompt, 9)
    r1, r2 = fut1.result(timeout=5), fut2.result(timeout=5)
    assert list(r1.tokens) == want
    assert list(r2.tokens) == want
    sess_b.engine.pager.check_invariants()
    return {"manifest": _manifest_view(manifest), "attached": attached,
            "results": [_result_view(r1), _result_view(r2)]}


def _import_rejects_geometry_and_torn_payloads(ns):
    rng = np.random.RandomState(25)
    prompt = rng.randint(0, ns.cfg.vocab_size, size=(6,)).astype(np.int32)
    sess_a = _sess(ns)
    manifest, k_bytes, v_bytes, _ = _export_one(sess_a, prompt, 6)
    errors = []
    other = _sess(ns, block_size=8)
    with pytest.raises(ValueError, match="geometry") as e:
        other.engine.import_migrated(manifest, k_bytes, v_bytes)
    errors.append(str(e.value))
    sess_b = _sess(ns)
    with pytest.raises(ValueError, match="torn") as e:
        sess_b.engine.import_migrated(manifest, k_bytes[:-8], v_bytes)
    errors.append(str(e.value))
    bad = dict(manifest, schema=99)
    with pytest.raises(ValueError, match="schema") as e:
        sess_b.engine.import_migrated(bad, k_bytes, v_bytes)
    errors.append(str(e.value))
    fut = sess_b.import_migrated(manifest, k_bytes, v_bytes)
    sess_b.drain()
    res = fut.result(timeout=5)
    assert list(res.tokens) == _oracle(ns, prompt, 6)
    sess_b.engine.pager.check_invariants()
    return {"errors": errors, "result": _result_view(res)}


def _manifest_carries_one_connected_trace(ns):
    rng = np.random.RandomState(27)
    prompt = rng.randint(0, ns.cfg.vocab_size, size=(8,)).astype(np.int32)
    sess_a, sess_b = _sess(ns), _sess(ns)
    manifest, k_bytes, v_bytes, _ = _export_one(sess_a, prompt, 8)
    assert manifest.get("trace", {}).get("sampled") is True, manifest
    tid = manifest["trace"]["trace_id"]
    fut = sess_b.import_migrated(manifest, k_bytes, v_bytes)
    sess_b.drain()
    res = fut.result(timeout=5)
    exp = ns.trace.TRACER.export(tid)
    assert exp is not None
    root = next(s for s in exp["spans"] if s["name"] == "serving.migrated")
    assert root["parent_id"] == manifest["trace"]["span_id"]
    return {"result": _result_view(res),
            "span_names": sorted(s["name"] for s in exp["spans"])}


def _import_out_of_slots_raises_out_of_blocks(ns):
    rng = np.random.RandomState(26)
    prompt = rng.randint(0, ns.cfg.vocab_size, size=(6,)).astype(np.int32)
    sess_a = _sess(ns)
    manifest, k_bytes, v_bytes, _ = _export_one(sess_a, prompt, 8)
    sess_b = _sess(ns, max_active=1)
    local = sess_b.submit(prompt, 32)
    while not sess_b.engine.scheduler.running:
        sess_b._step_once()
    with pytest.raises(ns.kvp.OutOfBlocks) as e:
        sess_b.engine.import_migrated(manifest, k_bytes, v_bytes)
    sess_b.drain()
    return {"error": str(e.value),
            "local": _result_view(local.result(timeout=5))}


def _failed_publish_fails_only_its_request(ns):
    """Not a case of the reference's file: a migrate callback that raises
    after the export (the KV store down) fails that request's future and
    releases its blocks, and the batch beside it keeps serving."""
    rng = np.random.RandomState(28)
    prompts = [rng.randint(0, ns.cfg.vocab_size, size=(n,))
               .astype(np.int32) for n in (7, 9)]
    sess = _sess(ns)

    def down(manifest, k_bytes, v_bytes):
        raise ConnectionError("KV store down")

    failing = sess.submit(prompts[0], 6, migrate_cb=down)
    fine = sess.submit(prompts[1], 6)
    sess.drain()
    with pytest.raises(ConnectionError, match="KV store down"):
        failing.result(timeout=5)
    res = fine.result(timeout=5)
    assert list(res.tokens) == _oracle(ns, prompts[1], 6)
    sess.engine.pager.check_invariants()
    assert not sess.engine.scheduler.running
    return {"result": _result_view(res),
            "free_blocks": sess.engine.pager.free_blocks}


_ENGINE_CASES = [
    _migrated_decode_matches_generate, _migrated_decode_honors_eos,
    _migrated_parity_with_radix_partial_prefix,
    _double_import_is_idempotent,
    _import_rejects_geometry_and_torn_payloads,
    _manifest_carries_one_connected_trace,
    _import_out_of_slots_raises_out_of_blocks,
    _failed_publish_fails_only_its_request]


@pytest.mark.parametrize("case", _ENGINE_CASES,
                         ids=[c.__name__[1:] for c in _ENGINE_CASES])
def test_engine_cases_match_jax(packs, case):
    _both(packs, case)


# ---------------------------------------------------------------------------
# router: pool placement + failover at every migration stage (:455-607)
# ---------------------------------------------------------------------------

def _fleet(ns, pools, **cfg_kw):
    kv = ns.disagg.DictKV()
    reps = [ns.disagg.LocalDisaggReplica(f"r{i}", _sess(ns), kv, pool=p)
            for i, p in enumerate(pools)]
    cfg_kw.setdefault("failover_grace_s", 0.05)
    cfg_kw.setdefault("max_attempts", 6)
    router = ns.disagg.DisaggRouter(reps, kv,
                                    ns.disagg.DisaggRouterConfig(**cfg_kw))
    return router, reps, kv


def _router_view(res) -> dict:
    m = res.metrics
    return {**_result_view(res), "migrated": m["migrated"],
            "mig_id": m["mig_id"], "disagg_attempts": m["disagg_attempts"]}


def _router_migrates_and_matches_generate(ns):
    rng = np.random.RandomState(31)
    prompts = [rng.randint(0, ns.cfg.vocab_size, size=(6 + 3 * i,))
               .astype(np.int32) for i in range(3)]
    router, reps, _ = _fleet(ns, ["prefill", "decode"])
    streamed: dict[int, list] = {}
    futs = [router.submit(p, 10, stream_cb=lambda fid, t:
                          streamed.setdefault(fid, []).append(int(t)))
            for p in prompts]
    router.drain(timeout_s=120)
    out = []
    for i, (p, f) in enumerate(zip(prompts, futs)):
        res = f.result(timeout=5)
        want = _oracle(ns, p, 10)
        assert list(res.tokens) == want, (i, res.tokens, want)
        assert res.metrics["migrated"] is True
        assert streamed[i] == want
        out.append(_router_view(res))
    for rep in reps:
        rep.session.engine.pager.check_invariants()
    return out


def _router_prefill_death_before_publish(ns):
    rng = np.random.RandomState(32)
    prompt = rng.randint(0, ns.cfg.vocab_size, size=(8,)).astype(np.int32)
    router, reps, kv = _fleet(ns, ["prefill", "prefill", "decode"])
    fut = router.submit(prompt, 8)
    fl = next(iter(router._flights.values()))
    assert fl.state == "prefilling"
    fl.replica.kill()
    assert not ns.disagg.migration_published(kv, fl.mig_id)
    router.drain(timeout_s=120)
    res = fut.result(timeout=5)
    assert list(res.tokens) == _oracle(ns, prompt, 8)
    assert res.metrics["migrated"] is True
    assert router.failovers >= 1
    assert res.metrics["mig_id"].endswith(".2")
    return {"result": _router_view(res), "failovers": router.failovers}


def _router_prefill_death_after_publish(ns):
    rng = np.random.RandomState(33)
    prompt = rng.randint(0, ns.cfg.vocab_size, size=(9,)).astype(np.int32)
    router, reps, kv = _fleet(ns, ["prefill", "prefill", "decode"])
    fut = router.submit(prompt, 8)
    fl = next(iter(router._flights.values()))
    victim = fl.replica
    steps = 0
    while not ns.disagg.migration_published(kv, fl.mig_id):
        victim.session._step_once()
        steps += 1
        assert steps < 120, "export never published"
    victim.kill()
    router.drain(timeout_s=120)
    res = fut.result(timeout=5)
    assert list(res.tokens) == _oracle(ns, prompt, 8)
    assert res.metrics["migrated"] is True
    assert router.failovers >= 1
    assert res.metrics["mig_id"] == fl.mig_id
    assert res.metrics["mig_id"].endswith(".1")
    return {"result": _router_view(res), "failovers": router.failovers,
            "victim_steps": steps}


def _router_decode_death_reimports(ns):
    rng = np.random.RandomState(34)
    prompt = rng.randint(0, ns.cfg.vocab_size, size=(7,)).astype(np.int32)
    router, reps, kv = _fleet(ns, ["prefill", "decode", "decode"],
                              cleanup=False)
    streamed: list[int] = []
    fut = router.submit(
        prompt, 12, stream_cb=lambda fid, t: streamed.append(int(t)))
    fl = next(iter(router._flights.values()))
    for _ in range(10_000):
        router.pump()
        if fl.state == "decoding" and fl.delivered >= 3:
            break
    else:
        raise AssertionError(f"never reached mid-decode ({fl.state})")
    fl.replica.kill()
    router.drain(timeout_s=120)
    res = fut.result(timeout=5)
    want = _oracle(ns, prompt, 12)
    assert list(res.tokens) == want
    assert router.failovers >= 1
    assert streamed == want
    return {"result": _router_view(res), "failovers": router.failovers,
            "streamed": streamed}


def _router_decode_placement_prefers_warm_prefix_cache(ns):
    rng = np.random.RandomState(36)
    prompt = rng.randint(0, ns.cfg.vocab_size, size=(9,)).astype(np.int32)
    router, reps, _ = _fleet(ns, ["prefill", "decode", "decode"])
    reps[2].session.submit(prompt, 2)
    reps[2].session.drain()
    hits = _counter_value(ns, "hvd_prefix_cache_hits_total")
    misses = _counter_value(ns, "hvd_prefix_cache_misses_total")
    cached = [reps[2].cached_prefix(prompt), reps[1].cached_prefix(prompt)]
    assert cached[0] >= 4 and cached[1] == 0
    assert _counter_value(ns, "hvd_prefix_cache_hits_total") == hits
    assert _counter_value(ns, "hvd_prefix_cache_misses_total") == misses
    before = _counter_value(ns, "hvd_disagg_placed_total",
                            pool="decode", replica="r2")
    fut = router.submit(prompt, 8)
    router.drain(timeout_s=120)
    res = fut.result(timeout=5)
    assert list(res.tokens) == _oracle(ns, prompt, 8)
    assert _counter_value(ns, "hvd_disagg_placed_total", pool="decode",
                          replica="r2") == before + 1
    return {"result": _router_view(res), "cached": cached}


def _router_mixed_pool_serves_both_stages(ns):
    rng = np.random.RandomState(35)
    prompt = rng.randint(0, ns.cfg.vocab_size, size=(6,)).astype(np.int32)
    router, reps, _ = _fleet(ns, ["mixed"])
    fut = router.submit(prompt, 6)
    router.drain(timeout_s=120)
    res = fut.result(timeout=5)
    assert list(res.tokens) == _oracle(ns, prompt, 6)
    assert res.metrics["migrated"] is True
    return _router_view(res)


def _router_requires_both_pools(ns):
    kv = ns.disagg.DictKV()
    rep = ns.disagg.LocalDisaggReplica("r0", _sess(ns), kv, pool="prefill")
    with pytest.raises(ValueError, match="decode-capable") as e:
        ns.disagg.DisaggRouter([rep], kv)
    return str(e.value)


_ROUTER_CASES = [
    _router_migrates_and_matches_generate,
    _router_prefill_death_before_publish,
    _router_prefill_death_after_publish, _router_decode_death_reimports,
    _router_decode_placement_prefers_warm_prefix_cache,
    _router_mixed_pool_serves_both_stages, _router_requires_both_pools]


@pytest.mark.parametrize("case", _ROUTER_CASES,
                         ids=[c.__name__[1:] for c in _ROUTER_CASES])
def test_router_cases_match_jax(packs, case):
    _both(packs, case)


# ---------------------------------------------------------------------------
# across the two packages, and bfloat16 without ml_dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [(0, 1), (1, 0)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_a_migration_crosses_between_the_packages(packs, src, dst):
    """A request prefilled and exported by one package's engine, imported
    and decoded by the other's, emits the JAX ``generate`` continuation;
    the importer's pool holds the exporter's bytes for the request."""
    exporter, importer = packs[src], packs[dst]
    rng = np.random.RandomState(41)
    prompt = rng.randint(0, 256, size=(11,)).astype(np.int32)
    manifest, k_bytes, v_bytes, head = _export_one(_sess(exporter), prompt,
                                                   10)
    # The manifest crosses as JSON, as the KV store carries it.
    manifest = json.loads(json.dumps(manifest, sort_keys=True))
    sess = _sess(importer, prefix_cache=False)
    streamed: list[int] = []
    fut = sess.import_migrated(manifest, k_bytes, v_bytes,
                               stream_cb=lambda rid, t: streamed.append(t))
    eng = sess.engine
    req = eng.scheduler.running[0]
    nb = manifest["n_blocks"]
    blocks = eng.pager.table(req.req_id)[:nb]
    pages = b"".join(np.ascontiguousarray(np.asarray(pool)[:, blocks])
                     .tobytes() for pool in (eng.k_pool, eng.v_pool))
    assert pages == k_bytes + v_bytes
    sess.drain()
    res = fut.result(timeout=5)
    want = _oracle(importer, prompt, 10)
    assert head == want[:1]
    assert [int(t) for t in res.tokens] == want
    assert head + [int(t) for t in streamed] == want
    assert res.metrics["finish_reason"] == "length"


_BF16_ROUNDTRIP = r"""
import json, sys
sys.modules["ml_dtypes"] = None
import dataclasses
import numpy as np
import torch
from horovod_tpu_torch import serving
from horovod_tpu_torch.models import llama

cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.bfloat16)
params = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
prompt = np.random.RandomState(5).randint(0, 256, size=(13,))
kw = dict(device="cpu", num_blocks=32, block_size=4, max_active=2)
box = {}
a = serving.serve(params, cfg, **kw)
head = a.submit(prompt, 8, migrate_cb=lambda *m: box.update(m=m))
a.drain()
manifest, k_bytes, v_bytes = box["m"]
b = serving.serve(params, cfg, **kw)
fut = b.import_migrated(manifest, k_bytes, v_bytes)
eng = b.engine
blocks = eng.pager.table(eng.scheduler.running[0].req_id)[
    :manifest["n_blocks"]]
idx = torch.tensor(blocks)
pages = [p.index_select(1, idx).contiguous().view(torch.uint8)
         .numpy().tobytes() for p in (eng.k_pool, eng.v_pool)]
b.drain()
c = serving.serve(params, cfg, **kw)
plain = c.submit(prompt, 8)
c.drain()
print(json.dumps({
    "ml_dtypes": "ml_dtypes" in sys.modules and
                 sys.modules["ml_dtypes"] is not None,
    "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules),
    "dtype": manifest["dtype"], "bitwise": pages == [k_bytes, v_bytes],
    "k_len": len(k_bytes), "head": head.result().tokens,
    "tokens": fut.result().tokens, "plain": plain.result().tokens}))
"""


def test_a_bfloat16_migration_roundtrips_without_ml_dtypes():
    """Plain numpy has no bfloat16: the port's payloads go through an
    integer view, so a bf16 export imports bit for bit in a process where
    ``ml_dtypes`` cannot be imported, and decodes to the tokens of the
    same request served without a migration."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _BF16_ROUNDTRIP], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["ml_dtypes"] is False and out["jax"] is False, out
    assert out["dtype"] == "bfloat16"
    assert out["bitwise"] is True
    # 2 layers x 4 blocks x 4 slots x 2 kv heads x 16 dims x 2 bytes
    assert out["k_len"] == 2 * 4 * 4 * 2 * 16 * 2
    assert out["head"] == out["tokens"][:1] and len(out["tokens"]) == 8
    assert out["tokens"] == out["plain"]

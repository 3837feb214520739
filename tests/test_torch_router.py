"""Port parity: the front door's multi-replica router and its placement
signals in ``horovod_tpu_torch`` (``serving.frontdoor.router`` and
``serving.frontdoor.transport``).

Each router and signal case of ``tests/test_frontdoor.py`` (:303-489)
runs here as one case, on the JAX package and on the port with the same
inputs: the JAX package's tiny fp32 model moved across with
``params_from_jax``, prompts drawn with numpy from the reference's seeds,
the reference's replica knobs (the gather path, pages of 8).  The
reference's own assertions hold on both packages, and their outcomes must
be equal: every token (each also the JAX ``generate`` oracle's),
``finish_reason``, the replica each request finished on and its attempts,
what was streamed, the router's failovers, the deltas of every
``hvd_router_*`` counter label by label, and ``signals_from_snapshot`` on
the same snapshot dict.

Then the transport's rejoin hook: a ``ReplicaServer``'s membership record
comes back after the elastic re-initialization.
"""

from __future__ import annotations

import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu import serving as jserving
from horovod_tpu.models import llama as jllama
from horovod_tpu.obs import REGISTRY as JREG
from horovod_tpu.obs import aggregate as jagg
from horovod_tpu.serving import frontdoor as jfd
from horovod_tpu.serving.frontdoor import transport as jtransport
from horovod_tpu_torch import serving as tserving
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.obs import REGISTRY as TREG
from horovod_tpu_torch.obs import aggregate as tagg
from horovod_tpu_torch.serving import frontdoor as tfd
from horovod_tpu_torch.serving.frontdoor import transport as ttransport

COUNTERS = ("hvd_router_placed_total", "hvd_router_failovers_total",
            "hvd_router_affinity_hits_total", "hvd_router_requests_total")


@pytest.fixture(scope="module")
def packs():
    jcfg = jllama.LlamaConfig.tiny()            # v256 d64 L2 H4 KV2 fp32
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    common = dict(jcfg=jcfg, jparams=jparams)
    jns = types.SimpleNamespace(
        name="jax", serving=jserving, REG=JREG, agg=jagg, fd=jfd,
        tr=jtransport,
        cfg=jcfg, params=jparams, serve_kw={}, **common)
    tns = types.SimpleNamespace(
        name="torch", serving=tserving, REG=TREG, agg=tagg, fd=tfd,
        tr=ttransport,
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


def _prompts(rng, lens):
    return [rng.randint(0, 256, size=(n,)).astype(np.int32) for n in lens]


def _local_replicas(ns, n=2, **kw):
    sessions = [ns.serving.serve(ns.params, ns.cfg, num_blocks=64,
                                 block_size=8, max_active=4,
                                 use_flash="never", **ns.serve_kw, **kw)
                for _ in range(n)]
    return [ns.fd.LocalReplica(str(i), s) for i, s in enumerate(sessions)]


def _counters(reg) -> dict:
    out = {}
    for fam in reg.snapshot():
        if fam["name"] in COUNTERS:
            for s in fam["samples"]:
                out[(fam["name"], tuple(sorted(s["labels"].items())))] = \
                    s["value"]
    return out


def _both(packs, case):
    """Run ``case(ns)`` on the JAX package, then on the port; their
    outcomes and router counter deltas must be equal."""
    outs = []
    for ns in packs:
        before = _counters(ns.REG)
        out = case(ns)
        after = _counters(ns.REG)
        outs.append((out, {k: v - before.get(k, 0.0)
                           for k, v in after.items()
                           if v - before.get(k, 0.0)}))
    (jout, jmoved), (tout, tmoved) = outs
    assert tout == jout
    assert tmoved == jmoved
    return tout


def _view(res) -> dict:
    m = res.metrics
    return {"tokens": [int(t) for t in res.tokens],
            "finish_reason": m.get("finish_reason"),
            "replica": m["replica"], "attempts": m["router_attempts"]}


# ---------------------------------------------------------------------------
# the router over in-process replicas
# ---------------------------------------------------------------------------

def _balances_and_parity(ns):
    reps = _local_replicas(ns)
    router = ns.fd.Router(reps, ns.fd.RouterConfig(affinity_tokens=0))
    prompts = _prompts(np.random.RandomState(8), [5, 6, 7, 8, 9, 10])
    futs = [router.submit(p, 8) for p in prompts]
    router.drain(timeout_s=120)
    placed = {r.replica_id: 0 for r in reps}
    out = []
    for p, f in zip(prompts, futs):
        res = f.result(timeout=1)
        assert res.tokens == _oracle(ns, p, 8)
        assert res.metrics["finish_reason"] == "length"
        placed[res.metrics["replica"]] += 1
        out.append(_view(res))
    assert placed["0"] == 3 and placed["1"] == 3, placed
    for r in reps:
        r.session.close()
    return out


def _affinity_stickiness(ns):
    reps = _local_replicas(ns)
    router = ns.fd.Router(reps, ns.fd.RouterConfig(affinity_tokens=4))
    rng = np.random.RandomState(9)
    head = rng.randint(0, 256, size=(6,)).astype(np.int32)
    same = [np.concatenate([head, t]) for t in _prompts(rng, [3, 4, 5])]
    futs = [router.submit(p, 4) for p in same]
    router.drain(timeout_s=120)
    replicas = {f.result(timeout=1).metrics["replica"] for f in futs}
    assert len(replicas) == 1
    out = []
    for p, f in zip(same, futs):
        res = f.result(timeout=1)
        assert res.tokens == _oracle(ns, p, 4)
        out.append(_view(res))
    for r in reps:
        r.session.close()
    return out


def _failover_completes_on_survivor(ns):
    reps = _local_replicas(ns)
    router = ns.fd.Router(reps, ns.fd.RouterConfig(affinity_tokens=0))
    prompts = _prompts(np.random.RandomState(10), [5, 6, 7, 8])
    streamed: dict[int, list[int]] = {}

    def cb_for(i):
        return lambda rid, t: streamed.setdefault(i, []).append(int(t))

    futs = [router.submit(p, 10, stream_cb=cb_for(i))
            for i, p in enumerate(prompts)]
    for _ in range(6):
        router.pump()
    reps[1].kill()
    router.drain(timeout_s=120)
    assert router.failovers >= 1
    out = []
    for i, (p, f) in enumerate(zip(prompts, futs)):
        res = f.result(timeout=1)
        assert res.tokens == _oracle(ns, p, 10)
        assert res.metrics["finish_reason"] == "length"
        assert streamed[i][-len(res.tokens):] == res.tokens
        out.append(_view(res))
    moved = [m for m in out if m["attempts"] > 1]
    assert moved and all(m["replica"] == "0" for m in moved)
    reps[0].session.close()
    return {"results": out, "streamed": streamed,
            "failovers": router.failovers}


def _all_dead_queues_then_times_out(ns):
    reps = _local_replicas(ns, n=1)
    router = ns.fd.Router(reps, ns.fd.RouterConfig(max_attempts=2,
                                                   failover_grace_s=0.0))
    fut = router.submit(np.arange(5, dtype=np.int32), 4)
    reps[0].kill()
    with pytest.raises(TimeoutError) as e:
        router.drain(timeout_s=0.5)
    assert not fut.done()
    assert router.failovers >= 1
    reps[0].session.close()
    return {"error": str(e.value), "failovers": router.failovers,
            "pending": len(router._pending)}


@pytest.mark.parametrize("case", [
    _balances_and_parity, _affinity_stickiness,
    _failover_completes_on_survivor, _all_dead_queues_then_times_out],
    ids=["balances_and_parity", "affinity_stickiness",
         "failover_completes_on_survivor", "all_dead_queues_then_times_out"])
def test_router_cases_match_jax(packs, case):
    _both(packs, case)


# ---------------------------------------------------------------------------
# placement signals: the staleness guard (:425-489)
# ---------------------------------------------------------------------------

def _frozen_snapshot(rank, age_s, interval_s=0.5, ready=True):
    return {
        "rank": rank, "time": time.time() - age_s,
        "meta": {"interval_s": interval_s},
        "snapshot": [
            {"name": "hvd_replica_ready", "type": "gauge",
             "samples": [{"labels": {}, "value": 1.0 if ready else 0.0}]},
            {"name": "hvd_serving_queue_depth", "type": "gauge",
             "samples": [{"labels": {}, "value": 1.0}]},
        ],
    }


def _hist(counts):
    return {"labels": {}, "count": counts[-1],
            "buckets": [[0.01, counts[0]], [0.1, counts[1]],
                        ["+Inf", counts[2]]]}


def _full_snapshot(rank=3):
    """A replica's snapshot with every family the signals read: pool,
    occupancy, TTFT and ITL histograms (two label sets to merge), burns."""
    return {
        "rank": rank, "time": 1000.0, "meta": {"interval_s": 2.0},
        "snapshot": [
            {"name": "hvd_replica_ready", "type": "gauge",
             "samples": [{"labels": {}, "value": 0.0}]},
            {"name": "hvd_serving_pool_info", "type": "gauge",
             "samples": [{"labels": {"pool": "decode"}, "value": 1.0}]},
            {"name": "hvd_serving_queue_depth", "type": "gauge",
             "samples": [{"labels": {}, "value": 4.0}]},
            {"name": "hvd_serving_batch_occupancy", "type": "gauge",
             "samples": [{"labels": {}, "value": 0.75}]},
            {"name": "hvd_serving_ttft_seconds", "type": "histogram",
             "samples": [_hist([2, 9, 10]), _hist([0, 5, 6])]},
            {"name": "hvd_serving_itl_seconds", "type": "histogram",
             "samples": [_hist([1, 1, 4])]},
            {"name": "hvd_slo_burn_rate", "type": "gauge",
             "samples": [{"labels": {"slo": "a"}, "value": 0.5},
                         {"labels": {"slo": "b"}, "value": 2.5}]},
        ],
    }


def _signals_stale_snapshot_marked(ns):
    agg = ns.agg
    fresh = _frozen_snapshot(0, age_s=0.1)
    stale = _frozen_snapshot(1, age_s=5.0)
    assert not agg.snapshot_is_stale(fresh)
    assert agg.snapshot_is_stale(stale)
    s = ns.tr.signals_from_snapshot(stale)
    assert s["stale"] and s["alive"] and s["ready"]
    assert not ns.tr.signals_from_snapshot(fresh)["stale"]
    full = _full_snapshot()
    return {"stale": {k: v for k, v in s.items() if k != "time"},
            "fresh": {k: v for k, v in ns.tr.signals_from_snapshot(
                fresh).items() if k != "time"},
            "full": ns.tr.signals_from_snapshot(full),
            "dead": dict(ns.tr.DEAD_SIGNALS)}


class _FakeReplica:
    def __init__(self, rid, sig):
        self.replica_id = rid
        self._sig = sig
        self.submitted = []

    def drive(self):
        pass

    def signals(self):
        return dict(self._sig)

    def submit(self, prompt, max_tokens, *, eos_token=None,
               trace_ctx=None):
        self.submitted.append([int(t) for t in prompt])
        return len(self.submitted) - 1

    def partial_tokens(self, h):
        return []

    def result(self, h):
        return {"ok": True, "tokens": [1, 2],
                "finish_reason": "length", "metrics": {}}


def _router_skips_stale_replica(ns):
    fresh = ns.tr.signals_from_snapshot(_frozen_snapshot(0, age_s=0.1))
    stale = ns.tr.signals_from_snapshot(_frozen_snapshot(1, age_s=5.0))
    stale["queue_depth"] = 0.0
    r_ok = _FakeReplica("0", fresh)
    r_stale = _FakeReplica("1", stale)
    router = ns.fd.Router([r_ok, r_stale],
                          ns.fd.RouterConfig(affinity_tokens=0))
    futs = [router.submit(np.arange(4, dtype=np.int32), 2)
            for _ in range(4)]
    router.drain(timeout_s=10)
    assert len(r_stale.submitted) == 0
    assert len(r_ok.submitted) == 4
    assert all(f.result(timeout=1).tokens == [1, 2] for f in futs)
    return {"ok": r_ok.submitted, "stale": r_stale.submitted,
            "results": [_view(f.result(timeout=1)) for f in futs]}


def _dead_signals_never_place(ns):
    class DeadReplica:
        replica_id = "0"

        def drive(self):
            pass

        def signals(self):
            return dict(ns.tr.DEAD_SIGNALS)

        def submit(self, *a, **kw):
            raise AssertionError("placed on a dead replica")

        def partial_tokens(self, h):
            return []

        def result(self, h):
            return None

    router = ns.fd.Router([DeadReplica()], ns.fd.RouterConfig(max_attempts=1))
    fut = router.submit(np.arange(3, dtype=np.int32), 2)
    for _ in range(5):
        router.pump()
    assert not fut.done() or fut.exception() is not None
    return {"done": fut.done(), "pending": len(router._pending)}


@pytest.mark.parametrize("case", [
    _signals_stale_snapshot_marked, _router_skips_stale_replica,
    _dead_signals_never_place],
    ids=["signals_stale_snapshot_marked", "router_skips_stale_replica",
         "dead_signals_never_place"])
def test_signal_cases_match_jax(packs, case):
    _both(packs, case)


# ---------------------------------------------------------------------------
# the transport's rejoin hook
# ---------------------------------------------------------------------------

def test_membership_reappears_after_elastic_reinit(packs, monkeypatch):
    """``elastic.runner._reinitialize`` re-announces every live
    ``ReplicaServer``: a membership record lost with the old world (a
    fresh KV store after the rejoin) is back once the runtime is up
    again."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic.runner import _reinitialize
    from horovod_tpu_torch.serving.disagg import DictKV

    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    tns = packs[1]
    kv = DictKV()
    sess = tserving.serve(tns.params, tns.cfg, device="cpu", num_blocks=16,
                          block_size=8, max_active=2)
    hvd.init(config=hvd.Config(platform="cpu"))
    server = ttransport.ReplicaServer(sess, 5, kv_factory=lambda: kv,
                                      pool="decode", poll_interval_s=0.01)
    try:
        server.start()
        rec = kv.get("fd/member/5")
        assert rec is not None
        kv.delete("fd/member/5")
        _reinitialize()
        assert hvd.is_initialized()
        back = kv.get("fd/member/5")
        assert back is not None
        import json
        assert json.loads(back)["pool"] == "decode"
        assert json.loads(back)["rank"] == 5
    finally:
        server.stop()
        sess.close()
        hvd.shutdown()
    assert kv.get("fd/member/5") is None, "stop() withdraws membership"


def test_a_torn_snapshot_read_leaves_the_replica_alive(packs):
    """A router that reads a replica's snapshot while its publisher
    rewrites it gets a torn blob.  The JAX package's ``KVReplicaClient``
    then reports the live replica dead for that pass (in the disagg chaos
    scenario that dipped the decode pool to 1 in one run of four); the
    port's reads it again."""
    from horovod_tpu_torch.obs.aggregate import local_snapshot_blob
    from horovod_tpu_torch.runner.api import kv_put_blob
    from horovod_tpu_torch.serving.disagg import DictKV

    class TornOnceKV(DictKV):
        def __init__(self):
            super().__init__()
            self.torn = 0

        def wait(self, key, timeout_ms=10000):
            raw = super().wait(key, timeout_ms)
            if key == "obs/rank/0/0" and self.torn == 0:
                self.torn += 1
                return raw[: len(raw) // 2]
            return raw

    def fleet():
        kv = TornOnceKV()
        kv.set("fd/member/0", b'{"rank": 0, "pool": "decode"}')
        kv_put_blob(kv, "obs/rank/0", local_snapshot_blob(0, 1))
        return kv

    kv = fleet()
    sig = ttransport.KVReplicaClient(0, kv).signals()
    assert kv.torn == 1
    assert sig["alive"] and not sig["stale"] and sig["rank"] == 0
    kv = fleet()
    assert jtransport.KVReplicaClient(0, kv).signals()["alive"] is False
    assert kv.torn == 1

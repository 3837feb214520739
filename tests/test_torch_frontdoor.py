"""Port parity: the serving front door's single-replica half in
``horovod_tpu_torch`` — the radix prefix cache, speculative decoding and
their engine wiring.

- The pager and prefix-cache cases of ``tests/test_frontdoor.py`` run
  over the same sequence of operations on the port's ``KVPager`` /
  ``PrefixCache`` and on the JAX package's; every return value must be
  equal, and the reference's own assertions hold on both.
- Engine sessions (``serve(device="cpu")``, the JAX package's tiny fp32
  model moved across with ``params_from_jax``, prompts drawn with numpy)
  must emit the JAX ``generate`` oracle's tokens exactly, with a prefix
  hit's ``cached_tokens`` as the reference asserts, the speculative
  accepted and drafted totals equal to the JAX engine's on the same
  session, the pager's invariants, and the same serving, prefix-cache and
  speculative counters as the JAX engine's.  Both engines read the pool
  through the gather path (``use_flash="never"``), the reference's
  setting for these sessions.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu import serving as jserving
from horovod_tpu.models import llama as jllama
from horovod_tpu.obs import REGISTRY as JREG
from horovod_tpu.serving import kv_pager as jkv
from horovod_tpu.serving.frontdoor import prefix_cache as jpc
from horovod_tpu_torch import serving as tserving
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.obs import REGISTRY as TREG
from horovod_tpu_torch.serving import frontdoor as tfd
from horovod_tpu_torch.serving import kv_pager as tkv

JAX_NS = types.SimpleNamespace(KVPager=jkv.KVPager,
                               PagedKVCache=jkv.PagedKVCache,
                               PrefixCache=jpc.PrefixCache)
TORCH_NS = types.SimpleNamespace(KVPager=tkv.KVPager,
                                 PagedKVCache=tkv.PagedKVCache,
                                 PrefixCache=tfd.PrefixCache)


def _pager(ns, num_blocks=16, block_size=4):
    return ns.KVPager(ns.PagedKVCache(n_layers=2, num_blocks=num_blocks,
                                      block_size=block_size, kv_heads=2,
                                      head_dim=8))


# ---------------------------------------------------------------------------
# pager refcounts and the prefix cache: one sequence of operations, run on
# both packages (the cases of tests/test_frontdoor.py:60-196)
# ---------------------------------------------------------------------------

def _shared_prefix_refcounts(ns):
    p = _pager(ns)
    out = []
    t1 = p.allocate(1, 8)
    p.pin(t1[0])
    assert p.refcount(t1[0]) == 2 and p.is_pinned(t1[0])
    p.check_invariants()
    t2 = p.allocate(2, 8, prefix_blocks=[t1[0]])
    assert t2[0] == t1[0] and p.refcount(t1[0]) == 3
    out += [t1, t2, p.shared_blocks()]
    p.release(1)
    assert p.refcount(t1[0]) == 2
    free_before = p.free_blocks
    p.release(2)
    assert p.refcount(t1[0]) == 1 and p.free_blocks > free_before
    free_before = p.free_blocks
    p.unpin(t1[0])
    assert p.refcount(t1[0]) == 0 and p.free_blocks == free_before + 1
    p.check_invariants()
    return out + [p.free_blocks]


def _truncate_keeps_shared_blocks(ns):
    p = _pager(ns)
    t1 = p.allocate(1, 8)
    for b in t1:
        p.pin(b)
    t2 = p.allocate(2, 12, prefix_blocks=t1)
    remaining = p.truncate(2, 4)
    assert remaining == t2[:1]
    assert p.refcount(t1[1]) == 2 and p.refcount(t2[2]) == 0
    p.check_invariants()
    p.release(1)
    p.release(2)
    for b in t1:
        p.unpin(b)
    p.check_invariants()
    assert p.free_blocks == p.cache.num_blocks - 1
    return [t1, t2, remaining, p.free_blocks]


def _match_insert(ns):
    p = _pager(ns)
    pc = ns.PrefixCache(p)
    toks = np.arange(11, dtype=np.int32)
    table = p.allocate(1, 11)
    out = [pc.insert(toks, table), pc.resident_blocks]
    assert p.is_pinned(table[0]) and p.is_pinned(table[1])
    out.append(pc.match(toks))
    assert out[-1] == (8, table[:2])
    other = toks.copy()
    other[5] = 99
    out.append(pc.match(other))
    assert out[-1] == (4, table[:1])
    out.append(pc.match(toks[:8]))              # >= 1 token must prefill
    assert out[-1] == (4, table[:1])
    out.append(pc.match(np.full(9, 200, np.int32)))
    assert out[-1] == (0, [])
    out.append(pc.peek(toks))
    out.append(pc.insert(toks, table))
    assert out[-1] == 0
    return out


def _lru_eviction(ns):
    p = _pager(ns)
    pc = ns.PrefixCache(p)
    t1 = p.allocate(1, 4)
    t2 = p.allocate(2, 4)
    pc.insert(np.arange(4, dtype=np.int32), t1)
    pc.insert(np.arange(50, 54, dtype=np.int32), t2)
    p.release(1)
    p.release(2)
    pc.match(np.arange(50, 55, dtype=np.int32))   # t1's node is now LRU
    free_before = p.free_blocks
    out = [pc.evict(1)]
    assert out[0] == 1 and p.free_blocks == free_before + 1
    assert pc.resident_blocks == 1
    out.append(pc.match(np.arange(5, dtype=np.int32)))
    assert out[-1][0] == 0                         # t1's entry is gone
    out.append(pc.match(np.arange(50, 55, dtype=np.int32)))
    assert out[-1][0] == 4                         # t2's survived
    out.append(pc.evict(1, protect=t2))
    assert out[-1] == 0
    p.check_invariants()
    return out


def _respects_live_references(ns):
    p = _pager(ns)
    pc = ns.PrefixCache(p)
    t1 = p.allocate(1, 4)
    pc.insert(np.arange(4, dtype=np.int32), t1)
    out = [pc.evict(1)]
    assert out[0] == 0                             # request 1 holds it
    p.release(1)
    out.append(pc.evict(1))
    assert out[-1] == 1
    p.check_invariants()
    return out


def _max_blocks_cap(ns):
    p = _pager(ns, num_blocks=32)
    pc = ns.PrefixCache(p, max_blocks=2)
    t1 = p.allocate(1, 8)
    out = [pc.insert(np.arange(8, dtype=np.int32), t1)]
    p.release(1)
    assert pc.resident_blocks == 2
    t2 = p.allocate(2, 8)
    out.append(pc.insert(np.arange(100, 108, dtype=np.int32), t2))
    p.release(2)
    assert pc.resident_blocks == 2
    out.append(pc.match(np.arange(9, dtype=np.int32)))
    assert out[-1][0] == 0
    p.check_invariants()
    return out + [t1, t2]


_SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _shared_prefix_refcounts, _truncate_keeps_shared_blocks, _match_insert,
    _lru_eviction, _respects_live_references, _max_blocks_cap)}


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_pager_and_prefix_cache_match_jax(name):
    f = _SCENARIOS[name]
    assert f(TORCH_NS) == f(JAX_NS)


def test_prefix_cache_counters_match_jax():
    """The hvd_prefix_cache_* series move alike over one sequence of
    operations (eviction under a cap, hits, misses, shared blocks)."""
    names = ("hvd_prefix_cache_hits_total", "hvd_prefix_cache_misses_total",
             "hvd_prefix_cache_evictions_total",
             "hvd_prefix_cache_blocks_shared_total")
    moved = []
    for ns, reg in ((TORCH_NS, TREG), (JAX_NS, JREG)):
        before = {n: reg.get(n).total() for n in names}
        for f in (_match_insert, _lru_eviction, _max_blocks_cap):
            f(ns)
        moved.append({n: reg.get(n).total() - before[n] for n in names})
        moved[-1]["blocks"] = reg.get("hvd_prefix_cache_blocks").total()
    assert moved[0] == moved[1]
    assert moved[0]["hvd_prefix_cache_evictions_total"] > 0


# ---------------------------------------------------------------------------
# engine sessions: tokens of the JAX generate oracle, totals of the JAX
# engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()            # v256 d64 L2 H4 KV2 fp32
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    weak_j = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    weak_t = tllama.params_from_jax(jax.tree.map(np.asarray, weak_j),
                                    device="cpu")
    return (jcfg, jparams, weak_j), (tllama.LlamaConfig.tiny(), tparams,
                                     weak_t)


def _prompts(rng, lens):
    return [rng.randint(0, 256, size=(n,)).astype(np.int32) for n in lens]


_oracles: dict = {}


def _oracle(jparams, jcfg, prompt, max_new):
    key = (prompt.tobytes(), max_new)
    if key not in _oracles:
        full = np.asarray(jllama.generate(
            jparams, jnp.asarray(prompt[None]), jcfg,
            max_new_tokens=max_new))[0]
        _oracles[key] = [int(t) for t in full[len(prompt):]]
    return _oracles[key]


def _prefix_prompts(seed, head_len, tails):
    rng = np.random.RandomState(seed)
    head = rng.randint(0, 256, size=(head_len,)).astype(np.int32)
    return [head] + [np.concatenate([head, t])
                     for t in _prompts(rng, tails)]


# name -> (prompts, max new tokens, engine knobs, draft: None, "self" or
# "weak", wave: the first prompt drains alone first, so the others hit
# its cached head).  The sessions of tests/test_frontdoor.py:198-300.
_SESSIONS = {
    "prefix_reuse": (lambda: _prefix_prompts(3, 24, [7, 11]), 12,
                     dict(prefix_cache=True), None, True),
    "spec_k1": (lambda: _prompts(np.random.RandomState(4), [5, 9, 13]), 11,
                dict(spec_k=1), "self", False),
    "spec_k2": (lambda: _prompts(np.random.RandomState(4), [5, 9, 13]), 11,
                dict(spec_k=2), "self", False),
    "spec_k4": (lambda: _prompts(np.random.RandomState(4), [5, 9, 13]), 11,
                dict(spec_k=4), "self", False),
    "spec_weak_draft": (lambda: _prompts(np.random.RandomState(5), [6, 10]),
                        10, dict(spec_k=3), "weak", False),
    "spec_with_prefix": (lambda: _prefix_prompts(6, 16, [5]), 9,
                         dict(prefix_cache=True, spec_k=2), "self", True),
}

_COUNTERS = ("hvd_serving_prefill_tokens_total",
             "hvd_serving_prefill_skipped_tokens_total",
             "hvd_serving_decode_tokens_total",
             "hvd_prefix_cache_hits_total", "hvd_prefix_cache_misses_total",
             "hvd_prefix_cache_evictions_total",
             "hvd_prefix_cache_blocks_shared_total",
             "hvd_spec_rounds_total", "hvd_spec_tokens_drafted_total",
             "hvd_spec_tokens_accepted_total")
_GAUGES = ("hvd_prefix_cache_blocks", "hvd_spec_accept_rate")


def _session(serving, reg, params, cfg, draft, name, **kw):
    """Run one session; returns (results, engine, counter deltas and the
    gauges after it)."""
    prompts, max_new, knobs, _, wave = _SESSIONS[name]
    prompts = prompts()
    if draft is not None:
        kw.update(draft_params=draft, draft_cfg=cfg)
    before = {n: reg.get(n).total() for n in _COUNTERS if reg.get(n)}
    sess = serving.serve(params, cfg, num_blocks=64, block_size=8,
                         max_active=4, use_flash="never", **knobs, **kw)
    futs = [sess.submit(prompts[0], max_new)]
    if wave:
        sess.drain()
    futs += [sess.submit(p, max_new) for p in prompts[1:]]
    sess.drain()
    results = [f.result() for f in futs]
    moved = {n: reg.get(n).total() - before.get(n, 0.0) for n in _COUNTERS
             if reg.get(n)}
    moved.update({n: reg.get(n).total() for n in _GAUGES if reg.get(n)})
    sess.engine.pager.check_invariants()
    sess.close()
    return prompts, results, sess.engine, moved


_jax_sessions: dict = {}


def _jax_session(models, name):
    if name not in _jax_sessions:
        jcfg, jparams, weak = models[0]
        draft = {None: None, "self": jparams, "weak": weak}[
            _SESSIONS[name][3]]
        _jax_sessions[name] = _session(jserving, JREG, jparams, jcfg, draft,
                                       name)
    return _jax_sessions[name]


@pytest.mark.parametrize("name", list(_SESSIONS))
def test_session_matches_jax(models, name):
    jcfg, jparams, _ = models[0]
    tcfg, tparams, weak = models[1]
    draft = {None: None, "self": tparams, "weak": weak}[_SESSIONS[name][3]]
    prompts, got, eng, moved = _session(tserving, TREG, tparams, tcfg,
                                        draft, name, device="cpu")
    _, want, jeng, jmoved = _jax_session(models, name)
    max_new = _SESSIONS[name][1]
    for i, (p, t, j) in enumerate(zip(prompts, got, want)):
        assert t.tokens == _oracle(jparams, jcfg, p, max_new), \
            f"request {i} diverged from the generate oracle"
        assert t.tokens == j.tokens
        assert t.metrics["cached_tokens"] == j.metrics["cached_tokens"]
    if _SESSIONS[name][4]:                      # the prefix-hit sessions
        head = len(prompts[0])
        assert got[0].metrics["cached_tokens"] == 0
        assert all(r.metrics["cached_tokens"] == head for r in got[1:])
    if eng.spec is not None:
        assert eng.spec._drafted_total == jeng.spec._drafted_total > 0
        assert eng.spec._accepted_total == jeng.spec._accepted_total
        if _SESSIONS[name][3] == "self":
            assert eng.spec._accepted_total == eng.spec._drafted_total
        assert eng.decode_ticks == 0, "spec rounds replace the decode tick"
    assert moved == jmoved


def test_prefix_hit_counts_only_the_tail_as_prefilled(models):
    """hvd_serving_prefill_tokens_total counts prompt minus cached
    tokens; the cached ones go to the skipped counter (the reference's
    engine.py:303-304)."""
    tcfg, tparams, _ = models[1]
    prompts, got, _, moved = _session(tserving, TREG, tparams, tcfg, None,
                                      "prefix_reuse", device="cpu")
    total = sum(len(p) for p in prompts)
    assert moved["hvd_serving_prefill_skipped_tokens_total"] == 2 * 24
    assert moved["hvd_serving_prefill_tokens_total"] == total - 2 * 24
    assert moved["hvd_prefix_cache_hits_total"] == 2
    assert moved["hvd_prefix_cache_blocks_shared_total"] == 2 * 3


def test_spec_without_a_draft_raises(models):
    tcfg, tparams, _ = models[1]
    with pytest.raises(ValueError, match="draft_params and draft_cfg"):
        tserving.serve(tparams, tcfg, device="cpu", spec_k=2)
    with pytest.raises(ValueError, match="draft_params and draft_cfg"):
        tserving.serve(tparams, tcfg, device="cpu", spec_k=2,
                       draft_params=tparams)
    with pytest.raises(ValueError, match="vocab"):
        tserving.serve(tparams, tcfg, device="cpu", spec_k=2,
                       draft_params=tparams,
                       draft_cfg=tllama.LlamaConfig.tiny(vocab_size=128))


def test_scheduler_evicts_cache_under_pressure(models):
    """A full pool with idle cached blocks must evict them to admit new
    work instead of rejecting or preempting (tests/test_frontdoor.py:491
    on the port)."""
    (jcfg, jparams, _), (tcfg, tparams, _) = models
    sess = tserving.serve(tparams, tcfg, device="cpu", num_blocks=10,
                          block_size=8, max_active=2, use_flash="never",
                          prefix_cache=True)
    rng = np.random.RandomState(11)
    p1 = rng.randint(0, 256, size=(16,)).astype(np.int32)
    f1 = sess.submit(p1, 4)
    sess.drain()
    assert f1.result().metrics["finish_reason"] == "length"
    cache = sess.engine.prefix_cache
    assert cache.resident_blocks == 2
    probe = np.concatenate([p1, p1[:1]])
    assert cache.match(probe)[0] == 16
    # 9 usable blocks, 2 pinned idle: a 60-token prompt needs 8 blocks
    # (decode headroom included) — only an eviction makes it fit.
    p2 = rng.randint(0, 256, size=(60,)).astype(np.int32)
    f2 = sess.submit(p2, 4)
    sess.drain()
    assert f2.result().tokens == _oracle(jparams, jcfg, p2, 4)
    assert cache.match(probe)[0] < 16
    sess.engine.pager.check_invariants()
    sess.close()


def test_prefix_hit_through_the_paged_kernel_path(models):
    """With use_flash="auto" (the paged kernel's plain version on CPU
    tensors) a prefix-hit session's decode ticks read the pool the tail
    prefill wrote: tokens equal the oracle's."""
    (jcfg, jparams, _), (tcfg, tparams, _) = models
    prompts = _prefix_prompts(8, 16, [3, 9])
    sess = tserving.serve(tparams, tcfg, device="cpu", num_blocks=32,
                          block_size=8, max_active=3, prefix_cache=True)
    assert sess.engine._use_flash
    futs = [sess.submit(prompts[0], 6)]
    sess.drain()
    futs += [sess.submit(p, 6) for p in prompts[1:]]
    sess.drain()
    for p, f in zip(prompts, futs):
        assert f.result().tokens == _oracle(jparams, jcfg, p, 6)
    assert [f.result().metrics["cached_tokens"] for f in futs] == [0, 16, 16]
    assert sess.engine.decode_ticks > 0
    sess.engine.pager.check_invariants()
    sess.close()

"""Port parity: the serving path of ``horovod_tpu_torch``.

``serve()`` on the port (``device="cpu"``) must emit the same greedy tokens
as the JAX package's ``serve()`` on the same parameters and prompts, through
the decode kernel's plain version (``use_flash="auto"`` on CPU tensors) and
through the gather path (``use_flash="never"``).  Prompts are drawn with
numpy from a seed; the parameters are the JAX package's tiny fp32 model,
moved across with ``params_from_jax``.  The pager and the scheduler are the
port's copies of the JAX package's; their cases mirror
``tests/test_serving.py`` and a seeded random workload holds each copy
against its original step by step.  The import hygiene of the port (no
``jax``, no ``horovod_tpu``) is checked in a fresh interpreter, since this
test process imports both packages.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from collections import deque
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from horovod_tpu import serving as jserving
from horovod_tpu.models import llama as jllama
from horovod_tpu.serving import kv_pager as jkv
from horovod_tpu.serving import scheduler as jsched
from horovod_tpu_torch import chaos, context
from horovod_tpu_torch import serving as tserving
from horovod_tpu_torch.context import HorovodInternalError
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.ops import flash_attention as FA
from horovod_tpu_torch.serving.kv_pager import KVPager, OutOfBlocks
from horovod_tpu_torch.serving.scheduler import Request, Scheduler
from horovod_tpu_torch.utils.timeline import Timeline

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()            # v256 d64 L2 H4 KV2 fp32
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tllama.LlamaConfig.tiny(), tparams


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=(n,)).astype(np.int32) for n in lens]


def _run(sess, prompts, max_new, **submit_kw):
    futs = [sess.submit(p, m, **submit_kw) for p, m in zip(prompts, max_new)]
    sess.drain()
    return [f.result() for f in futs]


# ---------------------------------------------------------------------------
# serve(): greedy tokens identical to the JAX package's serve()
# ---------------------------------------------------------------------------

# name -> (prompt seed, prompt lengths, max new tokens, engine knobs, the
# JAX engine's use_flash).  block_size 8 takes the paged-kernel path on
# both sides (the Pallas kernel in interpret mode on the JAX side); the
# smaller pages take the gather path there.
_CASES = {
    "same_length": (1, [8, 8, 8], [6, 6, 6],
                    dict(block_size=4, num_blocks=64, max_active=4), "auto"),
    "mixed_lengths": (2, [5, 11, 3, 16, 9], [4, 7, 12, 3, 6],
                      dict(block_size=4, num_blocks=64, max_active=3),
                      "auto"),
    # 11 usable blocks of 2 = 22 token slots; 3 requests need 16+ each.
    "preemption": (3, [6, 6, 6], [10, 10, 10],
                   dict(block_size=2, num_blocks=12, max_active=3), "auto"),
    # 5 usable pages of 8 = 40 slots; 3 requests need 25 each.
    "preemption_kernel": (4, [12, 12, 12], [13, 13, 13],
                          dict(block_size=8, num_blocks=6, max_active=3),
                          "interpret"),
    "bucketed_prefill": (5, [3, 5, 9], [5, 5, 5],
                         dict(block_size=4, num_blocks=64, max_active=3,
                              prefill_buckets=(8, 16)), "auto"),
    "kernel_pages": (6, [6, 10, 21], [6, 6, 9],
                     dict(block_size=8, num_blocks=32, max_active=2),
                     "interpret"),
}

_jax_results: dict = {}


def _jax_serve(models, name):
    """The JAX engine's results for a case, computed once per process."""
    if name not in _jax_results:
        jcfg, jparams, _, _ = models
        seed, lens, mx, kw, jflash = _CASES[name]
        sess = jserving.serve(jparams, jcfg, use_flash=jflash, **kw)
        _jax_results[name] = _run(sess, _prompts(seed, lens), mx)
    return _jax_results[name]


@pytest.mark.parametrize("use_flash", ["auto", "never"])
@pytest.mark.parametrize("name", list(_CASES))
def test_serve_tokens_match_jax(models, name, use_flash):
    _, _, tcfg, tparams = models
    seed, lens, mx, kw, _ = _CASES[name]
    ref = _jax_serve(models, name)
    launches = FA.paged_attention.launches
    sess = tserving.serve(tparams, tcfg, device="cpu", use_flash=use_flash,
                          **kw)
    got = _run(sess, _prompts(seed, lens), mx)
    for i, (j, t) in enumerate(zip(ref, got)):
        assert t.tokens == j.tokens, f"request {i} (prompt {lens[i]})"
        assert t.metrics["finish_reason"] == j.metrics["finish_reason"]
        assert t.metrics["preemptions"] == j.metrics["preemptions"]
    if name.startswith("preemption"):
        assert sum(t.metrics["preemptions"] for t in got) > 0, \
            "the pool was sized to force preemption"
    assert FA.paged_attention.launches == launches, \
        "CPU tensors run the plain version and launch nothing"


def test_engine_counts_decode_ticks(models):
    _, _, tcfg, tparams = models
    sess = tserving.serve(tparams, tcfg, device="cpu", block_size=8,
                          num_blocks=16, max_active=2)
    res = _run(sess, _prompts(7, [4, 9]), [3, 5])
    assert [len(r.tokens) for r in res] == [3, 5]
    # The prefill emits each request's first token; the longer request
    # then needs 4 decode ticks, the shorter 2 of them.
    assert sess.engine.decode_ticks == 4


def test_serve_without_device_raises_without_cuda(models, monkeypatch):
    _, _, tcfg, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.serve(tparams, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.init_params(tcfg, torch.Generator())


def test_engine_rejects_params_on_another_device(models):
    _, _, tcfg, tparams = models
    moved = dict(tparams, embed=tparams["embed"].to("meta"))
    with pytest.raises(ValueError, match="engine runs on cpu"):
        tserving.serve(moved, tcfg, device="cpu")


def test_device_defaults_to_the_local_rank_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("HVDTPU_LOCAL_RANK", "1")
    assert context.device() == torch.device("cuda", 1)
    assert context.device("cpu") == torch.device("cpu")
    monkeypatch.setenv("HVDTPU_LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="only 2"):
        context.device()


@pytest.mark.parametrize("what", ["mesh", "moe"])
def test_later_slices_raise_not_implemented(models, what):
    """The name is kept from when sharded serving waited for a later
    slice: what is refused now is what the JAX package refuses, with its
    messages: sp, ep and pp meshes (training-path axes), a decode batch
    that does not divide over dp·fsdp, and MoE configs."""
    _, _, tcfg, tparams = models
    if what == "moe":
        with pytest.raises(NotImplementedError,
                           match="serving does not support MoE configs"):
            tserving.serve(tparams, tllama.LlamaConfig.tiny(use_moe=True),
                           device="cpu")
        return
    for axis in ("sp", "ep", "pp"):
        with pytest.raises(NotImplementedError,
                           match=f"serving supports dp/fsdp/tp meshes; "
                                 f"{axis} is a training-path axis here"):
            tserving.serve(tparams, tcfg, device="cpu", mesh={axis: 2})
    with pytest.raises(ValueError,
                       match="max_active=3 must divide over dp\\*fsdp=2"):
        tserving.serve(tparams, tcfg, device="cpu", mesh={"dp": 2},
                       max_active=3)


# ---------------------------------------------------------------------------
# serve(mesh=) over Gloo
# ---------------------------------------------------------------------------

def _serve_tokens(sess) -> list:
    import mp_torch_mesh_worker as MW
    futs = [sess.submit(p, MW.SERVE["new"]) for p in MW.serve_prompts()]
    sess.drain()
    out = [list(f.result().tokens) for f in futs]
    sess.close()
    return out


@pytest.fixture(scope="module")
def served2(tmp_path_factory):
    """The port's np=2 job (``tests/mp_torch_mesh_worker.py``, mode
    ``serving``: dp2 and tp2, with and without the prefix cache), the JAX
    package's ``serve(mesh=)`` on meshes of the same shape, and the
    port's unsharded engine, on the same weights and prompts."""
    import threading

    import jax.numpy as jnp

    import mp_torch_dataplane_worker as DW
    import mp_torch_mesh_worker as MW
    from horovod_tpu.parallel import MeshConfig as JMeshConfig
    from horovod_tpu.parallel import build_mesh as jbuild_mesh
    outdir = str(tmp_path_factory.mktemp("serve2"))
    jcfg = jllama.LlamaConfig.tiny()
    full = jax.tree.map(np.asarray, jllama.init_params(
        jcfg, jax.random.PRNGKey(0),
        jbuild_mesh(JMeshConfig(), devices=jax.devices()[:1])))
    np.savez(os.path.join(outdir, "params.dense.npz"),
             **MW.flat_params(full))
    box = {}
    job = threading.Thread(target=lambda: box.setdefault(
        "res", MW.launch("serving", outdir, 2, timeout=240)))
    job.start()
    knobs = {k: MW.SERVE[k] for k in ("block_size", "num_blocks",
                                      "max_active")}
    ref = {}
    for name, sizes in MW.SERVE_MESHES.items():
        mesh = jbuild_mesh(JMeshConfig(**sizes), devices=jax.devices()[:2])
        params = jax.device_put(jax.tree.map(jnp.asarray, full),
                                jllama.param_shardings(jcfg, mesh))
        ref[name] = _serve_tokens(jserving.serve(params, jcfg, mesh=mesh,
                                                 **knobs))
    job.join()
    DW.check_ranks(box["res"])
    tparams = tllama.params_from_jax(full, device="cpu")
    plain = {tag: _serve_tokens(tserving.serve(
        tparams, tllama.LlamaConfig.tiny(), device="cpu", **knobs, **extra))
        for tag, extra in (("plain", {}), ("prefix", {"prefix_cache": True}))}
    return MW.load("serving", outdir, 2), ref, plain


@pytest.mark.parametrize("tag", ["plain", "prefix"])
@pytest.mark.parametrize("name", ["dp2", "tp2"])
def test_mesh_serving_matches_unsharded_and_jax(served2, name, tag):
    """Every rank's engine on the mesh emits every request's tokens: the
    unsharded engine's, and the JAX package's engine's on a mesh of the
    same shape (with the prefix cache too: the hits prefill through
    ``extend_step_paged`` on the mesh)."""
    import mp_torch_mesh_worker as MW
    ranks, ref, plain = served2
    for arrays, info in ranks:
        assert not info["jax_loaded"]
        got = [arrays[f"{name}.{tag}.req{i}"].tolist()
               for i in range(len(MW.serve_prompts()))]
        assert got == plain[tag]
        assert got == ref[name]
        assert info[f"{name}.{tag}.ticks"] > 0


@pytest.mark.parametrize("name", ["dp2", "tp2"])
def test_mesh_pool_holds_the_rank_share_of_the_kv_heads(served2, name):
    """The pool is ``[L, num_blocks, block_size, KV/tp, Dh]`` on every
    rank: the tp share of the kv heads, every block (dp keeps it
    whole)."""
    import mp_torch_mesh_worker as MW
    ranks, _, _ = served2
    kv = 2 // (2 if name == "tp2" else 1)
    for _, info in ranks:
        assert info[f"{name}.plain.pool"] == [2, MW.SERVE["num_blocks"],
                                              MW.SERVE["block_size"], kv, 16]


def test_migration_raises_not_implemented(models):
    """Only a speculative engine still refuses a migration (the name is
    kept from when every migration was refused): ``submit(migrate_cb=)``
    ends the request at its prefill emission
    with the exported KV; ``import_migrated`` resumes it on another
    session to the tokens of an unmigrated run; a speculative engine
    refuses the import, as the JAX package's does, and stays empty."""
    _, _, tcfg, tparams = models
    prompt = np.arange(4, dtype=np.int32)
    box = []
    sess = tserving.serve(tparams, tcfg, device="cpu", num_blocks=8)
    fut = sess.submit(prompt, 5, migrate_cb=lambda *m: box.append(m))
    sess.drain()
    head = fut.result()
    assert head.metrics["finish_reason"] == "migrated"
    assert len(head.tokens) == 1 and len(box) == 1
    assert not sess.engine.has_work()
    assert sess.engine.pager.free_blocks == sess.engine.cache.num_blocks - 1
    manifest, k_bytes, v_bytes = box[0]
    other = tserving.serve(tparams, tcfg, device="cpu", num_blocks=8)
    res = other.import_migrated(manifest, k_bytes, v_bytes)
    other.drain()
    plain = _run(tserving.serve(tparams, tcfg, device="cpu", num_blocks=8),
                 [prompt], [5])[0]
    assert res.result().tokens == plain.tokens
    assert res.result().tokens[:1] == head.tokens
    spec = tserving.serve(tparams, tcfg, device="cpu", num_blocks=8,
                          spec_k=2, draft_params=tparams, draft_cfg=tcfg)
    with pytest.raises(NotImplementedError, match="speculative"):
        spec.import_migrated(manifest, k_bytes, v_bytes)
    assert not spec.engine.has_work()
    assert spec.engine.pager.free_blocks == spec.engine.cache.num_blocks - 1


def test_init_reads_launcher_env_and_serve_borrows_its_timeline(
        models, monkeypatch, tmp_path):
    # init now starts torch.distributed, so a lone process is rank 0 of 1
    # (on the CPU when asked); the per-rank timeline names of a two-rank
    # job are held by tests/test_torch_engine.py.
    _, _, tcfg, tparams = models
    monkeypatch.setenv("HVDTPU_CROSS_RANK", "0")
    monkeypatch.setenv("HVDTPU_CROSS_SIZE", "1")
    monkeypatch.setenv("HVDTPU_LOCAL_RANK", "0")
    monkeypatch.setenv("HVDTPU_PLATFORM", "cpu")
    path = tmp_path / "tl.json"
    context.init(timeline=str(path))
    try:
        assert context.is_initialized()
        assert (context.rank(), context.size(), context.local_rank()) \
            == (0, 1, 0)
        tl = context.global_state().timeline
        assert tl.enabled
        with tserving.serve(tparams, tcfg, device="cpu", block_size=4,
                            num_blocks=16, max_active=1) as sess:
            _run(sess, _prompts(10, [5]), [2])
        assert tl.enabled, "a borrowed timeline outlives the session"
    finally:
        context.shutdown()
    assert not context.is_initialized()
    with pytest.raises(RuntimeError, match="init"):
        context.rank()
    text = path.read_text()
    assert "QUEUE" in text and "DECODE" in text


def test_init_rejects_a_bad_launcher_env(monkeypatch):
    monkeypatch.setenv("HVDTPU_CROSS_RANK", "3")
    monkeypatch.setenv("HVDTPU_CROSS_SIZE", "2")
    with pytest.raises(ValueError, match="rank=3 size=2"):
        context.init()
    monkeypatch.setenv("HVDTPU_CROSS_SIZE", "two")
    with pytest.raises(ValueError, match="not an integer"):
        context.init()
    assert not context.is_initialized()


# ---------------------------------------------------------------------------
# the session surface: streaming, metrics, timeline, validation, eos
# ---------------------------------------------------------------------------

def test_streaming_callback_ordering(models):
    _, _, tcfg, tparams = models
    events: list[tuple[int, int]] = []
    sess = tserving.serve(tparams, tcfg, device="cpu", block_size=4,
                          num_blocks=64, max_active=2)
    res = _run(sess, _prompts(7, [4, 8]), [6, 6],
               stream_cb=lambda rid, tok: events.append((rid, tok)))
    for r in res:
        assert [t for rid, t in events if rid == r.req_id] == r.tokens
    assert len({rid for rid, _ in events}) == 2


def test_metrics_and_timeline_spans(models, tmp_path):
    _, _, tcfg, tparams = models
    path = str(tmp_path / "serving_timeline.json")
    sess = tserving.serve(tparams, tcfg, device="cpu", block_size=4,
                          num_blocks=64, max_active=2,
                          timeline=Timeline(path))
    (res,) = _run(sess, _prompts(8, [6]), [4])
    m = res.metrics
    assert m["new_tokens"] == 4 and m["finish_reason"] == "length"
    assert m["queue_wait_s"] >= 0 and m["ttft_s"] >= 0
    assert m["decode_tokens_per_s"] is None or m["decode_tokens_per_s"] > 0
    assert sess.request_trace(res.req_id) is None or \
        sess.request_trace(res.req_id)["trace_id"] == m["trace_id"]
    sess.close()
    text = open(path).read()
    assert "QUEUE" in text and "DECODE" in text and "req0" in text


def test_submit_validation(models):
    _, _, tcfg, tparams = models
    sess = tserving.serve(tparams, tcfg, device="cpu", block_size=4,
                          num_blocks=8, max_active=1)
    with pytest.raises(ValueError, match="empty"):
        sess.submit(np.zeros((0,), np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        sess.submit(np.arange(4, dtype=np.int32), 0)
    # 7 usable blocks of 4 = 28 slots: a 40-token prompt can never fit,
    # and a fitting request behind the rejection still runs.
    with pytest.raises(ValueError, match="blocks"):
        sess.submit(np.arange(40, dtype=np.int32), 4)
    (res,) = _run(sess, [np.arange(6, dtype=np.int32)], [2])
    assert len(res.tokens) == 2


def test_eos_token_stops_early(models):
    jcfg, jparams, tcfg, tparams = models
    prompt = _prompts(9, [6])
    (ref,) = _run(jserving.serve(jparams, jcfg, block_size=4, num_blocks=64,
                                 max_active=1), prompt, [8])
    eos = ref.tokens[2]
    sess = tserving.serve(tparams, tcfg, device="cpu", block_size=4,
                          num_blocks=64, max_active=1)
    (res,) = _run(sess, prompt, [8], eos_token=eos)
    assert res.tokens == ref.tokens[:ref.tokens.index(eos) + 1]
    assert res.metrics["finish_reason"] == "stop"


def test_background_thread_failure_sets_future_exception(models):
    """A request that outgrows the pool while running alone raises
    OutOfBlocks in the engine; the serving thread puts it on the future."""
    _, _, tcfg, tparams = models
    sess = tserving.serve(tparams, tcfg, device="cpu", block_size=4,
                          num_blocks=4, max_active=1)
    fut = sess.submit(np.arange(4, dtype=np.int32), 12)
    sess.start()
    with pytest.raises(OutOfBlocks):
        fut.result(timeout=120)
    sess.close()


# ---------------------------------------------------------------------------
# graceful degradation (the chaos sites the engine fires)
# ---------------------------------------------------------------------------

def test_serving_abort_carries_error_finish_reason(models):
    _, _, tcfg, tparams = models
    with tserving.serve(tparams, tcfg, device="cpu", num_blocks=16,
                        block_size=8, max_active=2) as sess:
        chaos.arm("serving_step:err:after=2:times=1")
        try:
            r0, r1 = _run(sess, [np.arange(4, dtype=np.int32),
                                 np.arange(3, dtype=np.int32)], [8, 8])
        finally:
            chaos.disarm()
        for r in (r0, r1):
            assert r.metrics["finish_reason"] == "error"
            assert "injected fault" in r.metrics["error"]
            assert 1 <= len(r.tokens) < 8
        assert sess.recoveries == 1
        assert context.component_health("serving") is True
        (r2,) = _run(sess, [np.arange(5, dtype=np.int32)], [3])
        assert r2.metrics["finish_reason"] == "length"
        assert len(r2.tokens) == 3
    assert context.component_health("serving") is None


def test_serving_gives_up_after_max_recoveries(models):
    _, _, tcfg, tparams = models
    with tserving.serve(tparams, tcfg, device="cpu", num_blocks=16,
                        block_size=8, max_active=2,
                        max_recoveries=0) as sess:
        chaos.arm("serving_step:err")
        try:
            sess.submit(np.arange(4, dtype=np.int32), 4)
            with pytest.raises(chaos.InjectedFault):
                sess.drain()
        finally:
            chaos.disarm()
        assert context.component_health("serving") is False


def test_serving_admission_fault_rejects_before_queue(models):
    _, _, tcfg, tparams = models
    with tserving.serve(tparams, tcfg, device="cpu", num_blocks=16,
                        block_size=8, max_active=2) as sess:
        chaos.arm("serving_admit:err")
        try:
            with pytest.raises(chaos.InjectedFault):
                sess.submit(np.arange(4, dtype=np.int32), 4)
        finally:
            chaos.disarm()
        assert not sess.engine.has_work()


def test_collective_failure_rejoin_waits_for_elastic_slice(models,
                                                           monkeypatch):
    """A collective failure aborts the in-flight requests like any other
    engine failure, then the replica rejoins through the elastic path:
    the runtime is shut down and initialized anew in this process (as the
    reference's ``_handle_engine_failure`` does), and serving goes on."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import context
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    _, _, tcfg, tparams = models
    hvd.init(config=hvd.Config(platform="cpu"))
    try:
        engine_before = hvd.global_state().engine
        with tserving.serve(tparams, tcfg, device="cpu", num_blocks=16,
                            block_size=8, max_active=2) as sess:
            fut = sess.submit(np.arange(4, dtype=np.int32), 4)
            real_step = sess.engine.step

            def broken_step():
                monkeypatch.setattr(sess.engine, "step", real_step)
                raise HorovodInternalError("allreduce aborted")

            monkeypatch.setattr(sess.engine, "step", broken_step)
            sess.drain()
            assert fut.result(timeout=0).metrics["finish_reason"] == "error"
            assert sess.recoveries == 1
            assert hvd.is_initialized()
            assert hvd.global_state().engine is not engine_before
            assert context.component_health("serving") is True
            again = sess.submit(np.arange(4, dtype=np.int32), 4)
            sess.drain()
            assert again.result(timeout=0).metrics["finish_reason"] != \
                "error"
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# pager and scheduler: the port's copies
# ---------------------------------------------------------------------------

def _pager(num_blocks=8, block_size=4, mod=None):
    m = mod or sys.modules[KVPager.__module__]
    return m.KVPager(m.PagedKVCache(n_layers=2, num_blocks=num_blocks,
                                    block_size=block_size, kv_heads=2,
                                    head_dim=8))


def _req(i, n, max_new=4, mod=None):
    cls = (mod or sys.modules[Request.__module__]).Request
    return cls(req_id=i, prompt=np.arange(n, dtype=np.int32),
               max_new_tokens=max_new)


def test_pager_allocate_free_invariants():
    p = _pager()
    t1 = p.allocate(1, 7)
    t2 = p.allocate(2, 9)
    assert len(t1) == 2 and len(t2) == 3
    assert 0 not in t1 + t2
    assert not set(t1) & set(t2)
    p.check_invariants()
    assert p.free_blocks == 2
    p.release(1)
    assert p.free_blocks == 4
    t3 = p.allocate(3, 16)
    assert set(t3) & set(t1), "released blocks are reused"
    p.check_invariants()


def test_pager_oom_and_errors():
    p = _pager(num_blocks=4)
    p.allocate(1, 8)
    with pytest.raises(OutOfBlocks):
        p.allocate(2, 8)
    p.check_invariants()
    assert p.free_blocks == 1
    with pytest.raises(ValueError):
        p.allocate(1, 4)
    with pytest.raises(KeyError):
        p.release(99)
    p.release(1)
    with pytest.raises(KeyError):
        p.release(1)
    p.check_invariants()


def test_pager_extend_and_table_matrix():
    p = _pager()
    p.allocate(1, 4)
    tbl = p.extend(1, 5)
    assert len(tbl) == 2 and p.extend(1, 6) == tbl
    m = p.table_matrix([1, -1], 4)
    assert m.shape == (2, 4) and m.dtype == np.int32
    assert list(m[0][:2]) == tbl and list(m[0][2:]) == [0, 0]
    assert list(m[1]) == [0, 0, 0, 0], "inactive rows are all-scratch"


def test_gather_blocks_matches_jax():
    rng = np.random.RandomState(0)
    pool = rng.randn(6, 4, 2, 8).astype(np.float32)
    table = np.array([[3, 1, 0], [5, 2, 4]], np.int32)
    got = tserving.gather_blocks(torch.from_numpy(pool),
                                 torch.from_numpy(table))
    want = np.asarray(jkv.gather_blocks(jax.numpy.asarray(pool),
                                        jax.numpy.asarray(table)))
    assert tuple(got.shape) == want.shape == (2, 12, 2, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scheduler_fifo_admission_token_budget():
    s = Scheduler(_pager(num_blocks=64), max_active=8,
                  prefill_token_budget=20)
    for i, n in enumerate([16, 16, 16, 4]):
        s.submit(_req(i, n))
    assert [r.req_id for r in s.admit()] == [0], "budget admission is FIFO"
    assert [r.req_id for r in s.admit()] == [1]


def test_scheduler_single_overbudget_prompt_still_admitted():
    s = Scheduler(_pager(num_blocks=64), max_active=4,
                  prefill_token_budget=8)
    s.submit(_req(0, 100))
    assert [r.req_id for r in s.admit()] == [0]


def test_scheduler_blocks_gate_admission_fifo():
    s = Scheduler(_pager(num_blocks=8), max_active=4,
                  prefill_token_budget=1000)
    s.submit(_req(0, 20))
    s.submit(_req(1, 4))
    assert [r.req_id for r in s.admit()] == [0]
    assert [r.req_id for r in s.admit()] == [], "head of line is not bypassed"
    s.finish(s.running[0])
    assert [r.req_id for r in s.admit()] == [1]


def test_scheduler_preemption_requeues_with_progress():
    s = Scheduler(_pager(num_blocks=8), max_active=2,
                  prefill_token_budget=1000)
    s.submit(_req(0, 8, max_new=20))
    s.submit(_req(1, 8, max_new=20))
    a, b = s.admit()
    a.generated, a.context_len = [7, 8], 10
    b.generated, b.context_len = [9], 9
    for n in range(11, 24):
        s.grow(a)
        a.context_len = n
    assert b.state.value == "waiting" and b.preemptions == 1
    assert s.waiting[0] is b, "a preempted request re-queues at the front"
    assert list(b.prefill_tokens) == list(b.prompt) + [9]


def test_scheduler_fails_unfittable_requeued_request():
    s = Scheduler(_pager(num_blocks=4), max_active=2,
                  prefill_token_budget=1000)
    r = _req(0, 4, max_new=30)
    s.submit(r)
    r.prefill_tokens = np.arange(20, dtype=np.int32)
    assert s.admit() == []
    assert s.waiting == deque()
    assert len(s.failed) == 1 and s.failed[0][0] is r
    assert isinstance(s.failed[0][1], OutOfBlocks)


def _drive(sched_mod, pager_mod, seed):
    """A seeded random workload through one scheduler: submissions,
    admissions, decode growth (with preemption), finishes.  Returns the
    trace of observable state after every round."""
    rng = np.random.RandomState(seed)
    pager = _pager(num_blocks=12, block_size=4, mod=pager_mod)
    s = sched_mod.Scheduler(pager, max_active=4, prefill_token_budget=24)
    trace, next_id = [], 0
    for _ in range(60):
        for _ in range(rng.randint(0, 3)):
            s.submit(_req(next_id, int(rng.randint(1, 20)),
                          int(rng.randint(1, 12)), mod=sched_mod))
            next_id += 1
        admitted = s.admit()
        for r in admitted:
            r.context_len = int(r.prefill_tokens.shape[0])
            r.generated.append(int(rng.randint(0, 256)))
        for r in list(s.running):
            if r not in s.running:
                continue
            if len(r.generated) >= r.max_new_tokens:
                s.finish(r)
                continue
            try:
                s.grow(r)
            except pager_mod.OutOfBlocks as e:
                s.fail_running(r, e)
                continue
            r.context_len += 1
            r.generated.append(int(rng.randint(0, 256)))
        pager.check_invariants()
        trace.append((
            [r.req_id for r in admitted],
            [(r.req_id, r.context_len, pager.table(r.req_id))
             for r in s.running],
            [(r.req_id, r.preemptions) for r in s.waiting],
            [r.req_id for r, _ in s.failed], pager.free_blocks))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_and_pager_match_jax_on_random_workload(seed):
    want = _drive(jsched, jkv, seed)
    got = _drive(sys.modules[Scheduler.__module__],
                 sys.modules[KVPager.__module__], seed)
    assert got == want
    assert any(p for _, _, waiting, _, _ in want for _, p in waiting), \
        "the workload was sized to preempt"


# ---------------------------------------------------------------------------
# import hygiene: the port loads neither jax nor the JAX package
# ---------------------------------------------------------------------------

def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import horovod_tpu_torch, horovod_tpu_torch.serving\n"
            "import horovod_tpu_torch.models.llama\n"
            "import horovod_tpu_torch.ops.flash_attention\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m.split('.')[0] == 'horovod_tpu')\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


_BAD_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|jaxlib|horovod_tpu)\b(?!_torch)"
    r"|from\s+(?:jax|jaxlib|horovod_tpu)\b(?!_torch))", re.M)


def test_port_sources_import_no_jax():
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    bad = [f"{f.relative_to(REPO)}: {m.group(0).strip()}" for f in files
           for m in _BAD_IMPORT.finditer(f.read_text())]
    assert bad == []
    assert _BAD_IMPORT.search("import jax.numpy as jnp")
    assert _BAD_IMPORT.search("    from horovod_tpu.ops import x")
    assert not _BAD_IMPORT.search("from horovod_tpu_torch import serving")

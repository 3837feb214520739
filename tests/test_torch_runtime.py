"""Port parity: ``horovod_tpu_torch``'s config, runtime and native shim.

- **Config** (the cases of ``tests/test_basics.py``): env parsing,
  precedence, a bad env value, yaml and an unknown yaml key, each held
  field by field against the JAX package's ``Config`` for the same env;
  every knob whose feature is not ported raises at ``init``; the
  collective data plane's knobs are accepted and, at one rank, inert.
- **Runtime**, at one rank in this process on the CPU (Gloo): double
  init, the not-initialized error, shutdown and a second init, the
  capability queries; and at two ranks in subprocesses
  (``tests/mp_torch_port_worker.py``, mode ``runtime``): rank, size and
  host layout, barrier, object broadcast and gather, a process set, and a
  shutdown and second init in the same processes.
- **Native shim**: the core cases of ``tests/test_native.py`` (KV store,
  controller negotiation, stall attribution, join) through the port's
  ctypes shim and the JAX package's, which must agree; and the shim's
  build of the core into its own directory, never into ``native/``.
- **Imports**: ``import horovod_tpu_torch`` and ``init()`` in a fresh
  interpreter leave ``jax`` out of ``sys.modules``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import mp_torch_port_worker as W
from horovod_tpu import _native as ref_native
from horovod_tpu import config as ref_config
from horovod_tpu_torch import _native as port_native
from horovod_tpu_torch import config as port_config

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def _same_config(port_cfg, ref_cfg) -> None:
    assert [f.name for f in dataclasses.fields(port_cfg)] == \
        [f.name for f in dataclasses.fields(ref_cfg)]
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)


ENVS = {
    "parsing": {"HVDTPU_FUSION_THRESHOLD": "1048576",
                "HOROVOD_CYCLE_TIME": "2.5", "HOROVOD_AUTOTUNE": "1",
                "HVDTPU_LOG_LEVEL": "debug"},
    "precedence": {"HOROVOD_FUSION_THRESHOLD": "111",
                   "HVDTPU_FUSION_THRESHOLD": "222"},
    "launcher": {"HVDTPU_CROSS_RANK": "1", "HVDTPU_CROSS_SIZE": "2",
                 "HVDTPU_LOCAL_RANK": "0",
                 "HVDTPU_CONTROLLER_ADDR": "10.0.0.1:1234",
                 "HOROVOD_TPU_STALL_CHECK_DISABLE": "1",
                 "HOROVOD_TIMELINE": "/tmp/tl.json",
                 "HVDTPU_PLATFORM": "CPU"},
    "empty": {},
}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_config_from_env_matches_reference(monkeypatch, env):
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    _same_config(port_config.from_env(), ref_config.from_env())
    if env == "precedence":
        assert port_config.from_env().fusion_threshold == 222


@pytest.mark.parametrize("knob,value", [
    ("FUSION_THRESHOLD", "not-a-number"), ("CYCLE_TIME", "fast"),
    ("AUTOTUNE", "maybe"), ("SCHED_MODE", "bogus"),
    ("WIRE_PRECISION", "int4"), ("CROSS_SIZE", "two")])
def test_config_bad_env_raises_in_both(monkeypatch, knob, value):
    monkeypatch.setenv(f"HVDTPU_{knob}", value)
    with pytest.raises(ValueError):
        ref_config.from_env()
    with pytest.raises(ValueError, match=knob):
        port_config.from_env()


def test_config_yaml_matches_reference(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("# comment\nfusion_threshold: 2097152\n"
                 "cycle-time-ms: 7.5\nautotune: true\nlog_level: info\n"
                 "stall_check: false\ntimeline: /tmp/x.json\n")
    cfg = port_config.from_yaml(str(p))
    _same_config(cfg, ref_config.from_yaml(str(p)))
    assert (cfg.fusion_threshold, cfg.cycle_time_ms, cfg.autotune,
            cfg.stall_check) == (2097152, 7.5, True, False)


def test_config_yaml_unknown_key(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("no_such_knob: 1\n")
    for mod in (ref_config, port_config):
        with pytest.raises(ValueError, match="unknown knob"):
            mod.from_yaml(str(p))


_NOT_PORTED = {
    "hierarchical_allreduce": True, "hierarchical_allgather": True,
    "hierarchical_local_size": 4, "hierarchical_cross_precision": "int8"}
# Knobs refused until their features were ported: the compiled schedule,
# elastic and autoscale.  Accepted at init, and inert at one rank.
_LATER_PORTED = {"sched_mode": "compiled", "elastic": True,
                 "autoscale": True}
# Knobs of the collective data plane, refused until it was ported.
_DATAPLANE_KNOBS = {"wire_precision": "int8", "quant_block_size": 64,
                    "quant_min_bytes": 0, "sched_mode": "decomposed",
                    "sched_chunks": 2, "bucket_bytes": 1 << 20,
                    "zero": True}
# Knobs of the observability plane, refused until it was ported, and the
# module each one arms at init.
_OBS_KNOBS = {"autotune": (True, "engine"),
              "slo": ("ttft=p99(ttft) < 250ms", "slo"),
              "alerts": ("x: hvd_engine_queue_depth > 1 : warn", "alerts")}


def test_not_ported_table_is_complete():
    assert set(_NOT_PORTED) == set(port_config._NOT_PORTED)
    assert not set(_OBS_KNOBS) & set(port_config._NOT_PORTED)


@pytest.mark.parametrize("knob", sorted(_OBS_KNOBS))
def test_obs_knob_is_accepted_at_init(monkeypatch, knob):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs import alerts, slo
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    value, armed = _OBS_KNOBS[knob]
    hvd.init(config=port_config.Config(platform="cpu", **{knob: value}))
    try:
        if armed == "engine":
            assert hvd.global_state().engine._autotuner is not None
        elif armed == "slo":
            assert slo.status()["ttft"]["objective"] == 0.99
        else:
            assert [a["alert"] for a in alerts.status()["alerts"]] == ["x"]
    finally:
        hvd.shutdown()
    assert slo.status() == {} and alerts.status() is None


@pytest.mark.parametrize("knob", sorted(_DATAPLANE_KNOBS))
def test_dataplane_knob_is_accepted_at_init(monkeypatch, knob):
    """Accepted, and inert at one rank as in the reference: an allreduce
    comes back whole, no schedule is walked, no wire byte saved, and the
    wire-mode gauge names the configured default."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import reduction
    from horovod_tpu_torch.ops.sched import executor
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    value = _DATAPLANE_KNOBS[knob]
    hvd.init(config=port_config.Config(platform="cpu", **{knob: value}))
    try:
        assert getattr(hvd.global_state().config, knob) == value
        before = (executor._m_sched.total(), reduction._m_wire_saved.total())
        x = torch.arange(70000, dtype=torch.float32)
        assert torch.equal(hvd.allreduce(x, name="k"), x)
        assert torch.equal(hvd.allreduce(x, name="q", compression="int8"), x)
        assert (executor._m_sched.total(),
                reduction._m_wire_saved.total()) == before
        mode = hvd.global_state().config.wire_precision
        assert reduction._m_wire_mode.labels(mode=mode).value == 1.0
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("knob", sorted({**_NOT_PORTED, **_LATER_PORTED}))
def test_unported_knob_raises_at_init(monkeypatch, knob):
    """The hierarchical knobs still raise, naming 'Hierarchy'; the knobs
    of the features ported since are accepted (inert at one rank: an
    allreduce comes back whole and no compiled schedule runs)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.sched import compiled
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    value = {**_NOT_PORTED, **_LATER_PORTED}[knob]
    cfg = port_config.Config(platform="cpu", **{knob: value})
    if knob in _NOT_PORTED:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP section A 'Hierarchy'"):
            hvd.init(config=cfg)
        assert not hvd.is_initialized()
        return
    hvd.init(config=cfg)
    try:
        assert getattr(hvd.global_state().config, knob) == value
        before = compiled._m_compiled.total()
        x = torch.arange(70000, dtype=torch.float32)
        assert torch.equal(hvd.allreduce(x, name="k"), x)
        assert compiled._m_compiled.total() == before
    finally:
        hvd.shutdown()


def test_not_ported_items_name_roadmap_titles():
    """Each refusal names its ROADMAP section A item by a title that is
    there, so a renumbering cannot stale the messages."""
    import re
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        titles = set(re.findall(r"^\d+\. \*\*(.+?)\*\*", fh.read(), re.M))
    for field, item in port_config._NOT_PORTED.items():
        assert item.startswith("'") and item.endswith("'"), (field, item)
        assert item[1:-1] in titles, (field, item, sorted(titles))


# ---------------------------------------------------------------------------
# runtime at one rank, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(monkeypatch):
    import horovod_tpu_torch as hvd
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    hvd.init(config=hvd.Config(platform="cpu"))
    yield hvd
    hvd.shutdown()


def test_one_rank_runtime(one_rank):
    import torch.distributed as dist
    hvd = one_rank
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
            hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
    assert dist.get_backend() == "gloo" and hvd.gloo_enabled()
    assert hvd.device() == torch.device("cpu")
    assert not hvd.global_state().engine.distributed
    x = torch.arange(4.0)
    assert torch.equal(hvd.allreduce(x), x)
    assert hvd.join() == 0


def test_double_init_is_noop(one_rank):
    hvd = one_rank
    engine = hvd.global_state().engine
    hvd.init(config=hvd.Config(platform="cpu"))
    assert hvd.global_state().engine is engine and hvd.size() == 1


def test_not_initialized_error():
    import horovod_tpu_torch as hvd
    assert not hvd.is_initialized()
    for fn in (hvd.rank, hvd.size, hvd.local_size, hvd.cross_rank,
               lambda: hvd.allreduce(torch.ones(1)),
               lambda: hvd.add_process_set([0])):
        with pytest.raises(hvd.NotInitializedError, match="init"):
            fn()


def test_shutdown_then_init_again(one_rank):
    import torch.distributed as dist
    hvd = one_rank
    hvd.shutdown()
    assert not hvd.is_initialized() and not dist.is_initialized()
    hvd.init(config=hvd.Config(platform="cpu"))
    assert torch.equal(hvd.allreduce(torch.ones(3), hvd.Sum), torch.ones(3))


def test_tensor_on_another_device_raises(one_rank):
    with pytest.raises(ValueError, match="runtime on cpu"):
        one_rank.allreduce(torch.ones(2, device="meta"))


def test_cuda_default_without_a_card_raises(monkeypatch):
    import horovod_tpu_torch as hvd
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()


def test_capabilities_tell_the_truth():
    import horovod_tpu_torch as hvd
    assert hvd.cuda_built() == (torch.version.cuda is not None)
    assert hvd.gloo_built()
    assert hvd.native_built()
    assert hvd.nccl_built() == 0 or torch.cuda.is_available() or \
        torch.distributed.is_nccl_available()
    assert not (hvd.mpi_built() or hvd.xla_built() or hvd.rocm_built())


# ---------------------------------------------------------------------------
# runtime at two ranks, in subprocesses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("runtime")
    res = W.launch("runtime", str(out), timeout=120)
    for rc, text in res:
        assert rc == 0, text
    ranks = []
    for r in range(W.NP):
        with np.load(out / f"runtime.rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        ranks.append((arrays, json.loads(
            (out / f"runtime.rank{r}.json").read_text())))
    return ranks


def test_two_rank_layout(two_ranks):
    for r, (_, info) in enumerate(two_ranks):
        assert (info["rank"], info["size"], info["local_rank"]) == (r, 2, r)
        # both ranks on this host
        assert (info["local_size"], info["cross_rank"],
                info["cross_size"]) == (2, 0, 1)
        assert (info["backend"], info["device"]) == ("gloo", "cpu")
        assert info["gloo_enabled"]
        assert info["distributed"] and not info["jax_loaded"]


def test_two_rank_objects_and_sets(two_ranks):
    for r, (_, info) in enumerate(two_ranks):
        assert info["object"] == {"from": 1, "x": [1, 1, 1]}
        assert info["objects"] == [["rank", 0], ["rank", 1]]
        assert info["set"] == [1, r == 1, 1]


def test_two_rank_job_holds_the_launchers_env(two_ranks):
    """The launcher's env reached both ranks, the job's secret among it,
    so the control plane of this run was the authenticated one."""
    for _, info in two_ranks:
        assert info["launcher_env"] == sorted(
            ["HVDTPU_SECRET", "HVDTPU_CONTROLLER_ADDR",
             "HVDTPU_RENDEZVOUS_ADDR", "HVDTPU_COORDINATOR_ADDR",
             "HVDTPU_LOCAL_RANK", "HVDTPU_PLATFORM"])


def test_two_rank_reinit(two_ranks):
    for arrays, _ in two_ranks:
        np.testing.assert_array_equal(arrays["after_reinit"],
                                      np.full((3,), 3.0, np.float32))


# ---------------------------------------------------------------------------
# native shim: the same scenario through both packages' shims
# ---------------------------------------------------------------------------

def _threads(fns) -> list:
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()
    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    return out


def _round(clients, subs, joined=()):
    barrier = threading.Barrier(len(clients))

    def go(r):
        barrier.wait()
        res = clients[r].negotiate(subs.get(r, []), joined=r in joined)
        return (res.ready, res.stalled, dict(res.metas), res.all_joined,
                res.last_join_rank, sorted(res.join_covered),
                {k: (list(v.missing_ranks), v.age_ms >= 100)
                 for k, v in res.stall_info.items()})
    return _threads([lambda r=r: go(r) for r in range(len(clients))])


def _kv(N):
    with N.KvServer() as srv:
        a = N.KvClient("127.0.0.1", srv.port)
        b = N.KvClient("127.0.0.1", srv.port)
        a.set("rank/0/addr", b"10.0.0.1:1234")
        out = [a.wait("rank/0/addr"), a.get("nonexistent")]
        big = bytes(range(256)) * 4096
        a.set("big", big)
        out.append(b.wait("big") == big)
        a.delete("big")
        out.append(b.get("big"))
        late = _threads([lambda: b.wait("late", timeout_ms=5000),
                         lambda: (time.sleep(0.2), a.set("late", b"hi"))])
        out.append(late[0])
        try:
            a.wait("never", timeout_ms=100)
        except TimeoutError:
            out.append("timeout")
        a.close()
        b.close()
    return out


def _negotiate(N, size, rounds, joined_rounds=(), stall_warn_ms=60000):
    with N.ControllerServer(size=size, stall_warn_ms=stall_warn_ms) as srv:
        clients = [N.ControllerClient("127.0.0.1", srv.port, r)
                   for r in range(size)]
        out = []
        for i, subs in enumerate(rounds):
            out.append(_round(clients, subs,
                              joined_rounds[i] if joined_rounds else ()))
            time.sleep(0.15 if stall_warn_ms < 1000 else 0)
        out.append(clients[0].cache_size)
        for c in clients:
            c.close()
    return out


SCENARIOS = {
    "kv": _kv,
    "all_ready": lambda N: _negotiate(
        N, 4, [{r: ["grad.a", "grad.b"] for r in range(4)}]),
    "waits_for_all_ranks": lambda N: _negotiate(N, 4, [
        {0: ["grad.x"], 1: ["grad.x"], 2: ["grad.x"]},
        {3: ["grad.x"]}]),
    # The agreed order depends on which submission lands first, so two
    # runs may differ; what holds is one order on every rank.
    "order_identical": lambda N: [
        (len({tuple(ready) for ready, *_ in rnd}) == 1,
         sorted(rnd[0][0])) for rnd in _negotiate(N, 3, [{
             0: ["t.a", "t.b", "t.c"], 1: ["t.c", "t.a", "t.b"],
             2: ["t.b", "t.c", "t.a"]}])[:1]],
    "cache_fast_path": lambda N: _negotiate(
        N, 2, [{0: ["g.1", "g.2"], 1: ["g.1", "g.2"]}] * 2),
    "stall_attribution": lambda N: _negotiate(
        N, 2, [{0: ["grad.s"]}, {}], stall_warn_ms=100),
    "join_with_metadata": lambda N: _negotiate(
        N, 2, [{0: [("grad.a", '{"v":"allreduce"}')]}], [{1}]),
    "join_all_joined": lambda N: _negotiate(
        N, 3, [{}, {}, {}, {r: ["t.next"] for r in range(3)}],
        [{2}, {0, 2}, {0, 1, 2}, ()]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_native_shim_matches_reference(scenario):
    got = SCENARIOS[scenario](port_native)
    assert got == SCENARIOS[scenario](ref_native)
    if scenario == "kv":
        assert got[0] == b"10.0.0.1:1234"
    elif scenario == "order_identical":
        assert got == [(True, ["t.a", "t.b", "t.c"])]


def test_native_shim_builds_outside_native(tmp_path, monkeypatch):
    """With the tracked library older than its source, the shim compiles
    the source (the Makefile's flags) into its build directory; nothing
    under ``native/`` changes.  (``native/.build.lock`` is left out: the
    JAX package's own shim takes that lock, maybe in another test
    process at the same time.)"""
    def listing():
        return {p.name: p.stat().st_mtime_ns
                for p in (REPO / "native").iterdir()
                if p.name != ".build.lock"}
    before = listing()
    src = tmp_path / "native" / "hvdtpu_core.cc"
    src.parent.mkdir()
    shutil.copy2(REPO / "native" / "hvdtpu_core.cc", src)
    stale = tmp_path / "native" / "libhvdtpu_core.so"
    stale.write_bytes(b"stale")
    os.utime(stale, ns=(0, 0))
    monkeypatch.setattr(port_native, "_SRC", str(src))
    monkeypatch.setattr(port_native, "_TRACKED_SO", str(stale))
    monkeypatch.setenv("HOROVOD_TPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
    path = port_native._so_path()
    assert path == str(tmp_path / "b" / "native" / "libhvdtpu_core.so")
    code = ("import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
            "print(bool(lib.hvd_kv_server_start))")
    res = subprocess.run([sys.executable, "-c", code, path],
                         capture_output=True, text=True, timeout=60)
    assert res.stdout.strip() == "True", res.stderr
    assert port_native._so_path() == path          # current: no rebuild
    assert listing() == before


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def test_init_loads_no_jax():
    code = ("import sys\n"
            "import horovod_tpu_torch as hvd\n"
            "hvd.init(config=hvd.Config(platform='cpu'))\n"
            "import torch\n"
            "hvd.allreduce(torch.ones(2))\n"
            "hvd.shutdown()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m.split('.')[0] == 'horovod_tpu')\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout

"""Port parity: elastic training (``horovod_tpu_torch/elastic/``,
``runner/elastic.py``, the launcher's elastic flags, ``utils/checkpoint.py``).

After the reference's ``tests/test_elastic.py``, the blacklist cases of
``tests/test_chaos.py`` and the elastic launcher cases of
``tests/test_runner.py:285-460``.  In this process: the state objects and
the ``run`` protocol (restore + reinit + ``on_reset`` on a failure, sync on
a membership change, the reserved exit codes under the driver), the
driver's assignment, blacklist (cooldown, doubling, probation) and
supervision held against the JAX package's driver on the same discovery
sequences, ``ElasticSampler``'s index sequence against the JAX package's,
and ``TorchState`` and ``Checkpointer`` round-tripping a tiny Llama's
parameters and Adam state bitwise.  Then the launcher end to end on the
CPU through ``tests/mp_torch_elastic_worker.py``: kill, blacklist and
relaunch; growth onto a new host; a checkpointed job across world sizes
whose every loss equals the uninterrupted run's bitwise.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mp_torch_elastic_worker as EW
from horovod_tpu.elastic import sampler as ref_sampler
from horovod_tpu.runner import elastic as ref_elastic
from horovod_tpu_torch.elastic import (
    ElasticSampler,
    FileBackedState,
    HorovodInternalError,
    HostsUpdatedInterrupt,
    ObjectState,
    TorchState,
    run,
)
from horovod_tpu_torch.models import llama
from horovod_tpu_torch.runner import elastic as port_elastic
from horovod_tpu_torch.runner import launch as port_launch
from horovod_tpu_torch.runner.hosts import HostSlots
from horovod_tpu_torch.utils.checkpoint import Checkpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_torch_elastic_worker.py")


@pytest.fixture
def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)


# ---------------------------------------------------------------------------
# state objects
# ---------------------------------------------------------------------------

def test_object_state_commit_restore():
    s = ObjectState(epoch=0, best=1.5)
    s.epoch, s.best = 7, 0.2
    s.restore()                       # nothing committed since init
    assert s.epoch == 0 and s.best == 1.5
    s.epoch = 3
    s.commit()
    s.epoch = 9
    s.restore()
    assert s.epoch == 3


def test_file_backed_state_resumes_from_its_file(tmp_path):
    path = str(tmp_path / "state.json")
    s = FileBackedState(path, step=0, w=0.5)
    assert not s.resumed
    s.step = 4
    s.commit()
    assert json.load(open(path)) == {"step": 4, "w": 0.5}
    again = FileBackedState(path, step=0, w=0.0)
    assert again.resumed and (again.step, again.w) == (4, 0.5)


def _tiny_llama():
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    adam = torch.optim.Adam(llama.trainable(params), lr=1e-2)
    step = llama.make_train_step(cfg, adam)
    tokens = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, 17))).long()
    return cfg, params, adam, step, {"tokens": tokens}


def _snapshot(params, adam):
    leaves = {f"p.{i}": t.detach().clone()
              for i, t in enumerate(llama.trainable(params))}
    for gi, g in enumerate(adam.param_groups):
        for pi, p in enumerate(g["params"]):
            for k, v in adam.state.get(p, {}).items():
                leaves[f"s.{gi}.{pi}.{k}"] = torch.as_tensor(v).clone()
    return leaves


def _bitwise(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def test_torch_state_restores_a_tiny_llama_and_adam_in_place():
    """Commit after two Adam steps, take two more, restore: every leaf
    and every Adam moment bitwise back, in the same tensors (the
    optimizer's references stay live), and training from there repeats
    the committed run's losses exactly."""
    _, params, adam, step, batch = _tiny_llama()
    for _ in range(2):
        step(params, batch)
    state = TorchState(optimizer=adam, params=params, epoch=2)
    committed = _snapshot(params, adam)
    ids = [id(t) for t in llama.trainable(params)]
    moments = [id(v) for st in adam.state.values() for v in st.values()]
    after = [float(step(params, batch)) for _ in range(2)]
    state.epoch = 9
    assert not _bitwise(_snapshot(params, adam), committed)
    state.restore()
    assert state.epoch == 2
    assert _bitwise(_snapshot(params, adam), committed)
    # restored in place: the leaves and Adam's state tensors are the same
    # objects (nothing reallocated, every reference still valid)
    assert [id(t) for t in llama.trainable(params)] == ids
    assert [id(v) for st in adam.state.values() for v in st.values()] == \
        moments
    assert [float(step(params, batch)) for _ in range(2)] == after


def test_torch_state_with_a_module_and_its_optimizer():
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    state = TorchState(model=model, optimizer=opt, batch=1)
    w = model.weight.detach().clone()
    mom = opt.state[model.weight]["momentum_buffer"].clone()
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    state.batch = 5
    state.restore()
    assert torch.equal(model.weight, w) and state.batch == 1
    assert torch.equal(opt.state[model.weight]["momentum_buffer"], mom)
    assert state.model is model and state.optimizer is opt


def test_torch_state_sync_broadcasts_at_one_rank(clean_env):
    import horovod_tpu_torch as hvd
    hvd.init(config=hvd.Config(platform="cpu"))
    try:
        _, params, adam, step, batch = _tiny_llama()
        step(params, batch)
        state = TorchState(optimizer=adam, params=params, epoch=1)
        before = _snapshot(params, adam)
        state.sync()
        assert _bitwise(_snapshot(params, adam), before)
        assert state.epoch == 1
    finally:
        hvd.shutdown()


def test_checkpointer_round_trips_a_tiny_llama_and_adam(tmp_path):
    _, params, adam, step, batch = _tiny_llama()
    for _ in range(2):
        step(params, batch)
    committed = _snapshot(params, adam)
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    ckpt.save(2, {"params": params, "adam": adam.state_dict(), "step": 2})
    losses = [float(step(params, batch)) for _ in range(2)]
    ckpt.save(4, {"params": params, "adam": adam.state_dict(), "step": 4},
              wait=False)
    ckpt.wait_until_finished()
    assert ckpt.all_steps() == [2, 4] and ckpt.latest_step() == 4
    tree = Checkpointer(str(tmp_path / "ck"), read_only=True).restore(
        2, target={"params": params})
    with torch.no_grad():
        for k, v in tree["params"]["layers"].items():
            params["layers"][k].copy_(v)
        for k in ("embed", "final_norm", "lm_head"):
            params[k].copy_(tree["params"][k])
    adam.load_state_dict(tree["adam"])
    assert tree["step"] == 2
    assert _bitwise(_snapshot(params, adam), committed)
    assert [float(step(params, batch)) for _ in range(2)] == losses


def test_checkpointer_prunes_hides_tmp_and_spares_a_writers_tmp(tmp_path):
    d = tmp_path / "ck"
    ckpt = Checkpointer(str(d), max_to_keep=2)
    for s in (1, 2, 3):
        ckpt.save(s, {"x": torch.full((3,), float(s))})
    assert ckpt.all_steps() == [2, 3]
    (d / "4.tmp-999").mkdir()           # a writer's save in flight
    (d / "4.tmp-999" / "tree.pt").write_bytes(b"partial")
    reader = Checkpointer(str(d), read_only=True)
    assert reader.latest_step() == 3     # never the half-written step
    assert (d / "4.tmp-999").exists()    # a reader sweeps nothing
    assert torch.equal(reader.restore()["x"], torch.full((3,), 3.0))
    Checkpointer(str(d))                 # a writer sweeps stale tmps
    assert not (d / "4.tmp-999").exists()
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore()


def test_checkpointer_writes_on_rank_0_only(clean_env, tmp_path,
                                            monkeypatch):
    from horovod_tpu_torch import context
    monkeypatch.setattr(context, "is_initialized", lambda: True)
    monkeypatch.setattr(context, "rank", lambda: 1)
    Checkpointer(str(tmp_path / "a")).save(1, {"x": torch.ones(1)})
    assert Checkpointer(str(tmp_path / "a")).all_steps() == []
    Checkpointer(str(tmp_path / "b"), single_process=True).save(
        1, {"x": torch.ones(1)})
    assert Checkpointer(str(tmp_path / "b")).all_steps() == [1]


# ---------------------------------------------------------------------------
# the run protocol
# ---------------------------------------------------------------------------

def test_run_retries_on_internal_error(monkeypatch, clean_env):
    calls = {"n": 0, "restored": 0, "reset": 0}

    class S(ObjectState):
        def restore(self):
            calls["restored"] += 1
            super().restore()

    state = S(step=0)
    state.register_reset_callbacks([lambda: calls.__setitem__(
        "reset", calls["reset"] + 1)])
    monkeypatch.setattr("horovod_tpu_torch.elastic.runner._reinitialize",
                        lambda: None)

    @run
    def train(st):
        calls["n"] += 1
        if calls["n"] < 3:
            raise HorovodInternalError("peer died")
        return "done"

    assert train(state) == "done"
    assert (calls["n"], calls["restored"], calls["reset"]) == (3, 2, 2)


def test_run_syncs_on_hosts_updated(clean_env):
    calls = {"n": 0, "synced": 0}

    class S(ObjectState):
        def sync(self):
            calls["synced"] += 1
            self.save()

    state = S(step=0)

    @run
    def train(st):
        calls["n"] += 1
        if calls["n"] == 1:
            raise HostsUpdatedInterrupt("new host")
        return st.step

    assert train(state) == 0 and calls["synced"] == 1


@pytest.mark.parametrize("exc,code", [
    (HorovodInternalError("peer died"), port_launch.VICTIM_EXIT_CODE),
    (HostsUpdatedInterrupt("grown"), port_launch.RESTART_EXIT_CODE)])
def test_run_exits_with_the_reserved_codes_under_the_driver(
        monkeypatch, clean_env, exc, code):
    from horovod_tpu.runner import launch as ref_launch
    assert (port_launch.RESTART_EXIT_CODE, port_launch.VICTIM_EXIT_CODE) == \
        (ref_launch.RESTART_EXIT_CODE, ref_launch.VICTIM_EXIT_CODE)
    monkeypatch.setenv("HVDTPU_ELASTIC", "1")

    @run
    def train(st):
        raise exc

    with pytest.raises(SystemExit) as ei:
        train(ObjectState(step=0))
    assert ei.value.code == code


def test_run_reinitializes_the_runtime_in_process(clean_env):
    """A real failure at one rank: an injected ``dispatch`` error raises
    ``HorovodInternalError``; ``run`` shuts the runtime down, starts it
    again with the same knobs (a new engine), restores and retries."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import chaos
    hvd.init(config=hvd.Config(platform="cpu", cycle_time_ms=2.0))
    chaos.arm("dispatch:err:after=1:times=1")
    try:
        engines = []
        state = ObjectState(step=0)

        @run
        def train(st):
            engines.append(hvd.global_state().engine)
            for s in range(st.step, 3):
                hvd.allreduce(torch.ones(2), hvd.Sum, name=f"r.{s}")
                st.step = s + 1
                st.commit()
            return st.step

        assert train(state) == 3
        assert len(engines) == 2 and engines[0] is not engines[1]
        assert hvd.global_state().config.cycle_time_ms == 2.0
    finally:
        chaos.disarm()
        hvd.shutdown()


# ---------------------------------------------------------------------------
# the driver, against the JAX package's
# ---------------------------------------------------------------------------

def _both(spec_seq, **kw):
    return [mod.ElasticDriver(mod.FixedDiscovery(*spec_seq), **kw)
            for mod in (ref_elastic, port_elastic)]


def test_driver_assignment_epoch_and_caps_match_the_reference():
    for specs, kw in ((("a:2,b:2",), dict(min_np=2)),
                      (("a:4,b:4",), dict(min_np=1, max_np=3)),
                      (("a:2", "a:2,b:2"), dict(min_np=1)),
                      (("a:1,b:3,c:2",), dict(min_np=2, max_np=5))):
        ref, port = _both(specs, poll_interval_s=0.01, **kw)
        for d in (ref, port):
            d.wait_for_available_slots(timeout_s=5)
            d.poll_hosts()
        assert port.assignment() == ref.assignment()
        assert port.membership_epoch == ref.membership_epoch
        port.target_np = ref.target_np = 1
        assert port.assignment() == ref.assignment()


def test_driver_blacklist_decay_matches_the_reference():
    clock = {"t": 0.0}
    ref, port = _both(("a:2,b:2",), min_np=1, blacklist_cooldown_s=10.0,
                      blacklist_max_cooldown_s=25.0,
                      clock=lambda: clock["t"])
    script = [(0.0, "a"), (9.9, None), (10.1, None), (11.0, "a"),
              (30.0, None), (32.0, None), (32.0, "a"), (56.0, None),
              (58.0, None)]
    for t, host in script:
        clock["t"] = t
        for d in (ref, port):
            if host:
                d.blacklist(host)
        assert port.blacklisted() == ref.blacklisted(), t
        assert port.blacklist_failures("a") == ref.blacklist_failures("a")
        for d in (ref, port):
            d.poll_hosts()
        assert port.assignment() == ref.assignment(), t


def test_blacklist_zero_cooldown_is_permanent():
    clock = {"t": 0.0}
    d = port_elastic.ElasticDriver(
        port_elastic.FixedDiscovery("a:2,b:2"), min_np=1,
        blacklist_cooldown_s=0.0, clock=lambda: clock["t"])
    d.blacklist("a")
    clock["t"] = 1e9
    assert d.blacklisted() == {"a"}


def test_wait_for_slots_survives_discovery_failures_then_times_out():
    class Flaky(port_elastic.HostDiscovery):
        def __init__(self, fails):
            self.calls, self.fails = 0, fails

        def find_available_hosts(self):
            self.calls += 1
            if self.calls <= self.fails:
                raise RuntimeError("discovery script crashed")
            from horovod_tpu_torch.runner.hosts import parse_hosts
            return parse_hosts("a:2")

    d = port_elastic.ElasticDriver(Flaky(2), min_np=2, poll_interval_s=0.01)
    assert [h.hostname for h in d.wait_for_available_slots(timeout_s=10)] \
        == ["a"]
    assert d._discovery.calls == 3
    dead = port_elastic.ElasticDriver(Flaky(10 ** 9), min_np=1,
                                      poll_interval_s=0.01)
    with pytest.raises(TimeoutError, match="last discovery error"):
        dead.wait_for_available_slots(timeout_s=0.2)


def test_driver_run_job_relaunches_and_blacklists():
    for mod in (ref_elastic, port_elastic):
        d = mod.ElasticDriver(mod.FixedDiscovery("a:2,b:2"), min_np=1,
                              poll_interval_s=0.01)
        attempts = []

        def fake_launcher(cmd, hosts, env):
            attempts.append([h.hostname for h in hosts])
            assert env["HVDTPU_ELASTIC"] == "1"
            if len(attempts) == 1:
                d.blacklist("b")     # the monitor saw b's worker die
                return 1
            return 0

        assert d.run_job(["python", "train.py"], launcher=fake_launcher) == 0
        assert attempts == [["a", "b"], ["a"]], mod


def test_script_discovery(tmp_path):
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\necho host1:2\necho host2\n")
    script.chmod(0o755)
    hosts = port_elastic.ScriptDiscovery(
        str(script), default_slots=4).find_available_hosts()
    assert hosts == [HostSlots("host1", 2), HostSlots("host2", 4)]


@pytest.mark.parametrize("exited,want", [
    ([(0, port_launch.VICTIM_EXIT_CODE), (1, 17)],
     [(1, 17), (0, port_launch.VICTIM_EXIT_CODE)]),
    ([(0, port_launch.RESTART_EXIT_CODE), (2, port_launch.VICTIM_EXIT_CODE),
      (3, 1)],
     [(3, 1), (0, port_launch.RESTART_EXIT_CODE),
      (2, port_launch.VICTIM_EXIT_CODE)]),
    ([(1, 17), (0, port_launch.VICTIM_EXIT_CODE)],
     [(1, 17), (0, port_launch.VICTIM_EXIT_CODE)]),
    ([(0, 0), (1, 0)], [(0, 0), (1, 0)]),
])
def test_blame_order_puts_a_culprit_before_victims(exited, want):
    """One monitor pass that saw a victim (or a restart) before the
    culprit takes the culprit first; otherwise rank order."""
    assert port_launch.blame_order(exited) == want


def test_a_culprits_exit_outranks_a_victims_in_one_pass(tmp_path):
    """Rank 1 fails (17); rank 0, a victim, exits with the victim code
    only after rank 1's exit (it waits for rank 1's file, then 0.5 s).
    Whether the monitor sees both exits in one pass (where
    :func:`blame_order` puts the culprit first) or rank 1's alone first,
    the launcher blames rank 1 and its host (the reference's rank-order
    scan of one pass blames the victim, whose code spares every host)."""
    flag = tmp_path / "culprit_exited"
    script = ("import os, sys, time\n"
              "r = int(os.environ['HVDTPU_CROSS_RANK'])\n"
              f"flag = {str(flag)!r}\n"
              "if r == 1:\n"
              "    open(flag, 'w').close()\n"
              "    sys.exit(17)\n"
              "while not os.path.exists(flag):\n"
              "    time.sleep(0.01)\n"
              "time.sleep(0.5)\n"
              f"sys.exit({port_launch.VICTIM_EXIT_CODE})\n")
    info: dict = {}
    code = port_launch.launch_workers(
        [sys.executable, "-c", script], np_total=2,
        hosts_spec="localhost:1,127.0.0.1:1", failure_info=info,
        extra_env={"HVDTPU_PLATFORM": "cpu"})
    assert code == 17 and info == {"rank": 1, "host": "127.0.0.1",
                                   "code": 17}


# ---------------------------------------------------------------------------
# ElasticSampler, against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shuffle", [(0, True), (5, True), (3, False)])
def test_elastic_sampler_sequence_is_the_references(seed, shuffle):
    for n, size in ((37, 1), (37, 2), (100, 3), (64, 4)):
        for r in range(size):
            a = ElasticSampler(n, shuffle=shuffle, seed=seed)
            b = ref_sampler.ElasticSampler(n, shuffle=shuffle, seed=seed)
            for s in (a, b):
                s.set_rank_size(r, size)
            assert list(a) == list(b)
            done = list(a)[:3]
            for s in (a, b):
                s.record_batch(done)
                s.set_rank_size(0, max(1, size - 1))   # a shrink
            assert list(a) == list(b) and len(a) == len(b)
            for s in (a, b):
                s.set_epoch(1)
            assert list(a) == list(b)
            c = ElasticSampler(n, shuffle=shuffle, seed=seed)
            d = ref_sampler.ElasticSampler(n, shuffle=shuffle, seed=seed)
            c.load_state_dict(a.state_dict())
            d.load_state_dict(b.state_dict())
            assert list(c) == list(d)
            assert c.state_dict() == d.state_dict()


# ---------------------------------------------------------------------------
# the launcher, end to end on the CPU
# ---------------------------------------------------------------------------

def _job_env(tmp_path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({"HVDTPU_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
                "HVDTPU_TEST_STATE": str(tmp_path / "state.json"),
                "HVDTPU_TEST_LOG": str(tmp_path / "train.log")})
    env.update(extra)
    return env


def _discovery(tmp_path, hosts: str):
    hostsfile = tmp_path / "hosts.txt"
    hostsfile.write_text(hosts)
    script = tmp_path / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {hostsfile}\n")
    script.chmod(0o755)
    return hostsfile, str(script)


def _elastic_cmd(script: str, np_: int, min_np: int, max_np: int,
                 mode: str) -> list:
    return [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
            str(np_), "--min-np", str(min_np), "--max-np", str(max_np),
            "--host-discovery-script", script, "--",
            sys.executable, WORKER, mode]


def test_hvdrun_elastic_kill_blacklist_relaunch(tmp_path):
    """np=2 over two "hosts" (localhost and 127.0.0.1, both local); rank
    1 crashes at step 3; the driver blacklists its host, relaunches at
    np=1, and the survivor resumes from the last commit with exact value
    continuity (``w <- size*(w+1)``: 2, 6, 14 at np=2, then 15, 16, 17)."""
    _, script = _discovery(tmp_path, "localhost:1\n127.0.0.1:1\n")
    res = subprocess.run(
        _elastic_cmd(script, 2, 1, 2, "scalar"), capture_output=True,
        text=True, timeout=60, cwd=REPO,
        env=_job_env(tmp_path, HVDTPU_TEST_KILL="1"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "blacklisted host 127.0.0.1" in res.stderr, res.stderr
    lines = (tmp_path / "train.log").read_text().splitlines()
    assert "START rank=0 size=2 resume_step=0 w=0.0" in lines
    assert "CRASH rank=1 step=3" in lines
    assert "START rank=0 size=1 resume_step=3 w=14.0" in lines
    assert "DONE rank=0 size=1 step=6 w=17.0" in lines
    assert json.loads((tmp_path / "state.json").read_text()) == \
        {"step": 6, "w": 17.0}


def test_hvdrun_elastic_grow_uses_new_host(tmp_path):
    """The job starts at np=1; mid-run the discovery file gains a second
    host; the growth watcher bumps the membership epoch, the worker exits
    with the restart code at its next commit, and the driver relaunches
    at np=2, resuming from the last commit (at size 1, w == step)."""
    hostsfile, script = _discovery(tmp_path, "localhost:1\n")
    log = tmp_path / "train.log"
    proc = subprocess.Popen(
        _elastic_cmd(script, 1, 1, 2, "scalar"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=_job_env(tmp_path, HVDTPU_TEST_TOTAL="24",
                     HVDTPU_TEST_STEP_DELAY="0.25"))
    try:
        deadline = time.time() + 40
        while time.time() < deadline:
            if log.exists() and sum(
                    1 for ln in log.read_text().splitlines()
                    if ln.startswith("STEP")) >= 3:
                break
            time.sleep(0.2)
        hostsfile.write_text("localhost:1\n127.0.0.1:1\n")
        out, _ = proc.communicate(timeout=50)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    lines = log.read_text().splitlines()
    assert "START rank=0 size=1 resume_step=0 w=0.0" in lines
    restart = [ln for ln in lines
               if ln.startswith("START rank=0 size=2 resume_step=")]
    assert restart, lines
    resumed = restart[0].split("resume_step=")[1].split()
    assert float(resumed[1].split("=")[1]) == float(resumed[0]) > 0
    assert any(ln.startswith("STEP rank=1 size=2") for ln in lines), lines
    assert any(ln.startswith("DONE rank=0 size=2 step=24") for ln in lines)


def _losses(lines) -> dict:
    out: dict = {}
    for ln in lines:
        if ln.startswith("STEP rank=0 "):
            f = dict(kv.split("=") for kv in ln.split()[1:])
            out[int(f["step"])] = float.fromhex(f["loss"])
    return out


def test_hvdrun_elastic_checkpoint_shrink_keeps_every_loss(tmp_path):
    """np=2 → 1: rank 1 crashes at step 4, the relaunch restores the
    parameters, Adam's moments and the step from the checkpoint, and every
    logged loss equals the uninterrupted single-process run's bitwise."""
    _, script = _discovery(tmp_path, "localhost:1\n127.0.0.1:1\n")
    total = 8
    res = subprocess.run(
        _elastic_cmd(script, 2, 1, 2, "ckpt"), capture_output=True,
        text=True, timeout=60, cwd=REPO,
        env=_job_env(tmp_path, HVDTPU_TEST_KILL="1",
                     HVDTPU_TEST_TOTAL=str(total),
                     HVDTPU_TEST_CKPT=str(tmp_path / "ck")))
    assert res.returncode == 0, res.stdout + res.stderr
    lines = (tmp_path / "train.log").read_text().splitlines()
    assert f"CRASH rank=1 step={EW.KILL_STEP_CKPT}" in lines
    assert f"START rank=0 size=1 resume_step={EW.KILL_STEP_CKPT}" in lines
    got = _losses(lines)
    assert sorted(got) == list(range(total))
    assert [got[s] for s in range(total)] == EW.oracle_losses(total)


@pytest.mark.slow  # as the reference's circle (tests/test_runner.py:535)
def test_hvdrun_elastic_checkpoint_world_size_circle(tmp_path):
    """np=4 → 2 → 4: rank 2 crashes (its 2-slot host is blacklisted), the
    relaunch restores from the checkpoint; mid-run the discovery file
    gains a third host and the job grows back to np=4 with another
    restore.  Every logged loss equals the uninterrupted run's."""
    from horovod_tpu_torch.runner.cluster import local_ip
    my_ip = local_ip()
    assert my_ip not in ("localhost", "127.0.0.1"), my_ip
    hostsfile, script = _discovery(tmp_path, "localhost:2\n127.0.0.1:2\n")
    log = tmp_path / "train.log"
    total = 24
    proc = subprocess.Popen(
        _elastic_cmd(script, 4, 2, 4, "ckpt"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=_job_env(tmp_path, HVDTPU_TEST_KILL="1", HVDTPU_TEST_KILL_RANK="2",
                     HVDTPU_TEST_TOTAL=str(total),
                     HVDTPU_TEST_STEP_DELAY="0.3",
                     HVDTPU_TEST_CKPT=str(tmp_path / "ck")))
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if log.exists() and any(
                    ln.startswith("STEP rank=0 size=2 step=6")
                    for ln in log.read_text().splitlines()):
                hostsfile.write_text(
                    f"localhost:2\n127.0.0.1:2\n{my_ip}:2\n")
                break
            time.sleep(0.3)
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    lines = log.read_text().splitlines()
    assert any(ln.startswith("START rank=0 size=2 resume_step=")
               for ln in lines), lines
    assert [ln for ln in lines if ln.startswith("START rank=0 size=4 ")
            and not ln.endswith("resume_step=0")], lines
    # A step whose commit took the grow interrupt is not logged (the
    # worker logs after the commit, as the reference's does).
    got = _losses(lines)
    oracle = EW.oracle_losses(total)
    assert len(got) >= total - 2, sorted(got)
    assert all(loss == oracle[s] for s, loss in got.items()), got
    assert any(ln.startswith(f"DONE rank=0 size=4 step={total}")
               for ln in lines), lines

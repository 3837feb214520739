"""Port parity: the launcher, ``python -m horovod_tpu_torch.runner``.

The parsers are held against the JAX package's ``horovod_tpu.runner`` on
the cases of ``tests/test_runner.py``, with equality as the tolerance:
host specs, rank assignment, the host hash, the CLI parser and the knob
env it yields.  One difference is by design: ``--platform`` takes ``gpu``
where the reference takes ``tpu``.

Then the launcher end to end on the CPU: a failing rank's exit code ends
the job, the refusals (no command, no ``-np``, ``--tpu-pod`` naming its
ROADMAP item, the elastic flags without a discovery script as the
reference refuses them), an elastic job, ``--check-build``,
``--timeline-dir``, the job's secret on the control plane, and a SIGTERM
to the launcher ending every rank.  Every subprocess has a timeout.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from horovod_tpu.runner import hosts as ref_hosts
from horovod_tpu.runner import launch as ref_launch
from horovod_tpu_torch.runner import hosts as port_hosts
from horovod_tpu_torch.runner import launch as port_launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# parsers, against the JAX package
# ---------------------------------------------------------------------------

HOST_SPECS = ["a:2,b:4", "solo", "localhost:4", " x:1 , y ", "h:3,h:2"]


@pytest.mark.parametrize("spec", HOST_SPECS)
def test_parse_hosts_matches_reference(spec):
    assert [tuple(vars(h).values()) for h in port_hosts.parse_hosts(spec)] \
        == [tuple(vars(h).values()) for h in ref_hosts.parse_hosts(spec)]


@pytest.mark.parametrize("bad", ["", ":3", "h:x", "h:0"])
def test_parse_hosts_bad_raises_in_both(bad):
    for mod in (ref_hosts, port_hosts):
        with pytest.raises(ValueError):
            mod.parse_hosts(bad)


@pytest.mark.parametrize("spec,np_", [("a:2,b:2", 3), ("a:2,b:2", 4),
                                      ("a:1,b:3", 2), ("solo", 1)])
def test_assign_ranks_matches_reference(spec, np_):
    want = ref_hosts.assign_ranks(ref_hosts.parse_hosts(spec), np_)
    assert port_hosts.assign_ranks(port_hosts.parse_hosts(spec), np_) == want


def test_assign_ranks_too_many_raises_in_both():
    for mod in (ref_hosts, port_hosts):
        with pytest.raises(ValueError, match="exceeds"):
            mod.assign_ranks(mod.parse_hosts("a:2,b:2"), 5)


@pytest.mark.parametrize("env", [{}, {"HOROVOD_HOSTNAME": "box"},
                                 {"HVDTPU_HOSTNAME": "n1",
                                  "HOROVOD_HOSTNAME": "n2"}])
@pytest.mark.parametrize("salt", ["", "split"])
def test_host_hash_matches_reference(monkeypatch, env, salt):
    for k in ("HVDTPU_HOSTNAME", "HOROVOD_HOSTNAME"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port_hosts.host_hash(salt) == ref_hosts.host_hash(salt)


ARGV_CASES = {
    "knobs": ["-np", "2", "--fusion-threshold-mb", "8", "--cycle-time-ms",
              "2.5", "--autotune", "--log-level", "debug", "--", "python",
              "x.py"],
    "cpu": ["-np", "2", "--platform", "cpu", "--", "python", "x.py"],
    "timeline": ["-np", "4", "-H", "a:2,b:2", "--timeline-filename", "t.json",
                 "--timeline-mark-cycles", "--stall-warning-time", "30",
                 "--cache-capacity", "64", "python", "x.py"],
    "elastic": ["-np", "2", "--min-np", "1", "--max-np", "4",
                "--host-discovery-script", "./d.sh", "--slots", "2",
                "--elastic-timeout", "5", "--", "true"],
    "misc": ["--check-build", "--no-connectivity-check", "-v",
             "--ssh-port", "2222", "--autotune-log", "a.csv",
             "--timeline-dir", "tl", "--", "true"],
}


@pytest.mark.parametrize("case", sorted(ARGV_CASES))
def test_cli_parse_and_knob_env_match_reference(case):
    argv = ARGV_CASES[case]
    ref = ref_launch.build_parser().parse_args(argv)
    port = port_launch.build_parser().parse_args(argv)
    # the port's one flag of its own: --slurm, the GPU cluster's host
    # discovery (the reference's --tpu-pod stays, refused)
    assert vars(port).pop("slurm") is False
    assert vars(port) == vars(ref)
    assert port_launch._knob_env(port) == ref_launch._knob_env(ref)


def test_cli_knob_env_values():
    args = port_launch.build_parser().parse_args(ARGV_CASES["knobs"])
    env = port_launch._knob_env(args)
    assert env["HVDTPU_FUSION_THRESHOLD"] == str(8 * 1024 * 1024)
    assert env["HVDTPU_CYCLE_TIME"] == "2.5"
    assert env["HVDTPU_LOG_LEVEL"] == "debug"
    assert env["HVDTPU_AUTOTUNE"] == "1"


def test_cli_config_file_matches_reference(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("cycle_time_ms: 7.5\nautotune: true\nplatform: cpu\n")
    argv = ["-np", "1", "--config-file", str(cfg), "--", "true"]
    env = port_launch._knob_env(port_launch.build_parser().parse_args(argv))
    assert env == ref_launch._knob_env(
        ref_launch.build_parser().parse_args(argv))
    assert env["HVDTPU_CYCLE_TIME"] == "7.5"
    assert env["HVDTPU_PLATFORM"] == "cpu"


def test_cli_platform_is_gpu_or_cpu(capsys):
    parse = port_launch.build_parser().parse_args
    args = parse(["-np", "1", "--platform", "gpu", "--", "true"])
    assert port_launch._knob_env(args)["HVDTPU_PLATFORM"] == "gpu"
    with pytest.raises(SystemExit):
        parse(["-np", "1", "--platform", "tpu", "--", "true"])
    # the reference's own choice, for the record
    ref = ref_launch.build_parser().parse_args(
        ["-np", "1", "--platform", "tpu", "--", "true"])
    assert ref_launch._knob_env(ref)["HVDTPU_PLATFORM"] == "tpu"


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------

def _env(extra=None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def _hvdrun(args, timeout=120, extra_env=None):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", *args],
        capture_output=True, text=True, timeout=timeout, env=_env(extra_env),
        cwd=REPO)


def test_failing_rank_ends_the_job():
    code = ("import sys, os; "
            "sys.exit(3 if os.environ['HVDTPU_CROSS_RANK'] == '1' else 0)")
    res = _hvdrun(["-np", "2", "--", sys.executable, "-c", code])
    assert res.returncode == 3, res.stdout + res.stderr


def test_no_command_exits_2():
    res = _hvdrun(["-np", "1"], timeout=60)
    assert res.returncode == 2
    assert "no command" in res.stderr


def test_missing_np_exits_2():
    res = _hvdrun(["--", "python", "x.py"], timeout=60)
    assert res.returncode == 2
    assert "num-proc" in res.stderr


def test_check_build_names_pytorch_and_no_jax():
    res = _hvdrun(["--check-build"], timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    for line in ("[X] PyTorch", "[X] native (C++ KV + coordinator)",
                 "[X] Gloo (CPU)", "NCCL"):
        assert line in out, out
    assert not re.search(r"JAX|XLA|TPU|Flax", out), out


def _roadmap_titles() -> set:
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        return set(re.findall(r"^\d+\. \*\*(.+?)\*\*", fh.read(), re.M))


@pytest.mark.parametrize("flags,title", [
    (["--tpu-pod"], "Remaining models, bindings and examples"),
    (["--host-discovery-script", "./d.sh"], "Elastic and autoscale"),
    (["--min-np", "1"], "Elastic and autoscale"),
    (["--max-np", "4"], "Elastic and autoscale"),
    (["--slots", "2"], "Elastic and autoscale"),
    (["--elastic-timeout", "5"], "Elastic and autoscale"),
    (["--autoscale"], "Elastic and autoscale"),
    (["--autoscale-interval", "1"], "Elastic and autoscale"),
])
def test_unported_flags_exit_2_naming_their_item(capsys, tmp_path, flags,
                                                 title):
    """``--tpu-pod`` is still refused, naming ``--slurm``, the GPU
    cluster's discovery that took its place with its item.  The elastic
    flags are ported: with a discovery script the job runs under the
    elastic driver; without one each exits 2 as the reference's does,
    with its message."""
    if flags[0] == "--tpu-pod":
        # main() itself, in this process: the refusal precedes any spawn
        assert port_launch.main(["-np", "2", *flags, "--", "true"]) == 2
        err = capsys.readouterr().err
        assert "not ported" in err and "--slurm" in err, err
        assert f"'{title}'" in err, err
    elif flags[0] == "--host-discovery-script":
        script = tmp_path / "d.sh"
        script.write_text("#!/bin/sh\necho localhost:2\n")
        script.chmod(0o755)
        res = _hvdrun(["-np", "2", "--platform", "cpu",
                       "--host-discovery-script", str(script), "--",
                       sys.executable, "-c", "pass"], timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr
    else:
        assert ref_launch.main(["-np", "2", *flags, "--", "true"]) == 2
        ref_err = capsys.readouterr().err
        assert port_launch.main(["-np", "2", *flags, "--", "true"]) == 2
        err = capsys.readouterr().err
        assert err == ref_err and "host-discovery-script" in err, err
    assert title in _roadmap_titles()


def test_unported_flag_exits_2_from_the_command_line():
    res = _hvdrun(["-np", "2", "--tpu-pod", "--", "true"], timeout=60)
    assert res.returncode == 2
    assert "--tpu-pod is not ported" in res.stderr
    assert "finds its hosts with --slurm" in res.stderr


_ALLREDUCE_JOB = """
import os, torch
import horovod_tpu_torch as hvd
hvd.init()
out = hvd.allreduce(torch.full((3,), float(hvd.rank() + 1)), hvd.Sum,
                    name="x")
print("SUM", out.tolist(), hvd.local_rank(), flush=True)
hvd.shutdown()
"""


def test_timeline_dir_writes_and_merges(tmp_path):
    tl = tmp_path / "tl"
    res = _hvdrun(["-np", "2", "--platform", "cpu", "--timeline-dir",
                   str(tl), "--", sys.executable, "-c", _ALLREDUCE_JOB])
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("SUM [3.0, 3.0, 3.0]") == 2, res.stdout
    # one local rank each: the launcher sets HVDTPU_LOCAL_RANK per rank
    assert sorted(re.findall(r"SUM \S+ \S+ \S+ (\d)", res.stdout)) == \
        ["0", "1"]
    for r in range(2):
        assert (tl / f"rank{r}.r{r}.json").is_file()
    merged = json.loads((tl / "merged.json").read_text())
    events = merged["traceEvents"] if isinstance(merged, dict) else merged
    assert {e.get("pid") for e in events if "pid" in e} >= {0, 1}


def test_secret_authenticates_the_control_plane():
    """The launcher's services take the job's secret; a client with
    another secret is refused by the KV store and by the controller."""
    from horovod_tpu_torch._native import ControllerClient, KvClient
    from horovod_tpu_torch.runner.cluster import DriverServices

    with DriverServices(1, service_ip="127.0.0.1", secret="s3cret",
                        stall_shutdown_s=0, stall_warn_s=60) as svc:
        env = svc.worker_env(0, 0, coordinator_addr="127.0.0.1:1")
        assert env["HVDTPU_SECRET"] == "s3cret"
        assert env["HVDTPU_RENDEZVOUS_ADDR"] == f"127.0.0.1:{svc.kv.port}"
        assert env["HVDTPU_CONTROLLER_ADDR"] == \
            f"127.0.0.1:{svc.controller.port}"
        good = KvClient("127.0.0.1", svc.kv.port, secret="s3cret")
        good.set("k", b"v")
        assert good.wait("k", timeout_ms=1000) == b"v"
        good.close()
        bad = KvClient("127.0.0.1", svc.kv.port, secret="wrong")
        with pytest.raises(ConnectionError, match="secret"):
            bad.wait("k", timeout_ms=1000)
        bad.close()
        ok = ControllerClient("127.0.0.1", svc.controller.port, 0,
                              secret="s3cret")
        assert ok.negotiate(["t"]).ready == ["t"]
        ok.close()
        try:
            bad_ctrl = ControllerClient("127.0.0.1", svc.controller.port, 0,
                                        secret="wrong")
        except ConnectionError:
            return
        with pytest.raises(ConnectionError):
            bad_ctrl.negotiate(["t"])
        bad_ctrl.close()


def test_sigterm_to_the_launcher_ends_every_rank(tmp_path):
    """The per-job timeout of the test batteries: a SIGTERM to the
    launcher must take down a rank that would hang for minutes."""
    pids = tmp_path / "pids"
    pids.mkdir()
    code = ("import os, time; open(os.path.join(%r, str(os.getpid())), "
            "'w').close(); time.sleep(300)" % str(pids))
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--", sys.executable, "-c", code],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while len(os.listdir(pids)) < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert len(os.listdir(pids)) == 2
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 128 + signal.SIGTERM
    for pid in map(int, os.listdir(pids)):
        for _ in range(50):
            if not _alive(pid):
                break
            time.sleep(0.1)
        else:
            os.kill(pid, signal.SIGKILL)
            pytest.fail(f"rank process {pid} outlived the launcher")


def _alive(pid: int) -> bool:
    """Running, and not a zombie waiting to be reaped."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rpartition(")")[2].split()[0] != "Z"
    except FileNotFoundError:
        return False

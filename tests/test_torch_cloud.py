"""The port's GPU-cluster host discovery (``horovod_tpu_torch.runner.
cloud``) and the launcher's ``--slurm``, against mocked SLURM
allocations: the counterpart of ``tests/test_cloud.py``'s TPU-VM
metadata cases."""

import os
import subprocess
import sys

import pytest

from horovod_tpu_torch.runner import launch as port_launch
from horovod_tpu_torch.runner.cloud import (
    SlurmUnavailable,
    expand_nodelist,
    parse_tasks_per_node,
    slurm_hosts,
    worker_number,
)
from horovod_tpu_torch.runner.hosts import HostSlots

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLURM_VARS = ("SLURM_JOB_NODELIST", "SLURM_TASKS_PER_NODE", "SLURM_NODEID")


@pytest.fixture()
def slurm(monkeypatch):
    """A clean SLURM environment the test fills in."""
    for k in SLURM_VARS:
        monkeypatch.delenv(k, raising=False)
    return lambda **kw: [monkeypatch.setenv(k, v) for k, v in kw.items()]


@pytest.mark.parametrize("spec,hosts", [
    ("node1", ["node1"]),
    ("gpu[01-03,07],login1",
     ["gpu01", "gpu02", "gpu03", "gpu07", "login1"]),
    ("gpu[8-11]", ["gpu8", "gpu9", "gpu10", "gpu11"]),
    ("gpu[098-101]", ["gpu098", "gpu099", "gpu100", "gpu101"]),
    ("a[1-2]-ib,b[3]", ["a1-ib", "a2-ib", "b3"]),
    ("rack[1-2]-n[01-02]",
     ["rack1-n01", "rack1-n02", "rack2-n01", "rack2-n02"]),
    ("c1, c2", ["c1", "c2"]),
])
def test_nodelist_expands_ranges_padding_and_lists(spec, hosts):
    assert expand_nodelist(spec) == hosts


@pytest.mark.parametrize("spec", ["gpu[01-03", "gpu01]", "gpu[a-b]",
                                  "gpu[3-1]"])
def test_malformed_nodelist_is_refused(spec):
    with pytest.raises(SlurmUnavailable):
        expand_nodelist(spec)


@pytest.mark.parametrize("spec,counts", [
    ("4", [4]), ("4(x2),2", [4, 4, 2]), ("8(x3)", [8, 8, 8]),
    ("2,1(x2),3", [2, 1, 1, 3]),
])
def test_tasks_per_node_expands_repeats(spec, counts):
    assert parse_tasks_per_node(spec) == counts


def test_tasks_per_node_malformed_is_refused():
    with pytest.raises(SlurmUnavailable):
        parse_tasks_per_node("4(2)")


def test_slurm_hosts_slots(slurm):
    slurm(SLURM_JOB_NODELIST="gpu[01-03]", SLURM_TASKS_PER_NODE="4(x2),2",
          SLURM_NODEID="2")
    assert slurm_hosts() == [HostSlots("gpu01", 4), HostSlots("gpu02", 4),
                             HostSlots("gpu03", 2)]
    # --slots sets every node's count over the tasks a node
    assert slurm_hosts(default_slots=8) == [HostSlots(f"gpu0{i}", 8)
                                            for i in (1, 2, 3)]
    assert worker_number() == 2


def test_slurm_hosts_one_slot_without_counts(slurm):
    slurm(SLURM_JOB_NODELIST="n[1-2]")
    assert slurm_hosts() == [HostSlots("n1", 1), HostSlots("n2", 1)]
    assert worker_number() is None


def test_slurm_tasks_must_cover_the_nodes(slurm):
    slurm(SLURM_JOB_NODELIST="n[1-3]", SLURM_TASKS_PER_NODE="2(x2)")
    with pytest.raises(SlurmUnavailable, match="3 nodes"):
        slurm_hosts()


def test_slurm_hosts_outside_an_allocation(slurm):
    with pytest.raises(SlurmUnavailable, match="-H host:slots"):
        slurm_hosts()


def test_hvdrun_slurm_without_allocation_exits_2_naming_h(slurm, capsys):
    assert port_launch.main(["--slurm", "--", "true"]) == 2
    assert "-H host:slots" in capsys.readouterr().err


def test_hvdrun_slurm_conflicts_with_hosts(slurm, capsys):
    slurm(SLURM_JOB_NODELIST="localhost", SLURM_TASKS_PER_NODE="2")
    assert port_launch.main(["-np", "2", "--slurm", "-H", "a:1", "--",
                             "true"]) == 2
    assert "--slurm conflicts with -H" in capsys.readouterr().err


@pytest.mark.integration
def test_hvdrun_slurm_runs_a_job_from_the_allocation(tmp_path):
    """A mocked allocation of two tasks on localhost: ``--slurm`` gives
    -np 2 (no -np on the command line), and both ranks run."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "SLURM_"))}
    env.update(SLURM_JOB_NODELIST="localhost", SLURM_TASKS_PER_NODE="2",
               SLURM_NODEID="0",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    job = tmp_path / "job.py"
    job.write_text(
        "import torch, horovod_tpu_torch as hvd\n"
        "hvd.init()\n"
        "s = hvd.allreduce(torch.ones(2), hvd.Sum, name='x')\n"
        "print('RANK', hvd.rank(), hvd.size(), s.tolist(), flush=True)\n"
        "hvd.shutdown()\n")
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "--slurm",
         "--platform", "cpu", "--verbose", "--", sys.executable, str(job)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "slurm discovery: localhost:2" in res.stderr
    for r in range(2):
        assert f"RANK {r} 2 [2.0, 2.0]" in res.stdout, res.stdout

"""Mistral's data-parallel traffic at the test size: two ranks on the CPU
under the port's launcher, each running the harness's rank path, merged as the
parent merges them.  Sound, the run is correct; with the exchange between
ranks left out, it is not."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import cell as C
from portbench.harness import multi
from portbench_tiny import DP_TRAFFIC

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]


@pytest.mark.parametrize("fault,correct", [("none", True),
                                           ("no_exchange", False)])
def test_two_ranks(fault, correct, tiny, tmp_path):
    cell = tiny("mistral7b.train.s4096", DP_TRAFFIC, ranks=2)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(HERE)])
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
           "--platform", "cpu", "--", sys.executable,
           str(HERE / "portbench_dp_rank.py"), fault, str(tmp_path),
           f"tcp://127.0.0.1:{multi._free_port()}", str(2 ** 31 + 7)]
    p = subprocess.run(cmd, env=env, cwd=str(ROOT), capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    assert [r["size"] for r in ranks] == [2, 2]
    rc, line = C.finish(cell, ranks, False)
    out = json.loads(line)
    assert rc == 0 and out["correct"] is correct, out["check"]
    assert out["device"]["count"] == 2

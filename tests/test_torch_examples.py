"""The port's examples (``examples/port_*.py``), each run for real under
the port's launcher at ``-np 2 --platform cpu`` with small flags, as
``tests/test_examples.py`` runs the JAX package's: every job exits 0 and
rank 0 prints its ``DONE`` line with finite losses at world size 2."""

import math
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.integration


def _run(script: str, *flags: str, timeout: float = 240) -> str:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="2", TF_CPP_MIN_LOG_LEVEL="2")
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--platform", "cpu", "--", sys.executable,
         os.path.join(REPO, "examples", script), "--platform", "cpu",
         *flags],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


@pytest.mark.parametrize("script,flags,name", [
    ("port_mnist.py", ("--steps", "3", "--batch-size", "8"), "mnist"),
    ("port_imagenet_resnet50.py",
     ("--steps", "2", "--image-size", "32", "--batch-size", "2",
      "--num-classes", "10", "--batches-per-allreduce", "2",
      "--warmup-steps", "1", "--sync-bn"), "resnet50"),
    ("port_dlrm_embedding.py", ("--steps", "5", "--batch-size", "16"),
     "dlrm"),
    ("port_tf_keras_mnist.py",
     ("--samples", "64", "--batch-size", "16", "--epochs", "2"),
     "tf_keras_mnist"),
    ("port_llama_finetune.py", ("--steps", "4", "--seq-len", "32"),
     "llama_finetune"),
    ("port_llama_moe.py", ("--steps", "4",), "moe"),
])
def test_port_example_runs_at_two_ranks(script, flags, name):
    if name == "tf_keras_mnist":
        pytest.importorskip("tensorflow")
    out = _run(script, *flags)
    m = re.search(rf"DONE {name} first=(\S+) last=(\S+) size=2", out)
    assert m, out
    first, last = float(m.group(1)), float(m.group(2))
    assert math.isfinite(first) and math.isfinite(last), out
    if name in ("mnist", "dlrm", "llama_finetune", "moe"):
        assert last < first, out

"""Starting a run: in this process for a one-rank cell, or through the
port's own launcher (``python -m horovod_tpu_torch.runner -np N``, the
user's path) for a data-parallel one, whose ranks each write their result
to a directory under ``TMPDIR`` for this process to merge."""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

from . import cell as C
from .spec import BENCH_DIR, ROOT

# Seconds the launcher and its ranks may take, set-up, window and
# reference together, before they are stopped.
RANKS_TIMEOUT_S = 1100


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def runtime_env(cell) -> dict:
    """The runtime's knobs the cell's deployment sets (``runtime_env`` in
    its traffic file), as environment variables."""
    return {k: str(v) for k, v in cell.traffic.get("runtime_env",
                                                    {}).items()}


def run_single(cell, args, t_start: float) -> tuple:
    import horovod_tpu_torch as hvd

    os.environ.update(runtime_env(cell))
    hvd.init()
    r = C.run_rank(cell, args.seed, args.seconds, bool(args.trace),
                   hvd.global_state().device, hvd, t_start)
    return C.finish(cell, [r], bool(args.trace))


def rank_main(cell, args, t_start: float) -> int:
    """One rank of a data-parallel cell, under the launcher."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    os.environ.update(runtime_env(cell))
    hvd.init()
    device = hvd.global_state().device

    def group_init(rank: int, size: int) -> bool:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=args.ref_addr, rank=rank, world_size=size)
        return True

    r = C.run_rank(cell, args.seed, args.seconds, bool(args.trace), device,
                   hvd, t_start, world_group_init=group_init)
    out = Path(args.rank_of) / f"rank{r['rank']}.json"
    tmp = out.with_suffix(".tmp")
    tmp.write_text(json.dumps(r))
    os.replace(tmp, out)
    return 0


def run_parent(cell, args, t_start: float) -> tuple:
    """Build the kernels once, launch the ranks, merge their results."""
    n = cell.traffic["ranks"]
    prebuild = cell.traffic.get("prebuild", [])
    if prebuild:
        from horovod_tpu_torch.ops import _build
        _build.build(prebuild)
    out = Path(tempfile.mkdtemp(prefix="portbench-ranks-"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(runtime_env(cell))
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(n),
           "--", sys.executable, str(BENCH_DIR / "run.py"),
           "--rank-of", str(out), "--workload", cell.name,
           "--seed", str(args.seed), "--seconds", str(args.seconds),
           "--trace", str(args.trace), "--t-start", repr(t_start),
           "--ref-addr", f"tcp://127.0.0.1:{_free_port()}"]
    proc = subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        text, _ = proc.communicate(timeout=RANKS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)     # the launcher ends its ranks
        try:
            text, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
    sys.stderr.write(text[-16000:])
    sys.stderr.flush()
    try:
        files = [out / f"rank{r}.json" for r in range(n)]
        if proc.returncode != 0 or not all(f.is_file() for f in files):
            print(f"portbench: the launcher exited {proc.returncode}; "
                  f"rank results {[f.is_file() for f in files]}",
                  file=sys.stderr, flush=True)
            return 1, None
        ranks = [json.loads(f.read_text()) for f in files]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return C.finish(cell, ranks, bool(args.trace))

#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` at the root of the
checkout; see ``portbench/README.md``.  The last line of standard output
is the result (JSON); the numbers compared for ``correct`` are the last
lines of standard error.  Exits non-zero, printing no result, without a
CUDA device (or with fewer than the cell asks for), when the JAX package
was loaded, or when the run fails."""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # A rank of a multi-card cell, started by the port's launcher: where
    # it writes its result, the parent's start, the reference's group.
    ap.add_argument("--rank-of", help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--ref-addr", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))


def main(argv=None) -> int:
    args = _args(argv)
    from portbench.harness import cell as C
    from portbench.harness import multi, spec

    t_start = args.t_start or C.process_start_epoch()
    _cache_dirs()
    c = spec.find_cell(args.workload)
    if args.rank_of:
        return multi.rank_main(c, args, t_start)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < c.chips:
        print(f"portbench: {args.workload} needs {c.chips} CUDA device(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    if c.traffic["ranks"] > 1:
        rc, line = multi.run_parent(c, args, t_start)
    else:
        rc, line = multi.run_single(c, args, t_start)
    if line is not None:
        print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

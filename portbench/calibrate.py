#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` over many seeds, to set a
cell's limits (``limits/<workload>.json``) from them.  Not run by the
benchmark's own runs.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 --out <file.json>

For each seed: the program's checked first steps (the same call and feed
as a run, at the cell's own size) against the plain reference, which
gives the lower reading of each number.  For each control seed also:

- ``control``: the reference computed in fp8 (the step below the
  configuration's bf16), put in the program's place;
- ``half_batch``: the reference with half of the batch left out and the
  mean taken over the rest;
- ``no_exchange`` (data-parallel cells): the reference without the
  average over ranks;
- ``unchanged``: a step that returns its state unchanged (no run: its
  change is nought).

A data-parallel cell runs this under the port's launcher, one process a
rank (``python -m horovod_tpu_torch.runner -np N -- python
portbench/calibrate.py ... --ref-port P``); each rank writes
``<out>.rank<r>``."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ref-port", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from portbench.harness import cell as C
    from portbench.harness import judge, multi, spec

    cell = spec.find_cell(args.workload)
    tr, ref = cell.traffic, cell.reference()
    os.environ.update(multi.runtime_env(cell))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faults = ["half_batch"] + (["no_exchange"] if tr["ranks"] > 1 else [])
    rows, store = [], None
    for k, seed in enumerate(seeds):
        hvd.init()
        rank, size = hvd.rank(), hvd.size()
        dev = hvd.global_state().device
        t = time.perf_counter()
        prog = cell.program().Program(cell, seed, dev, hvd)
        got, step_s, _ = C.checked_steps(prog, tr, dev)
        prog.free()
        del prog
        hvd.shutdown()
        gc.collect()
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        prog_s = time.perf_counter() - t
        if size > 1:                # the reference's own group
            if store is None:
                store = dist.TCPStore("127.0.0.1", args.ref_port, size,
                                      rank == 0)
            dist.init_process_group(
                "nccl", store=dist.PrefixStore(f"seed{k}", store),
                rank=rank, world_size=size)
        try:
            def reference(**kw):
                t = time.perf_counter()
                r = ref.readings(cell.config, tr, seed, dev, rank=rank,
                                 world=size, **kw)
                return r, time.perf_counter() - t

            truth, ref_s = reference()
            row = {"seed": seed, "rank": rank, "step_s": step_s,
                   "program_s": prog_s, "reference_s": ref_s,
                   "reference_peak_gb": torch.cuda.max_memory_allocated(dev)
                   / 1e9 if cuda else 0.0,
                   "losses": got["loss"], "ref_losses": truth["loss"],
                   "program": judge.gaps(got, truth)}
            if seed in controls:
                ctl, row["control_s"] = reference(precision="fp8")
                row["control"] = judge.gaps(ctl, truth)
                for f in faults:
                    row[f] = judge.gaps(reference(fault=f)[0], truth)
                row["unchanged"] = judge.gaps(
                    dict(truth, change={k: 0.0 for k in truth["change"]}),
                    truth)
        finally:
            if size > 1:
                dist.destroy_process_group()
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    out = Path(args.out)
    if tr["ranks"] > 1:
        out = out.with_name(f"{out.name}.rank{rows[0]['rank']}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

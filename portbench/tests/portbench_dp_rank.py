"""One rank of Mistral's data-parallel traffic at the test size on the CPU,
started by the port's launcher from ``test_portbench_dp.py``:

    python portbench_dp_rank.py <fault> <out dir> <reference address> <seed>

``fault`` is ``none`` or ``no_exchange`` (every rank steps on its own
gradient: the optimizer's hooks and synchronize do nothing)."""

from __future__ import annotations

import sys
import types

from portbench_tiny import DP_TRAFFIC, tiny_cell

from portbench.harness import cell as C
from portbench.harness import multi


def main(argv) -> int:
    fault, out, ref_addr, seed = argv
    if fault == "no_exchange":
        from horovod_tpu_torch.optim import distributed as D
        D._DistributedOptimizer._hook = lambda self, p: None
        D._DistributedOptimizer.synchronize = lambda self: None
    cell = tiny_cell("mistral7b.train.s4096", DP_TRAFFIC, ranks=2)
    args = types.SimpleNamespace(seed=int(seed), seconds=0.5, trace=0,
                                 rank_of=out, ref_addr=ref_addr)
    return multi.rank_main(cell, args, C.process_start_epoch())


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

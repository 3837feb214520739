"""On the card, at the cells' own sizes and limits: the program's checked
steps come out correct and the control (the reference in fp8, put in the
program's place) does not.  Skips without a CUDA device; run on a card
with ``python -m pytest portbench/tests -m chip``."""

from __future__ import annotations

import gc

import pytest

from portbench.harness import cell as C
from portbench.harness import judge, multi, spec

CELLS = ["mistral7b.train.s4096", "resnet50.train.b256"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_program_correct_and_control_not(workload, chip, monkeypatch):
    import torch

    import horovod_tpu_torch as hvd

    cell = spec.find_cell(workload)
    for k, v in multi.runtime_env(cell).items():
        monkeypatch.setenv(k, v)
    seed = 2 ** 31 + 991
    hvd.init()
    try:
        dev = hvd.global_state().device
        prog = cell.program().Program(cell, seed, dev, hvd)
        got, _, _ = C.checked_steps(prog, cell.traffic, dev)
        prog.free()
        del prog
    finally:
        hvd.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    ref = cell.reference()
    truth = ref.readings(cell.config, cell.traffic, seed, dev)
    ok, rows = judge.compare(judge.gaps(got, truth), cell.limits)
    assert ok, rows
    ctl = ref.readings(cell.config, cell.traffic, seed, dev,
                       precision="fp8")
    ok, rows = judge.compare(judge.gaps(ctl, truth), cell.limits)
    assert not ok, rows

"""A whole run at the test size on the CPU: the result line's format, the
reference against the port's plain path, and ``correct`` coming out false
with the timed path broken underneath or the control in the program's
place.  The look for a card is skipped: the run is driven from
``multi.run_single`` on.  Tiny limits (``portbench_tiny.TINY_LIMITS``)
stand in for the cells' own, which are set at the cells' sizes."""

from __future__ import annotations

import json
import math
import types

import pytest
import torch

from portbench.harness import cell as C
from portbench.harness import judge, multi

CELLS = ["mistral7b.train.s4096", "resnet50.train.b256"]
SEED = 2 ** 31 + 12345          # beyond what 32 signed bits hold


def _run(cell, trace=0, seed=SEED):
    args = types.SimpleNamespace(seed=seed, seconds=0.5, trace=trace)
    rc, line = multi.run_single(cell, args, C.process_start_epoch())
    assert rc == 0 and line is not None
    return json.loads(line)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_format(workload, trace, tiny, cpu_runtime, capsys):
    cell = tiny(workload)
    out = _run(cell, trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= cell.traffic["check_steps"] + 3
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    if trace:
        # Off the card the trace holds no device operation: every reader
        # finds nothing, and no device number is written.
        assert out["metrics"] == {} and dev["busy_s"] == 0
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    else:
        names = {m["name"] for m in cell.end_to_end}
        assert set(out["metrics"]) == names
        assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
    for name in judge.NUMBERS:
        assert set(out["check"][name]) == {"value", "limit"}
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("check failed_steps ")
    assert [ln.split()[1] for ln in err[-4:-1]] == list(judge.NUMBERS)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_ports_plain_path(workload, tiny,
                                                     cpu_runtime):
    import horovod_tpu_torch as hvd

    cell = tiny(workload)
    hvd.init()
    dev = hvd.global_state().device
    prog = cell.program().Program(cell, SEED, dev, hvd)
    got, _, _ = C.checked_steps(prog, cell.traffic, dev)
    ref = cell.reference().readings(cell.config, cell.traffic, SEED, dev)
    g = judge.gaps(got, ref)
    assert g["quiet_leaves"] == 0
    for name in judge.NUMBERS:
        assert g[name] < 1e-4, (name, g)


class _HalfLoss:
    """``torch.nn.functional`` whose cross-entropy leaves out the second
    half of the batch and takes the mean over the rest."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def cross_entropy(logits, labels, **kw):
        n = len(labels) // 2
        return torch.nn.functional.cross_entropy(logits[:n], labels[:n],
                                                 **kw)


def _break(monkeypatch, cell, fault):
    """Plant ``fault`` in the program, under the timed path."""
    workload = cell.name
    if fault == "unchanged":
        for opt in (torch.optim.Adam, torch.optim.SGD):
            monkeypatch.setattr(opt, "step", lambda self, closure=None: None)
    elif workload.startswith("mistral"):
        from horovod_tpu_torch.models import llama
        real = llama.loss_fn

        def half_batch(params, batch, cfg, **kw):
            t = batch["tokens"]       # half the rows, or of one row's tokens
            t = t[:len(t) // 2] if len(t) > 1 else t[:, :t.shape[1] // 2 + 1]
            return real(params, {"tokens": t}, cfg, **kw)
        monkeypatch.setattr(llama, "loss_fn", half_batch)
    else:
        monkeypatch.setattr(cell.program(), "F", _HalfLoss())


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_timed_path_is_not_correct(workload, fault, tiny,
                                          cpu_runtime, monkeypatch):
    cell = tiny(workload)
    _break(monkeypatch, cell, fault)
    out = _run(cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["check"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, tiny):
    """The reference in fp8, put in the program's place, against the
    reference: it fails the limits."""
    cell = tiny(workload)
    ref = cell.reference()
    dev = torch.device("cpu")
    truth = ref.readings(cell.config, cell.traffic, SEED, dev)
    ctl = ref.readings(cell.config, cell.traffic, SEED, dev,
                       precision="fp8")
    ok, rows = judge.compare(judge.gaps(ctl, truth), cell.limits)
    assert not ok, rows

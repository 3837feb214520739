"""Port parity: the compiled schedule (``compiled:rs_ag:<k>``,
``horovod_tpu_torch/ops/sched/compiled.py``).

On the card each schedule signature is one CUDA graph (``chip_smoke.py``'s
``dataplane`` phase); on the CPU the same walk runs eagerly as one
function, and that is what is held here, at np=2 and np=4 over Gloo
under the port's launcher (``tests/mp_torch_dataplane_worker.py``, mode
``compiled``), after the reference's ``main_compiled`` battery
(``tests/mp_sched_worker.py:281``):

- ``compiled:rs_ag:<k>`` against ``rs_ag:<k>`` and monolithic: int8 and
  fp8 bitwise; fp32 bitwise against ``rs_ag:<k>`` (the same walk) and,
  against monolithic and the JAX package's psum, bitwise at np=2 and
  within 2 ulp (normwise) at np=4, the reference's contract;
- pre- and postscale and a fused compiled cycle;
- mixed pins converge on one descriptor through the echoed meta (the
  per-chunk dispatch counter does not move on the rank that asked for the
  dispatched walk);
- a joined rank's zeros at the compiled descriptor;
- ``hvd_sched_compiled_dispatches_total`` counts each dispatch.

In this process: ``resolve_schedule``'s grammar and gates against the
reference's, the meta, and the hierarchical family still refused.
"""

from __future__ import annotations

import itertools
import json

import numpy as np
import pytest
import torch

import mp_torch_dataplane_worker as DW
from horovod_tpu import config as ref_config
from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops import sched as jsched
from horovod_tpu_torch import config as port_config
from horovod_tpu_torch.ops import collectives as TC
from horovod_tpu_torch.ops import engine as TE
from horovod_tpu_torch.ops import sched as tsched
from horovod_tpu_torch.ops.sched import compiled as TSC
from test_torch_reduction import bitwise, j_allreduce, ulps
from test_torch_sched import _J_DT

CASES = {c[0]: c for c in DW.SCHED_CASES}


@pytest.fixture(scope="module", params=(2, 4), ids=("np2", "np4"))
def run(request, tmp_path_factory):
    n = request.param
    out = tmp_path_factory.mktemp(f"compiled{n}")
    DW.check_ranks(DW.launch("compiled", str(out), n))
    return n, DW.load("compiled", out, n)


def _same(ranks, key):
    for arrays, _ in ranks[1:]:
        assert bitwise(arrays[key], ranks[0][0][key]), key
    return ranks[0][0][key]


def _fp32_close(n, got, want):
    assert ulps(got, want) <= (0 if n == 2 else 2), ulps(got, want)


def test_ranks_import_no_jax(run):
    assert not any(info["jax_loaded"] for _, info in run[1])


@pytest.mark.parametrize("tag", sorted(CASES))
def test_compiled_equals_the_walk_monolithic_and_the_reference(run, tag):
    n, ranks = run
    _, mode, op, numel = CASES[tag]
    mono = _same(ranks, f"{tag}.mono")
    want = j_allreduce(np.stack([DW.rows(tag, r, numel) for r in range(n)]),
                       op, mode)
    for k in DW.COMPILED_CHUNKS:
        got = _same(ranks, f"{tag}.compiled{k}")
        assert bitwise(got, _same(ranks, f"{tag}.rs_ag{k}")), k
        if mode == "fp32":
            _fp32_close(n, got, mono)
            _fp32_close(n, got, want)
        else:
            assert bitwise(got, mono), (k, np.abs(got - mono).max())
    if mode == "int8":
        assert bitwise(mono, want)


def test_each_compiled_dispatch_counts_once_and_walks_no_unit(run):
    _, ranks = run
    for _, info in ranks:
        assert info["compiled_dispatches"] == info["compiled_expected"]
        assert info["sched_dispatches"] == info["sched_expected"]
        # one per case at 2 chunks under its own label
        assert info["compiled_label"] >= len(CASES)


def test_scaled_and_fused_compiled_groups(run):
    n, ranks = run
    _fp32_close(n, _same(ranks, "scaled.compiled"),
                _same(ranks, "scaled.monolithic"))
    for mode in ("fp32", "int8"):
        for i in range(DW.COMPILED_FUSED[0]):
            got = _same(ranks, f"cfused.compiled.{mode}.{i}")
            mono = _same(ranks, f"cfused.monolithic.{mode}.{i}")
            if mode == "int8":
                assert bitwise(got, mono), i
            else:
                _fp32_close(n, got, mono)


def test_mixed_pins_converge_on_the_echoed_descriptor(run):
    """The coordinator echoes the lowest rank's meta (``compiled``); the
    rank that asked for the dispatched walk adopts it."""
    n, ranks = run
    for arrays, info in ranks:
        assert info["mixed_compiled"] == 1 and info["mixed_sched"] == 0
    rows = np.stack([DW.rows("mixed", r, 4096) for r in range(n)])
    np.testing.assert_allclose(_same(ranks, "mixed"), rows.mean(0),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _same(ranks, "mix.mono"),
        np.stack([DW.rows("mix.mono", r, 64) for r in range(n)]).mean(0),
        rtol=1e-6, atol=1e-6)
    _same(ranks, "mix.cmp")


def test_a_joined_rank_contributes_zeros_to_compiled_allreduces(run):
    n, ranks = run
    for arrays, info in ranks:
        assert info["join_last"] >= 1
        assert info["sched_total"] == info["sched_expected"]
    for step in range(3):
        got = _same(ranks[1:], f"cjoin.{step}")
        live = range(n) if step == 0 else range(1, n)
        want = sum(DW.rows(f"cjoin.{step}", r, DW.COMPILED_JOIN)
                   for r in live) / n
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_resolve_schedule_takes_compiled_as_the_reference():
    grid = itertools.product(
        ("allreduce", "allgather"), ("SUM", "AVERAGE", "MAX"), tuple(_J_DT),
        (0, 4096, 65536, 10 ** 6), (1, 2, 4, 16),
        ("fp32", "bf16", "int8", "fp8"),
        ("", "compiled", "compiled:rs_ag:3", "compiled:rs_ag:1"),
        ("monolithic", "compiled"), (1, 4))
    for verb, op, dt, nbytes, n, mode, req, default, k in grid:
        rcfg = ref_config.Config(sched_mode=default, sched_chunks=k)
        pcfg = port_config.Config(sched_mode=default, sched_chunks=k)
        want = jsched.resolve_schedule(req, verb, getattr(JC.ReduceOp, op),
                                       _J_DT[dt], nbytes, rcfg, n, mode)
        got = tsched.resolve_schedule(req, verb, getattr(TC.ReduceOp, op),
                                      getattr(torch, dt), nbytes, pcfg, n,
                                      mode)
        assert got == want, (verb, op, dt, nbytes, n, mode, req, default, k)
    with pytest.raises(ValueError, match="compiled:rs_ag"):
        tsched.resolve_schedule("compiled:x", "allreduce", TC.ReduceOp.SUM,
                                torch.float32, 1 << 20,
                                port_config.Config(), 4, "fp32")


def test_the_meta_carries_a_compiled_descriptor():
    from horovod_tpu.ops.engine import TensorTableEntry as JEntry
    e = TE.TensorTableEntry(name="t", verb="allreduce",
                            payload=torch.zeros(4096),
                            op=TC.ReduceOp.AVERAGE, precision="int8",
                            schedule="compiled:rs_ag:2")
    ref = JEntry(name="t", verb="allreduce",
                 payload=np.zeros((2, 4096), np.float32),
                 op=JC.ReduceOp.AVERAGE, precision="int8",
                 schedule="compiled:rs_ag:2").meta()
    assert json.loads(e.meta())["sc"] == json.loads(ref)["sc"]
    m = TE._parse_joinable_meta(e.meta())
    assert m is not None and m["sc"] == "compiled:rs_ag:2"
    mine = TE.TensorTableEntry(name="t", verb="allreduce",
                               payload=torch.zeros(4096),
                               op=TC.ReduceOp.AVERAGE, schedule="rs_ag:2")
    TE._reconcile_metas([mine], {"t": mine}, {"t": e.meta()})
    assert (mine.schedule, mine.precision) == ("compiled:rs_ag:2", "int8")


def test_compiled_walk_on_the_cpu_is_one_eager_function():
    """At one rank over Gloo the compiled backend runs the walk eagerly,
    counts once, captures nothing and refuses a cast wire."""
    import torch.distributed as dist
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        before = TSC._m_compiled.labels(schedule="compiled:rs_ag:2").value
        x = torch.arange(4096, dtype=torch.float32)
        got, = TSC.execute_allreduce([x], TC.ReduceOp.SUM,
                                     descriptor="compiled:rs_ag:2",
                                     group=None, n=1)
        assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
        assert TSC._m_compiled.labels(
            schedule="compiled:rs_ag:2").value == before + 1
        assert TSC.stats()["graphs"] == 0
        with pytest.raises(ValueError, match="cast wire"):
            TSC.execute_allreduce([x], TC.ReduceOp.SUM,
                                  descriptor="compiled:rs_ag:2", group=None,
                                  n=1, precision="bf16")
    finally:
        dist.destroy_process_group()

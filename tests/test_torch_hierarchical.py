"""Port parity: the two-tier hierarchical allreduce
(``horovod_tpu_torch/ops/hierarchical.py``, the ``hier:<n_local>:<k>``
family of ``ops/sched/executor.py``, the engine's monolithic route).

np=4 processes as 2 x 2 tiers, on the CPU over Gloo under the port's
launcher (``tests/mp_torch_dataplane_worker.py``, mode ``hier``, with
``HVDTPU_HIERARCHICAL_ALLREDUCE=1`` and ``HVDTPU_HIERARCHICAL_LOCAL_SIZE=2``):
each case flat (monolithic and ``rs_ag:2``) and through ``hier:2:2``, at
fp32 (average, sum), int8, fp8 and an fp32 local tier under an int8 or
fp8 cross hop; the monolithic two-tier route of ``allreduce``, a fused
cycle and ``grouped_allreduce``; the flat fallbacks (an integer AVERAGE,
local sizes 3, 1 and 4, a process set); a compiled request; the gauges;
the standalone entries over a ``build_mesh`` mesh.

The JAX package runs the same rows in-process over 4 of the conftest's
8 CPU devices laid out 2 x 2 (``_build_hier_programs`` walked chunk by
chunk, ``_build_hier_allreduce``).  Bars, the reference's
(``tests/test_hier_sched.py:1-19``): int8 bitwise equal to flat
monolithic and to ``rs_ag``; fp32 within 2 ulp (normwise) of the flat
sum; fp8's error against the true mean at most twice flat fp8's own; the
int8 cross hop lossy but within 0.1 of the true mean (the fp8 cross hop,
which the reference does not test, within its wire's bound over the two
cross ranks, ``tests/test_reduction.py``).  On top of them, every tiered
result is bitwise equal to the JAX package's tiered result: at 2 x 2 each
tier adds two operands, so both packages sum in the same order.

In this process: the IR the two-tier path rides, ``resolve_schedule``'s
``hier:`` decisions and ``resolve_cross_mode`` against the reference's,
the compiled request's warning, and the standalone entry's observation
window, which holds no set-up time.
"""

from __future__ import annotations

import itertools
import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mp_torch_dataplane_worker as DW
from horovod_tpu import config as ref_config
from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops import reduction as JR
from horovod_tpu.ops import sched as jsched
from horovod_tpu.ops.sched import executor as JSE
from horovod_tpu_torch import config as port_config
from horovod_tpu_torch.ops import collectives as TC
from horovod_tpu_torch.ops import hierarchical as TH
from horovod_tpu_torch.ops import sched as tsched
from horovod_tpu_torch.ops.sched import executor as TSE
from test_torch_reduction import bitwise, j_allreduce, ref_atol, ulps

N = 4
CASES = {c[0]: c for c in DW.HIER_CASES}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("hier")
    DW.check_ranks(DW.launch("hier", str(out), N, env=DW.HIER_ENV))
    return DW.load("hier", out, N)


def _same(ranks, key):
    for arrays, _ in ranks[1:]:
        assert bitwise(arrays[key], ranks[0][0][key]), key
    return ranks[0][0][key]


def _tier_mesh() -> Mesh:
    return Mesh(np.array(jax.devices()[:N]).reshape(2, 2),
                ("hvd_cross", "hvd_local"))


def j_hier(rows, op: str, mode: str, cross: str = "", prescale=1.0,
           postscale=1.0, chunks=DW.HIER_CHUNKS, block=512):
    """The reference's ``hier:2:<chunks>`` programs on ``rows``
    ([4, numel]), walked chunk by chunk."""
    n, numel = rows.shape
    cross_mode = JSE.resolve_cross_mode(
        mode, SimpleNamespace(hierarchical_cross_precision=cross))
    quant = mode in JR.QUANT_MODES
    layout = tuple(jsched.chunk_layout(numel, n, chunks,
                                       mode if quant else cross_mode, block))
    progs = JSE._build_hier_programs(
        _tier_mesh(), op == "average", mode, cross_mode, (numel,),
        ((numel,),), jnp.float32, prescale, postscale, block, layout, n)
    bufs = progs["prepare"]([jnp.asarray(rows)])
    outs = []
    for c, clen in enumerate(layout):
        v = progs["rs"][clen](bufs[c])
        v = progs["cross"][clen](*v) if quant else progs["cross"][clen](v)
        outs.append(progs["ag"][clen](*v) if quant else progs["ag"][clen](v))
    return np.asarray(progs["finish"](outs)[0])


def j_mono_hier(rows, op: str, prescale=1.0, postscale=1.0):
    """The reference's monolithic two-tier kernel on ``rows``."""
    fn = JC._build_hier_allreduce(
        SimpleNamespace(devices=jax.devices()[:N]),
        getattr(JC.ReduceOp, op.upper()), 2, 2, prescale, postscale)
    return np.asarray(fn(jnp.asarray(rows)))


def _rows(tag, numel):
    return np.stack([DW.rows(tag, r, numel) for r in range(N)])


def test_ranks_import_no_jax(run):
    assert not any(info["jax_loaded"] for _, info in run)


def test_tiers_are_row_major(run):
    """Local = ranks [c*2, c*2+2), cross = the same local index on every
    node, as the reference's ``_hier_mesh`` lays them out."""
    for r, (_, info) in enumerate(run):
        assert info["split"] == [2, 2]
        assert info["local_ranks"] == [r - r % 2, r - r % 2 + 1]
        assert info["cross_ranks"] == [r % 2, r % 2 + 2]


@pytest.mark.parametrize("tag", sorted(CASES))
def test_hier_schedule_meets_the_references_bars(run, tag):
    _, mode, op, numel, cross = CASES[tag]
    rows = _rows(tag, numel)
    truth = rows.mean(0) if op == "average" else rows.sum(0)
    hier = _same(run, f"{tag}.hier")
    flat = _same(run, f"{tag}.flat")
    assert all(info[f"{tag}.hier_dispatches"] == 1 for _, info in run)
    assert bitwise(hier, j_hier(rows, op, mode, cross))
    if cross:
        # int8: the reference's bar; fp8 (no reference test): the bound
        # of tests/test_reduction.py for a wire over the 2 cross ranks.
        err = np.abs(hier - truth).max()
        bound = 0.1 if cross == "int8" else ref_atol(
            cross, "average", 2, float(np.abs(rows).max()))
        assert 0 < err < bound, (err, bound)
        assert ulps(flat, j_allreduce(rows, op, "fp32")) <= 2
    elif mode == "fp32":
        assert ulps(hier, j_allreduce(rows, op, "fp32")) <= 2
        assert ulps(hier, flat) <= 2
    elif mode == "int8":
        assert bitwise(hier, flat)
        assert bitwise(hier, _same(run, f"{tag}.rs_ag"))
        assert bitwise(flat, j_allreduce(rows, op, "int8"))
        assert np.abs(hier - truth).max() > 0
    else:
        flat_err = np.abs(flat - truth).max()
        assert flat_err > 0
        assert np.abs(hier - truth).max() <= 2 * flat_err


def test_scaled_sum_rides_the_tiers(run):
    rows = _rows("scaled", DW.HIER_NUMEL)
    got = _same(run, "scaled.hier")
    assert bitwise(got, j_hier(rows, "sum", "fp32", prescale=0.5,
                               postscale=2.0))
    assert ulps(got, _same(run, "scaled.flat")) <= 2


def test_flag_routes_allreduce_and_grouped_allreduce(run):
    """Under the flag the monolithic fp32 allreduce, a fused cycle and
    ``grouped_allreduce`` ride the two tiers (bitwise the reference's
    two-tier kernel, within 2 ulp of flat); without it none does."""
    rows = _rows("mono", DW.HIER_NUMEL)
    for op in ("average", "sum"):
        got = _same(run, f"mono.{op}.tiers")
        assert bitwise(got, j_mono_hier(rows, op))
        assert ulps(got, _same(run, f"mono.{op}.flat")) <= 2
    fused = [_rows(f"fused.{i}", DW.HIER_FUSED[1])
             for i in range(DW.HIER_FUSED[0])]
    want = j_mono_hier(np.concatenate(fused, axis=1), "average")
    got = np.concatenate([_same(run, f"fused.tiers.{i}")
                          for i in range(DW.HIER_FUSED[0])])
    assert bitwise(got, want)
    for i, scale in enumerate((1.0, 2.0)):
        assert bitwise(_same(run, f"grouped.tiers.{i}"),
                       j_mono_hier(rows * np.float32(scale), "sum"))
    for _, info in run:
        assert info["mono_routes.tiers"] >= 4 and info["mono_routes.flat"] == 0


@pytest.mark.parametrize("case", ["int", "invalid3", "invalid1", "invalid4",
                                  "ps"])
def test_invalid_splits_fall_back_to_flat(run, case):
    """An integer AVERAGE, an indivisible world (local size 3), a one-rank
    and a whole-world tier, and a process set take the flat path."""
    flat = _same(run, "mono.average.flat")
    for r, (arrays, info) in enumerate(run):
        if case == "int":
            assert info["int_routes"] == 0
            np.testing.assert_array_equal(arrays["int.average"],
                                          np.full(3, float(6 // N)))
        elif case == "ps":
            assert info["ps_routes"] == 0
            if r in (0, 2):
                rows = _rows("mono", DW.HIER_NUMEL)[[0, 2]]
                assert ulps(arrays["ps"], rows.mean(0)) <= 1
        else:
            assert info[f"{case}.split"] is None
            assert info[f"{case}.routes"] == 0
            assert bitwise(arrays[case], flat)


def test_compiled_request_runs_the_dispatched_hier_walk(run):
    """No compiled lowering of the tiers, as in the reference: a compiled
    request under a valid split runs ``hier:2:2``, counted once, and
    captures nothing; the fallback is logged once a process."""
    rows = _rows("compiled", 5000)
    got = _same(run, "compiled")
    assert bitwise(got, j_hier(rows, "average", "fp32"))
    for _, info in run:
        assert info["compiled.hier_dispatches"] == 1
        assert info["compiled.compiled_dispatches"] == 0
    from horovod_tpu_torch.utils import logging as hvd_logging
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    logger = hvd_logging.get_logger()
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    tsched._HIER_FALLBACK_WARNED.discard((2, 7))
    try:
        tsched._warn_hier_fallback(2, 7)
        tsched._warn_hier_fallback(2, 7)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    msgs = [r.getMessage() for r in records
            if "no hierarchical lowering" in r.getMessage()]
    assert msgs == ["sched: compiled mode has no hierarchical lowering "
                    "yet; falling back to dispatched hier:2:7 "
                    "(deterministic on all ranks)"]


def test_tier_gauges_and_the_hier_efficiency_label(run):
    for _, info in run:
        text = info["prometheus"]
        assert 'hvd_perf_tier_excess_seconds{tier="local"}' in text
        assert 'hvd_perf_tier_excess_seconds{tier="cross"}' in text
        assert ('hvd_perf_efficiency{mode="fp32",schedule="hier:2:2",'
                'tier="hier",verb="allreduce"}') in text
        assert 'hvd_sched_dispatches_total{schedule="hier:2:2"}' in text


def test_standalone_entries_over_a_built_mesh(run):
    """``hierarchical_allreduce`` over ``build_mesh(dp=2, tp=2)`` (tp the
    local tier, dp the cross) and the two-step allgather."""
    rows = _rows("standalone", 1001)
    assert bitwise(_same(run, "standalone.sum"), j_mono_hier(rows, "sum"))
    assert bitwise(_same(run, "standalone.average"),
                   j_mono_hier(rows, "average"))
    want = np.concatenate([DW.rows("allgather", r, 6).reshape(2, 3)
                           for r in range(N)])
    np.testing.assert_array_equal(_same(run, "allgather"), want)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_hierarchical_rides_the_schedule_ir():
    from horovod_tpu.ops import hierarchical as JH
    s = TH.hierarchical_schedule("hvd_local", "hvd_cross")
    kinds = [(st.kind, st.axis) for st in s.steps if st.axis]
    assert kinds == [("reduce_scatter", "hvd_local"),
                     ("all_reduce", "hvd_cross"),
                     ("all_gather", "hvd_local")]
    assert TH.hierarchical_schedule("hvd_local", "hvd_cross") is s
    assert s.signature() == JH.hierarchical_schedule(
        "hvd_local", "hvd_cross").signature()


def test_resolve_schedule_hier_requests_as_the_reference():
    grid = itertools.product(
        ("hier:2:2", "hier:4:3", "hier:3:2", "hier:8:2"),
        ("SUM", "AVERAGE", "MAX"), (4096, 65536, 10 ** 6), (1, 4, 8),
        ("fp32", "bf16", "int8"), ("", "int8", "fp8"))
    for req, op, nbytes, n, mode, cross in grid:
        rcfg = ref_config.Config(hierarchical_cross_precision=cross)
        pcfg = port_config.Config(hierarchical_cross_precision=cross)
        want = jsched.resolve_schedule(req, "allreduce",
                                       getattr(JC.ReduceOp, op),
                                       jnp.float32, nbytes, rcfg, n, mode)
        got = tsched.resolve_schedule(req, "allreduce",
                                      getattr(TC.ReduceOp, op),
                                      torch.float32, nbytes, pcfg, n, mode)
        assert got == want, (req, op, nbytes, n, mode, cross)


def test_resolve_cross_mode_as_the_reference():
    for mode, cross in itertools.product(
            ("fp32", "int8", "fp8"), ("", "fp32", "int8", "fp8")):
        cfg = SimpleNamespace(hierarchical_cross_precision=cross)
        assert TSE.resolve_cross_mode(mode, cfg) == \
            JSE.resolve_cross_mode(mode, cfg)


def test_observation_excludes_setup(monkeypatch):
    """The standalone entry resolves its groups and warms a call before
    the window it feeds ``observe_tiers`` opens: a set-up call that took
    100 s (a fake clock) never shows in the observation."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs import perfmodel
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh
    hvd.init(config=port_config.Config(platform="cpu"))
    try:
        mesh = build_mesh(MeshConfig())
        clock = {"t": 0.0, "calls": 0}
        real = TH.hierarchical_allreduce_local

        def slow_first(*a, **kw):
            clock["calls"] += 1
            if clock["calls"] == 1:
                clock["t"] += 100.0      # the set-up call
            return real(*a, **kw)

        observed = []
        monkeypatch.setattr(TH, "hierarchical_allreduce_local", slow_first)
        monkeypatch.setattr(TH.time, "monotonic", lambda: clock["t"])
        monkeypatch.setattr(perfmodel.MODEL, "observe_tiers",
                            lambda *a, **kw: observed.append(a[3]))
        TH._WARMED.clear()
        x = torch.arange(4321, dtype=torch.float32)
        out = TH.hierarchical_allreduce(x, mesh)
        assert torch.equal(out, x)
        assert observed == [0.0], observed
        TH.hierarchical_allreduce(x, mesh)
        assert clock["calls"] == 3 and len(TH._WARMED) == 1
    finally:
        hvd.shutdown()

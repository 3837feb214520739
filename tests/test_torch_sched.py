"""Port parity: the schedule IR and the decomposed ``rs_ag:<k>`` allreduce
(``horovod_tpu_torch/ops/sched/``).

np=2 and np=4 processes on the CPU over Gloo under the port's launcher
(``tests/mp_torch_dataplane_worker.py``, mode ``sched``): ``hvd.allreduce``
monolithic and decomposed (2 and 4 chunks) at fp32 (sum and average,
unaligned sizes), int8 and fp8, with pre- and postscale, a fused async
group, a cast wire that stays monolithic, the dispatch counter, the
overlap gauge and the timeline's per-unit lanes; the eager
``overlap_allreduce`` and ``overlap_reducescatter``;
``bucketed_distributed_gradients`` and ``attach_gradient_reduction``.

Tolerances: the quantized wires bitwise, decomposed against monolithic
and against the JAX package's build functions (exact container sums and the
same block grid); fp32 decomposed against monolithic, and against the
JAX package's psum, bitwise at np=2 and within 2 ulp at np=4 (normwise,
as the reference measures its contract: Gloo's reduce-scatter and
allreduce add in different orders); fp8 against the JAX package within
the reference test's bound.

In this process: the copied IR and lowering against the reference's
(signatures, chunk layouts, the executor's unit order against
``interleaved_order``), ``resolve_schedule``'s decisions on a grid, the
resolution of the compiled and hierarchical families, the negotiation meta
(``wp``, ``sc``), fusion keys, meta adoption and a joined rank's zero
entry.
"""

from __future__ import annotations

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mp_torch_dataplane_worker as DW
from horovod_tpu import config as ref_config
from horovod_tpu.jaxcompat import shard_map
from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops import sched as jsched
from horovod_tpu.ops.sched import executor as JSE
from horovod_tpu_torch import config as port_config
from horovod_tpu_torch.ops import collectives as TC
from horovod_tpu_torch.ops import engine as TE
from horovod_tpu_torch.ops import sched as tsched
from horovod_tpu_torch.ops.sched import executor as TSE
from horovod_tpu_torch.utils.timeline import load_trace_events
from test_torch_reduction import bitwise, j_allreduce, mesh, ref_atol, ulps

CASES = {c[0]: c for c in DW.SCHED_CASES}


@pytest.fixture(scope="module", params=(2, 4), ids=("np2", "np4"))
def run(request, tmp_path_factory):
    n = request.param
    out = tmp_path_factory.mktemp(f"sched{n}")
    for rc, text in DW.launch("sched", str(out), n):
        assert rc == 0, text
    return n, DW.load("sched", out, n), out


def _same(ranks, key):
    for arrays, _ in ranks[1:]:
        assert bitwise(arrays[key], ranks[0][0][key]), key
    return ranks[0][0][key]


def _fp32_close(n, got, want):
    assert ulps(got, want) <= (0 if n == 2 else 2), ulps(got, want)


def test_ranks_import_no_jax(run):
    assert not any(info["jax_loaded"] for _, info in run[1])


@pytest.mark.parametrize("tag", sorted(CASES))
def test_decomposed_equals_monolithic_and_the_reference(run, tag):
    n, ranks, _ = run
    _, mode, op, numel = CASES[tag]
    rows = np.stack([DW.rows(tag, r, numel) for r in range(n)])
    mono = _same(ranks, f"{tag}.mono")
    want = j_allreduce(rows, op, mode)
    for k in DW.SCHED_CHUNKS:
        got = _same(ranks, f"{tag}.rs_ag{k}")
        if mode == "fp32":
            _fp32_close(n, got, mono)
            _fp32_close(n, got, want)
        else:
            assert bitwise(got, mono), (k, np.abs(got - mono).max())
    if mode == "fp32":
        _fp32_close(n, mono, want)
    elif mode == "int8":
        assert bitwise(mono, want)
    else:
        np.testing.assert_allclose(
            mono, want, atol=ref_atol(mode, op, n, float(np.abs(rows).max())))


def test_scaled_and_fused_groups_decompose_alike(run):
    n, ranks, _ = run
    _fp32_close(n, _same(ranks, "scaled.decomposed"),
                _same(ranks, "scaled.monolithic"))
    rows = np.stack([DW.rows("scaled", r, 4097) for r in range(n)])
    _fp32_close(n, _same(ranks, "scaled.monolithic"),
                (rows * np.float32(0.5)).sum(0) * np.float32(3.0))
    for i in range(DW.SCHED_FUSED[0]):
        _fp32_close(n, _same(ranks, f"fused.decomposed.{i}"),
                    _same(ranks, f"fused.monolithic.{i}"))


def test_dispatch_counter_overlap_gauge_and_cast_wire(run):
    """Every decomposed dispatch counts once; the cast wire resolved
    monolithic under ``decomposed`` and counted nothing."""
    n, ranks, _ = run
    for _, info in ranks:
        assert info["dispatches"] == info["dispatches_expected"]
        assert 0.0 <= info["overlap"] <= 1.0
    rows = np.stack([DW.rows("scaled", r, 4097) for r in range(n)])
    np.testing.assert_allclose(
        _same(ranks, "cast"), rows.mean(0),
        atol=ref_atol("bf16", "average", n, float(np.abs(rows).max())))


def test_timeline_lanes_and_flows_of_a_decomposed_allreduce(run):
    n, ranks, out = run
    events = load_trace_events(str(out / "tl.rank0.json"))
    lanes = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    by_lane: dict = {}
    for e in events:
        if e.get("ph") == "B" and e["tid"] in lanes:
            by_lane.setdefault(lanes[e["tid"]], []).append(e["name"])
    k = len(tsched.chunk_layout(4096, n, 4, "int8", 512))
    for c in range(k):
        assert by_lane[f"traced/rs.c{c}"] == ["SCHED_RS"]
        assert by_lane[f"traced/combine.c{c}"] == ["SCHED_COMBINE"]
        assert by_lane[f"traced/ag.c{c}"] == ["SCHED_AG"]
    starts = sum(1 for e in events if e.get("ph") == "s"
                 and lanes.get(e["tid"], "").startswith("traced/"))
    ends = sum(1 for e in events if e.get("ph") == "f"
               and lanes.get(e["tid"], "").startswith("traced/"))
    assert starts == ends == 2 * k     # RS -> COMBINE -> AG per chunk


def _j_inctx(fn, rows):
    n = rows.shape[0]
    f = jax.jit(shard_map(lambda v: fn(v[0])[None], mesh=mesh(n),
                          in_specs=P("hvd"), out_specs=P("hvd"),
                          check_vma=False))
    return np.asarray(f(jnp.asarray(rows)))


@pytest.mark.parametrize("mode", ["fp32", "int8", "fp8"])
def test_eager_overlap_chains_match_the_reference(run, mode):
    n, ranks, _ = run
    rows = np.stack([DW.rows(f"inctx.{mode}", r, 5000) for r in range(n)])
    want = _j_inctx(lambda x: jsched.overlap_allreduce(
        x, "hvd", average=True, mode=mode, chunks=DW.INCTX_CHUNKS), rows)[0]
    got = _same(ranks, f"overlap_allreduce.{mode}")
    layout = jsched.chunk_layout(5000, n, DW.INCTX_CHUNKS, mode, 512)
    padded = np.zeros((n, sum(layout)), np.float32)
    padded[:, :5000] = rows
    shards = _j_inctx(lambda x: jsched.overlap_reducescatter(
        x, "hvd", layout=layout, average=True, mode=mode), padded)
    atol = ref_atol(mode, "average", n, float(np.abs(rows).max()))
    for r, (arrays, _) in enumerate(ranks):
        shard = arrays[f"overlap_reducescatter.{mode}"]
        if mode == "fp32":
            _fp32_close(n, shard, shards[r])
        elif mode == "int8":
            assert bitwise(shard, shards[r])
        else:
            np.testing.assert_allclose(shard, shards[r], atol=atol)
    if mode == "fp32":
        _fp32_close(n, got, want)
    elif mode == "int8":
        assert bitwise(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol)


def test_buckets_reduce_as_plain_allreduces(run):
    n, ranks, _ = run
    for key, numel in DW.BUCKET_SIZES.items():
        got = _same(ranks, f"bucketed.{key}")
        # a fused bucket adds in another order than one tensor at np=4
        _fp32_close(n, got, _same(ranks, f"plain.{key}"))
        rows = np.stack([DW.rows(f"bucket.{key}", r, numel)
                         for r in range(n)])
        np.testing.assert_allclose(got, rows.mean(0), rtol=1e-6, atol=1e-6)
    assert len(tsched.buckets.plan_buckets(
        [torch.zeros(v) for v in DW.BUCKET_SIZES.values()],
        DW.BUCKET_BYTES)) > 1


def test_attach_gradient_reduction_averages_each_bucket(run):
    n, ranks, _ = run
    for name in ("w", "b"):
        got = _same(ranks, f"attach.{name}")
        local = np.stack([a[f"attach_local.{name}"] for a, _ in ranks])
        np.testing.assert_allclose(got, local.mean(0), rtol=1e-5,
                                   atol=1e-5)
        assert not np.allclose(local[0], local[1])


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_lowering_is_the_references():
    for numel, n, chunks, mode, avg in itertools.product(
            (1, 4097, 100000), (2, 4, 8), (1, 2, 4, 7),
            ("fp32", "int8", "fp8"), (True, False)):
        assert tsched.chunk_layout(numel, n, chunks, mode, 512) == \
            jsched.chunk_layout(numel, n, chunks, mode, 512)
        a = tsched.lower_allreduce(numel, n, op_average=avg, mode=mode,
                                   chunks=chunks, axis="hvd")
        b = jsched.lower_allreduce(numel, n, op_average=avg, mode=mode,
                                   chunks=chunks, axis="hvd")
        assert a.signature() == b.signature()
        assert a.descriptor == b.descriptor
        # the executor's unit order is the schedule's interleaved order
        units = {"reduce_scatter": "rs", "combine": "combine",
                 "all_gather": "ag"}
        walk = [(units[s.kind], s.chunk) for s in a.interleaved_order()
                if s.kind in units]
        assert walk == TSE.unit_order(a.chunks, mode != "fp32" or avg)
    for desc in ("rs_ag:4", "rs_ag:0", "hier:4:2", "compiled:rs_ag:2", "x"):
        assert tsched.parse_descriptor(desc) == jsched.parse_descriptor(desc)
        assert tsched.known_descriptor(desc) == \
            jsched.known_descriptor(desc)


def test_overlap_fraction_is_the_references():
    comm = [(0.0, 1.0), (1.0, 3.0), (5.0, 6.0)]
    compute = [(0.5, 1.5), (1.2, 2.0), (5.5, 7.0)]
    assert TSE._overlap_fraction(comm, compute) == \
        JSE._overlap_fraction(comm, compute)
    assert TSE._overlap_fraction(comm, []) == 0.0


_J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
         "int32": jnp.int32}


def test_resolve_schedule_decides_as_the_reference():
    grid = itertools.product(
        ("allreduce", "allgather"), ("SUM", "AVERAGE", "MAX"), tuple(_J_DT),
        (0, 4096, 65536, 10 ** 6), (1, 2, 4, 16),
        ("fp32", "bf16", "int8", "fp8"),
        ("", "monolithic", "decomposed", "rs_ag:3"),
        ("monolithic", "decomposed"), (1, 4))
    for verb, op, dt, nbytes, n, mode, req, default, k in grid:
        rcfg = ref_config.Config(sched_mode=default, sched_chunks=k)
        pcfg = port_config.Config(sched_mode=default, sched_chunks=k)
        want = jsched.resolve_schedule(req, verb, getattr(JC.ReduceOp, op),
                                       _J_DT[dt], nbytes, rcfg, n, mode)
        got = tsched.resolve_schedule(req, verb, getattr(TC.ReduceOp, op),
                                      getattr(torch, dt), nbytes, pcfg, n,
                                      mode)
        assert got == want, (verb, op, dt, nbytes, n, mode, req, default, k)


@pytest.mark.parametrize("req", ["compiled", "compiled:rs_ag:2", "hier:2:2"])
def test_compiled_and_hierarchical_schedules_are_refused(req):
    """The name is kept from when these families were refused: both
    resolve now (``tests/test_torch_compiled.py``,
    ``tests/test_torch_hierarchical.py``).  ``hier:2:2`` passes through at
    4 ranks, degrades to the flat descriptor where 2 is not a valid tier
    size, as the reference's; the executor refuses a tiered walk over a
    process set; a cast wire is refused by every family."""
    cfg = port_config.Config()
    if req.startswith("compiled"):
        assert tsched.resolve_schedule(
            req, "allreduce", TC.ReduceOp.SUM, torch.float32, 1 << 20, cfg,
            4, "fp32") == "compiled:rs_ag:" + (req.split(":")[-1]
                                               if ":" in req else "4")
    else:
        for n, want in ((4, "hier:2:2"), (2, "rs_ag:2"), (3, "rs_ag:2")):
            got = tsched.resolve_schedule(req, "allreduce", TC.ReduceOp.SUM,
                                          torch.float32, 1 << 20, cfg, n,
                                          "fp32")
            assert got == want == jsched.resolve_schedule(
                req, "allreduce", JC.ReduceOp.SUM, jnp.float32, 1 << 20,
                ref_config.Config(), n, "fp32"), (n, got)
        with pytest.raises(ValueError, match="global process set"):
            TSE.execute_allreduce([torch.zeros(8)], TC.ReduceOp.SUM,
                                  descriptor=req, group=object(), n=4)
    with pytest.raises(ValueError, match="cast wire"):
        TSE.execute_allreduce([torch.zeros(8)], TC.ReduceOp.SUM,
                              descriptor=req if req != "compiled"
                              else "rs_ag:2", group=None, n=2,
                              precision="bf16")


def _entry(name, precision="", schedule="", numel=4096):
    return TE.TensorTableEntry(name=name, verb="allreduce",
                               payload=torch.zeros(numel),
                               op=TC.ReduceOp.AVERAGE, precision=precision,
                               schedule=schedule)


def test_meta_carries_wire_mode_and_schedule_as_the_reference():
    from horovod_tpu.ops.engine import TensorTableEntry as JEntry
    for precision, schedule in (("", ""), ("fp32", ""), ("int8", "rs_ag:4"),
                                ("bf16", ""), ("fp32", "rs_ag:2")):
        mine = json.loads(_entry("t", precision, schedule).meta())
        ref = json.loads(JEntry(
            name="t", verb="allreduce", payload=np.zeros((2, 4096),
                                                         np.float32),
            op=JC.ReduceOp.AVERAGE, precision=precision,
            schedule=schedule).meta())
        assert {k: mine.get(k) for k in ("wp", "sc")} == \
            {k: ref.get(k) for k in ("wp", "sc")}
    m = TE._parse_joinable_meta(_entry("t", "int8", "rs_ag:4").meta())
    assert (m["wp"], m["sc"]) == ("int8", "rs_ag:4")
    for bad in ({"wp": "int4"}, {"sc": "zz:1"}):
        meta = json.loads(_entry("t").meta())
        meta.update(bad)
        assert TE._parse_joinable_meta(json.dumps(meta)) is None


def test_fusion_keys_on_wire_mode_and_schedule():
    eng = TE.CollectiveEngine.__new__(TE.CollectiveEngine)
    es = [_entry("a", "int8", "rs_ag:4"), _entry("b", "", ""),
          _entry("c", "int8", "rs_ag:4"), _entry("d", "fp32", ""),
          _entry("e", "int8", "")]
    groups = [[e.name for e in g] for g in eng._fuse(es, 1 << 30)]
    assert groups == [["a", "c"], ["b", "d"], ["e"]]


def test_ranks_adopt_the_echoed_meta_and_joined_zeros_keep_it():
    mine = _entry("t", "fp32", "")
    echoed = _entry("t", "int8", "rs_ag:4").meta()
    TE._reconcile_metas([mine], {"t": mine}, {"t": echoed})
    assert (mine.precision, mine.schedule) == ("int8", "rs_ag:4")
    same = _entry("u", "int8", "rs_ag:4")
    TE._reconcile_metas([same], {"u": same}, {"u": "not json"})
    assert (same.precision, same.schedule) == ("int8", "rs_ag:4")

    eng = TE.CollectiveEngine.__new__(TE.CollectiveEngine)
    eng._device, eng._stream = torch.device("cpu"), None
    z = eng._zero_entry("t", TE._parse_joinable_meta(echoed))
    assert (z.precision, z.schedule) == ("int8", "rs_ag:4")
    assert z.payload.shape == (4096,) and not z.payload.any()

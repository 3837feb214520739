"""Port parity: wire precision (``horovod_tpu_torch/ops/reduction.py``).

np=2 and np=4 processes, one rank each, on the CPU over Gloo under the
port's launcher (``tests/mp_torch_dataplane_worker.py``, mode
``reduction``, ``HVDTPU_QUANT_MIN_BYTES=0``): ``hvd.allreduce`` at every
wire mode and both sum ops, another block size, unaligned sizes, a rank
whose blocks are all zeros, the psum form, ``grouped_allreduce``, the
async engine path fused into one buffer, Adasum, ranks that resolve the
wire and the schedule differently, and a joined rank's zeros at int8.

Each result is held against the JAX package's build functions
(``ops/reduction.py`` ``build_allreduce``, ``in_context_allreduce``,
``ops/adasum.py``) over a mesh of the first n of the conftest's 8 CPU
devices, on the same numpy-seeded rows.  Tolerances: int8 bitwise (its
sums are exact in both packages); fp8 and bf16/fp16 within the bound of
the reference's own test (``tests/test_reduction.py``: its sums round in
the container, in another order over Gloo); fp32 bitwise at np=2 and
within 2 ulp at np=4, normwise as the reference measures it; Adasum
rtol 1e-5, atol 1e-6 (its dot products sum in another order).

In this process: the encode/decode of both quantized algebras bitwise
against the reference's, round half to even, the container choice and
its wire accounting, and ``resolve_precision``'s decisions on a grid.
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import mp_torch_dataplane_worker as DW
from horovod_tpu import config as ref_config
from horovod_tpu.jaxcompat import shard_map
from horovod_tpu.ops import adasum as JA
from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops import reduction as JR
from horovod_tpu_torch import config as port_config
from horovod_tpu_torch.ops import collectives as TC
from horovod_tpu_torch.ops import compression as TCmp
from horovod_tpu_torch.ops import reduction as TR

_JOPS = {"sum": JC.ReduceOp.SUM, "average": JC.ReduceOp.AVERAGE}
CASES = {c[0]: c for c in DW.REDUCTION_CASES}


def mesh(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), ("hvd",))


def j_allreduce(rows: np.ndarray, op: str, mode: str, block: int = 512):
    """The reference's allreduce of ``rows`` ([n, numel]) at ``mode``."""
    n = rows.shape[0]
    if mode == "fp32":
        fn = JC._build_allreduce(mesh(n), "hvd", _JOPS[op], 1.0, 1.0)
    else:
        fn = JR.build_allreduce(mesh(n), "hvd", _JOPS[op], mode,
                                rows.shape[1:], jnp.float32, 1.0, 1.0, block)
    return np.asarray(fn(jnp.asarray(rows)))


def bitwise(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def ulps(a, b) -> float:
    """Normwise distance in float32 ulps, the reference's measure of its
    2-ulp contract (``tests/mp_sched_worker.py``): the largest difference
    over eps times the largest magnitude."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()
                 / (np.finfo(np.float32).eps * max(1e-30, np.abs(b).max())))


def ref_atol(mode: str, op: str, n: int, gmax: float) -> float:
    """``tests/test_reduction.py``'s bound against the exact result."""
    scale_sum = n if op == "sum" else 1.0
    if mode == "int8":
        return 1.5 * (n + scale_sum) * gmax / 254.0
    if mode == "fp8":
        return 1.5 * (n + scale_sum) * gmax / 16.0
    return (n + scale_sum) * gmax * 2.0 ** -7


@pytest.fixture(scope="module", params=(2, 4), ids=("np2", "np4"))
def run(request, tmp_path_factory):
    n = request.param
    out = tmp_path_factory.mktemp(f"reduction{n}")
    for rc, text in DW.launch("reduction", str(out), n):
        assert rc == 0, text
    return n, DW.load("reduction", out, n)


def _same_on_every_rank(ranks, key):
    for arrays, _ in ranks[1:]:
        assert bitwise(arrays[key], ranks[0][0][key]), key
    return ranks[0][0][key]


def test_ranks_import_no_jax(run):
    _, ranks = run
    assert not any(info["jax_loaded"] for _, info in ranks)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_allreduce_at_each_wire_mode_matches_the_reference(run, tag):
    n, ranks = run
    _, mode, op, numel, block = CASES[tag]
    rows = np.stack([DW.rows(tag, r, numel) for r in range(n)])
    got = _same_on_every_rank(ranks, tag)
    want = j_allreduce(rows, op, mode, block)
    exact = rows.sum(0) / (n if op == "average" else 1)
    atol = ref_atol(mode, op, n, float(np.abs(rows).max()))
    if mode == "int8":
        assert bitwise(got, want), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got, exact, atol=atol)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_zero_block_rank_does_not_poison_the_shared_scale(run, mode):
    n, ranks = run
    rows = np.stack([DW.zero_block_rows(r, 1024, 0.01) for r in range(n)])
    got = _same_on_every_rank(ranks, f"zero_block.{mode}")
    want = j_allreduce(rows, "average", mode)
    qmax = 127.0 if mode == "int8" else 448.0
    atol = 1.5 * (n + 1) * 0.01 / (2 * qmax)
    np.testing.assert_allclose(got, rows.mean(0), atol=atol)
    assert np.abs(got).max() > 0
    if mode == "int8":
        assert bitwise(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol)


def test_in_context_form_with_a_zero_block_rank(run):
    n, ranks = run
    rows = np.stack([DW.zero_block_rows(r, 512, 0.02) for r in range(n)])

    def kern(v):
        return JR.in_context_allreduce(v[0], "hvd", "int8",
                                       average=True)[None]

    fn = jax.jit(shard_map(kern, mesh=mesh(n), in_specs=P("hvd"),
                           out_specs=P("hvd"), check_vma=False))
    want = np.asarray(fn(jnp.asarray(rows)))[0]
    got = _same_on_every_rank(ranks, "inctx_zero_block")
    assert bitwise(got, want)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("key,count,numel", [
    ("grouped", *DW.GROUPED), ("async", *DW.ASYNC_FUSED)])
def test_a_fused_group_is_one_quantized_buffer(run, key, count, numel):
    """``grouped_allreduce`` and async entries enqueued in one cycle reduce
    as the reference's one program over their concatenation."""
    n, ranks = run
    parts = [np.stack([DW.rows(f"{key}.{i}", r, numel) for r in range(n)])
             for i in range(count)]
    want = j_allreduce(np.concatenate(parts, axis=1), "average", "int8")
    for i in range(count):
        got = _same_on_every_rank(ranks, f"{key}.{i}")
        assert bitwise(got, want[i * numel:(i + 1) * numel]), i


@pytest.mark.parametrize("numel", DW.ADASUM_SIZES)
def test_adasum_matches_the_reference(run, numel):
    n, ranks = run
    rows = np.stack([DW.rows(f"adasum.{numel}", r, numel) for r in range(n)])
    fn = JA._build_adasum(mesh(n), "hvd", (numel,), jnp.float32)
    want = np.asarray(fn(jnp.asarray(rows)))
    got = _same_on_every_rank(ranks, f"adasum.{numel}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the projection, not a plain sum
    assert not np.allclose(got, rows.sum(0), rtol=1e-3)


def test_ranks_that_resolve_differently_adopt_one_meta(run):
    """Rank 0 resolves int8 (then rs_ag:4), the others fp32 (then
    monolithic); every rank runs what the coordinator echoes, so all get
    the same result, one of the two."""
    n, ranks = run
    rows = np.stack([DW.rows("adopt.wp", r, DW.ADOPT_NUMEL)
                     for r in range(n)])
    got = _same_on_every_rank(ranks, "adopt.wp")
    fp32 = j_allreduce(rows, "average", "fp32")
    assert bitwise(got, j_allreduce(rows, "average", "int8")) or \
        ulps(got, fp32) <= (0 if n == 2 else 2)
    rows = np.stack([DW.rows("adopt.sc", r, DW.ADOPT_NUMEL)
                     for r in range(n)])
    got = _same_on_every_rank(ranks, "adopt.sc")
    assert ulps(got, j_allreduce(rows, "sum", "fp32")) <= \
        (0 if n == 2 else 2)


def test_a_joined_rank_contributes_zeros_at_the_same_wire_mode(run):
    n, ranks = run
    rows = np.stack([DW.rows("join.1", r, DW.JOIN_NUMEL) for r in range(n)])
    rows[0] = 0.0
    want = j_allreduce(rows, "average", "int8")
    for arrays, info in ranks[1:]:
        assert bitwise(arrays["join.1"], want)
        assert 0 <= info["join_last"] < n
    rows0 = np.stack([DW.rows("join.0", r, DW.JOIN_NUMEL) for r in range(n)])
    assert bitwise(_same_on_every_rank(ranks, "join.0"),
                   j_allreduce(rows0, "average", "int8"))


@pytest.mark.parametrize("tag", ["int8.sum", "fp8.average", "bf16.sum",
                                 "int8.unaligned7"])
def test_wire_bytes_saved_counts_the_container(run, tag):
    n, ranks = run
    _, mode, _, numel, block = CASES[tag]
    want = (JR.ring_wire_bytes("fp32", 4 * numel, n, block)
            - JR.ring_wire_bytes(mode, 4 * numel, n, block))
    for _, info in ranks:
        assert info[f"saved.{tag}"] == max(0, want)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_round_is_half_to_even_in_both_packages():
    halves = np.arange(-6, 6, dtype=np.float32) + 0.5
    got = torch.round(torch.from_numpy(halves)).numpy()
    assert np.array_equal(got, np.asarray(jnp.round(jnp.asarray(halves))))
    assert got[:4].tolist() == [-6, -4, -4, -2]
    # the codes of a block of halves against a shared scale of exactly 1
    block = torch.from_numpy(np.concatenate(
        [halves, np.zeros(52, np.float32)]))[None]
    codes, _ = TR.algebra_for("int8").wire_encode(block, torch.ones(1))
    assert codes[0, :12].tolist() == got.tolist()


def j_encode(mode: str, x: np.ndarray):
    """The reference's encode and decode as its kernels run them, inside
    jit (where XLA multiplies by 1/qmax instead of dividing by qmax)."""
    alg = JR.algebra_for(mode)

    def f(v):
        w, s = alg.wire_encode(v)
        return w, s, alg.wire_decode(w, s)

    return [np.asarray(t) for t in jax.jit(f)(jnp.asarray(x))]


@pytest.mark.parametrize("block", [64, 256, 512])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_encode_decode_match_the_reference_per_block(mode, block):
    rng = np.random.RandomState(7)
    x = (rng.randn(12, block) * 10 ** rng.uniform(-3, 3, (12, 1))
         ).astype(np.float32)
    t_alg = TR.algebra_for(mode)
    tw, ts = t_alg.wire_encode(torch.from_numpy(x))
    jw, js, jback = j_encode(mode, x)
    assert bitwise(ts.numpy(), js)
    assert np.array_equal(tw.view(torch.uint8).numpy(), jw.view(np.uint8))
    back = t_alg.wire_decode(tw, ts).numpy()
    assert bitwise(back, jback)
    amax = np.abs(x).max(axis=-1, keepdims=True)
    bound = (amax / (2 * t_alg.qmax) if mode == "int8" else amax * 2.0 ** -4)
    assert (np.abs(back - x) <= bound * 1.001 + 1e-12).all()


def test_zero_blocks_stay_finite():
    for mode in ("int8", "fp8"):
        alg = TR.algebra_for(mode)
        wire, scales = alg.wire_encode(torch.zeros(2, 64))
        back = alg.wire_decode(wire, scales)
        assert torch.isfinite(back).all() and (back == 0).all()


def test_the_int8_container_is_exact_and_accounted():
    """fp16 up to 16 ranks (every sum of 16 codes is an integer below
    2048), int32 beyond; the wire accounting is the reference's for the
    2-byte container and counts the 4-byte one."""
    rng = np.random.RandomState(0)
    for n in range(1, 17):
        codes = rng.randint(-127, 128, size=(n, 4096))
        codes[:, :2] = 127 * np.sign(rng.randn(n, 2))   # the extremes
        acc = torch.zeros(4096, dtype=TR.container_dtype("int8", n))
        for r in rng.permutation(n):
            acc += torch.from_numpy(codes[r]).to(acc.dtype)
        assert np.array_equal(acc.to(torch.int64).numpy(), codes.sum(0)), n
        assert TR.ring_wire_bytes("int8", 4 << 20, n) == \
            JR.ring_wire_bytes("int8", 4 << 20, n)
    assert TR.container_dtype("int8", 16) == torch.float16
    assert TR.container_dtype("int8", 17) == torch.int32
    assert TR.container_dtype("fp8", 146) == torch.float16
    assert TR.ring_wire_bytes("int8", 4 << 20, 32) == \
        int(31 / 32 * (5 + 8 / 512) * (1 << 20))
    for mode in ("fp32", "bf16", "fp16", "fp8"):
        for n in (2, 64):
            assert TR.ring_wire_bytes(mode, 4 << 20, n) == \
                JR.ring_wire_bytes(mode, 4 << 20, n)


_J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
         "float16": jnp.float16, "int32": jnp.int32}


def test_resolve_precision_decides_as_the_reference():
    grid = itertools.product(
        ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT", "ADASUM"),
        tuple(_J_DT), (0, 1000, 65536, 10 ** 6), (1, 2, 16, 147, 257),
        ("", "fp32", "bf16", "fp16", "int8", "fp8"), ("fp32", "int8"))
    for op, dt, nbytes, n, req, default in grid:
        rcfg = ref_config.Config(wire_precision=default)
        pcfg = port_config.Config(wire_precision=default)
        want = JR.resolve_precision(req, getattr(JC.ReduceOp, op),
                                    _J_DT[dt], nbytes, rcfg, n)
        got = TR.resolve_precision(req, getattr(TC.ReduceOp, op),
                                   getattr(torch, dt), nbytes, pcfg, n)
        assert got == want, (op, dt, nbytes, n, req, default)
    for mod in (JR, TR):
        with pytest.raises(ValueError, match="unknown wire precision"):
            mod.resolve_precision("int4", None, None, 0, pcfg, 2)


def test_compression_entries_route_as_the_reference():
    from horovod_tpu.ops.compression import Compression as JCmp
    for name in ("none", "fp16", "fp16_ieee", "int8", "fp8"):
        assert TR.as_wire_mode(getattr(TCmp.Compression, name)) == \
            JR.as_wire_mode(getattr(JCmp, name)), name
    assert TR.as_wire_mode(TCmp.Compression.bf16) == "bf16"
    assert TR.as_wire_mode(None) == "" and TR.as_wire_mode("int8") == "int8"
    with pytest.raises(ValueError):
        TR.as_wire_mode("int4")
    assert TCmp.routes_engine_side(TCmp.Compression.int8)
    assert TCmp.routes_engine_side(TCmp.Compression.fp8)
    assert not TCmp.routes_engine_side(TCmp.Compression.fp16)
    x = torch.randn(5)
    assert TCmp.Compression.int8.compress(x)[0] is x

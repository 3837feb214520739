"""Multi-process worker of the port's collective data plane parity tests.

``launch(mode, outdir, np_)`` runs ``np_`` copies of this script, one rank
each, through the port's launcher on the CPU over Gloo (the machinery of
``tests/mp_torch_port_worker.py``), with ``HVDTPU_QUANT_MIN_BYTES=0``.
Every rank runs the battery of ``mode`` (``reduction``, ``sched``,
``zero``, ``compiled`` or ``average``) and writes what it got to
``outdir/<mode>.rank<r>.npz`` and ``.json``; ``tests/test_torch_reduction.py``,
``_sched.py``, ``_zero.py``, ``_compiled.py``, ``_average.py``,
``_hierarchical.py`` (mode ``hier``, np=4 as 2 x 2 tiers),
``_parallel.py`` (mode ``parallel``: the mesh and MoE) and ``_chaos.py``
(mode ``chaos_moe``) compare it with the JAX package run in-process on
the same rows, which the functions below make with numpy from fixed
seeds.
"""

from __future__ import annotations

import json
import os
import sys
import zlib

import numpy as np

import mp_torch_port_worker as W

# One thread a rank: the rows are small, and a test run shares its cores.
ENV = {"HVDTPU_QUANT_MIN_BYTES": "0", "OMP_NUM_THREADS": "1"}


def launch(mode: str, outdir: str, np_: int, timeout: float = 150,
           env: dict | None = None) -> list:
    return W.launch(mode, outdir, np_=np_, timeout=timeout,
                    extra_env={**ENV, **(env or {})}, script=__file__)


def check_ranks(results: list) -> None:
    """Every rank exited 0; else fail with the text of the rank whose
    exit ended the job (the launcher terminates the others, -15)."""
    bad = [(rc, r, text) for r, (rc, text) in enumerate(results) if rc != 0]
    if bad:
        bad.sort(key=lambda b: b[0] in (-15, None))
        rc, r, text = bad[0]
        raise AssertionError(f"rank {r} exited {rc}:\n{text}")


def load(mode: str, outdir, np_: int) -> list:
    """Each rank's (arrays, info) of a finished battery."""
    ranks = []
    for r in range(np_):
        with np.load(os.path.join(outdir, f"{mode}.rank{r}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(outdir, f"{mode}.rank{r}.json")) as f:
            ranks.append((arrays, json.load(f)))
    return ranks


# ---------------------------------------------------------------------------
# inputs (shared with the tests)
# ---------------------------------------------------------------------------

def rows(tag: str, rank: int, numel: int) -> np.ndarray:
    """Rank ``rank``'s float32 input of case ``tag``."""
    seed = (zlib.crc32(tag.encode()) + rank) % 2**31
    return np.random.RandomState(seed).randn(numel).astype(np.float32)


def zero_block_rows(rank: int, numel: int, small: float) -> np.ndarray:
    """Rank 0 all zeros, every other rank ``small``: the case where a
    MAX of finished scales would zero everyone out."""
    return np.full(numel, 0.0 if rank == 0 else small, np.float32)


# (tag, mode, op, numel, block)
REDUCTION_CASES = (
    [(f"{m}.{op}", m, op, 5000, 512) for m in ("int8", "fp8", "bf16", "fp16")
     for op in ("sum", "average")]
    + [("int8.block64", "int8", "average", 3000, 64)]
    + [(f"int8.unaligned{k}", "int8", "sum", k, 512)
       for k in (1, 7, 513, 4097)])
GROUPED = (4, 130)           # tensors, elements each
ASYNC_FUSED = (6, 257)
ADASUM_SIZES = (1000, 7)
JOIN_NUMEL = 2048
ADOPT_NUMEL = 4096

# (tag, mode, op, numel)
SCHED_CASES = (
    [(f"fp32.{op}.{k}", "fp32", op, k) for op in ("sum", "average")
     for k in (4097, 10001)]
    + [(f"int8.{op}", "int8", op, 5000) for op in ("sum", "average")]
    + [("fp8.average", "fp8", "average", 5000)])
SCHED_CHUNKS = (2, 4)
SCHED_FUSED = (5, 1000)
INCTX_CHUNKS = 3
BUCKET_SIZES = {"a": 300, "b": 1000, "c": 17, "d": 2000, "e": 5}
BUCKET_BYTES = 4096

COMPILED_CHUNKS = (2, 4)
COMPILED_FUSED = (4, 2048)      # entries of one compiled cycle, elements
COMPILED_JOIN = 4096

# np=3 AVERAGE: payload dtypes and the bits of each one's significand.
AVG_DTYPES = (("float32", 24), ("float16", 11), ("bfloat16", 8))
AVG_NUMEL = 20000
AVG_CHUNKS = (2, 4)


def avg_rows(dtype: str, rank: int, n: int) -> np.ndarray:
    """Rank ``rank``'s float32 input of the np=3 AVERAGE case: per element
    a small integer times a power of two shared by every rank, sized so
    that the sum over ``n`` ranks is exact in ``dtype`` in any order.  The
    sums then agree bitwise whatever order Gloo and XLA add in, and only
    the division by ``n`` can differ."""
    bits = dict(AVG_DTYPES)[dtype]
    kmax = (2 ** bits - 1) // n
    exp = np.random.RandomState(7).randint(-8, 5, AVG_NUMEL)
    k = np.random.RandomState(100 + rank).randint(-kmax, kmax + 1,
                                                  AVG_NUMEL)
    return (k * np.exp2(exp.astype(np.float64))).astype(np.float32)


# np=4 as 2 x 2: the tiers are made at init from these knobs.
HIER_ENV = {"HVDTPU_HIERARCHICAL_ALLREDUCE": "1",
            "HVDTPU_HIERARCHICAL_LOCAL_SIZE": "2"}
# (tag, wire mode, op, numel, hierarchical_cross_precision)
HIER_CASES = (("fp32.average", "fp32", "average", 5000, ""),
              ("fp32.sum", "fp32", "sum", 4097, ""),
              ("int8.average", "int8", "average", 100000, ""),
              ("fp8.average", "fp8", "average", 100000, ""),
              ("cross_int8", "fp32", "average", 100000, "int8"),
              ("cross_fp8", "fp32", "average", 100000, "fp8"))
HIER_CHUNKS = 2
HIER_FUSED = (3, 97)            # entries of one fused cycle, elements
HIER_NUMEL = 4097

# MoE: the cases of tests/test_parallel.py.
MOE_EP = dict(T=32, D=8, E=4, seed=11)          # moe_layer vs the oracle
MOE_DROP = dict(T=64, D=4, E=8, seed=6, cf=0.25)
MOE_HVD = dict(D=8, E=16, T=10, seed=7, cf=1.25)
CHAOS_STEPS = 3


def moe_ep_inputs():
    c = MOE_EP
    rng = np.random.RandomState(c["seed"])
    tokens = rng.randn(c["T"], c["D"]).astype(np.float32)
    router = rng.randn(c["D"], c["E"]).astype(np.float32)
    we = (rng.randn(c["E"], c["D"], c["D"]) * 0.5).astype(np.float32)
    return tokens, router, we


def moe_drop_inputs():
    c = MOE_DROP
    tokens = np.random.RandomState(c["seed"]).randn(
        c["T"], c["D"]).astype(np.float32)
    router = np.zeros((c["D"], c["E"]), np.float32)  # all to expert 0
    we = np.stack([np.eye(c["D"], dtype=np.float32)] * c["E"])
    return tokens, router, we


def moe_hvd_inputs(n: int):
    c = MOE_HVD
    rng = np.random.RandomState(c["seed"])
    router = rng.randn(c["D"], c["E"]).astype(np.float32)
    w = (rng.randn(c["E"], c["D"], c["D"]) * 0.5).astype(np.float32)
    toks = [rng.randn(c["T"], c["D"]).astype(np.float32) for _ in range(n)]
    return router, w, toks


ZERO_SHAPES = ((33, 20), (20,), (513,), (8, 64), (7,))
ZERO_LR = 1e-2
ZERO_STEPS = 2
# (tag, compression, sched_mode, bucket_bytes)
ZERO_SETUPS = (("fp32.mono", "none", "monolithic", None),
               ("fp32.dec", "none", "decomposed", None),
               ("fp32.dec.buckets", "none", "decomposed", 2048),
               ("int8.mono", "int8", "monolithic", None),
               ("int8.dec", "int8", "decomposed", None))


def zero_params(i: int) -> np.ndarray:
    return rows(f"zero.param.{i}", 0, int(np.prod(ZERO_SHAPES[i]))
                ).reshape(ZERO_SHAPES[i])


def zero_grad(i: int, rank: int, step: int) -> np.ndarray:
    return rows(f"zero.grad.{i}.{step}", rank, int(np.prod(ZERO_SHAPES[i]))
                ).reshape(ZERO_SHAPES[i])


# ---------------------------------------------------------------------------
# batteries
# ---------------------------------------------------------------------------

def _t(a: np.ndarray):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _op(hvd, name: str):
    return getattr(hvd.ReduceOp, name.upper())


def _counter(metric, **labels) -> float:
    return metric.labels(**labels).value if labels else metric.total()


def run_reduction(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    from horovod_tpu_torch.ops import reduction as R
    cfg = hvd.global_state().config
    for tag, mode, op, numel, block in REDUCTION_CASES:
        cfg.quant_block_size = block
        before = _counter(R._m_wire_saved, mode=mode)
        arrays[tag] = _np(hvd.allreduce(_t(rows(tag, me, numel)),
                                        _op(hvd, op), compression=mode,
                                        name=tag))
        info[f"saved.{tag}"] = _counter(R._m_wire_saved, mode=mode) - before
    cfg.quant_block_size = 512
    for mode in ("int8", "fp8"):
        arrays[f"zero_block.{mode}"] = _np(hvd.allreduce(
            _t(zero_block_rows(me, 1024, 0.01)), hvd.Average,
            compression=hvd.Compression.int8 if mode == "int8"
            else hvd.Compression.fp8, name=f"zero_block.{mode}"))
    arrays["inctx_zero_block"] = _np(R.in_context_allreduce(
        _t(zero_block_rows(me, 512, 0.02)), None, "int8", average=True))

    # grouped: one quantized buffer over the group
    xs = [_t(rows(f"grouped.{i}", me, GROUPED[1])) for i in range(GROUPED[0])]
    for i, o in enumerate(hvd.grouped_allreduce(
            xs, hvd.Average, compression="int8", name="grouped")):
        arrays[f"grouped.{i}"] = _np(o)

    # the async engine path: one cycle, one fused int8 dispatch
    eng = hvd.global_state().engine
    eng.pause()
    hs = [hvd.allreduce_async(_t(rows(f"async.{i}", me, ASYNC_FUSED[1])),
                              hvd.Average, compression="int8",
                              name=f"async.{i}")
          for i in range(ASYNC_FUSED[0])]
    eng.resume()
    for i, h in enumerate(hs):
        arrays[f"async.{i}"] = _np(hvd.synchronize(h))

    for k in ADASUM_SIZES:
        arrays[f"adasum.{k}"] = _np(hvd.allreduce(
            _t(rows(f"adasum.{k}", me, k)), hvd.Adasum, name=f"adasum.{k}"))

    # ranks that resolve differently adopt the coordinator's echoed meta
    cfg.wire_precision = "int8" if me == 0 else "fp32"
    arrays["adopt.wp"] = _np(hvd.allreduce(
        _t(rows("adopt.wp", me, ADOPT_NUMEL)), hvd.Average, name="adopt.wp"))
    cfg.wire_precision = "fp32"
    cfg.sched_mode = "decomposed" if me == 0 else "monolithic"
    arrays["adopt.sc"] = _np(hvd.allreduce(
        _t(rows("adopt.sc", me, ADOPT_NUMEL)), hvd.Sum, name="adopt.sc"))
    cfg.sched_mode = "monolithic"

    # join at a quantized wire: rank 0 stops after one step and takes
    # part in the second with zeros at the same mode
    for step in range(1 if me == 0 else 2):
        arrays[f"join.{step}"] = _np(hvd.allreduce(
            _t(rows(f"join.{step}", me, JOIN_NUMEL)), hvd.Average,
            compression="int8", name=f"join.{step}"))
    info["join_last"] = hvd.join(timeout=60)


def run_sched(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    import torch

    from horovod_tpu_torch.ops import sched
    from horovod_tpu_torch.ops.sched import executor as SE
    from horovod_tpu_torch.ops.sched.buckets import attach_gradient_reduction
    cfg = hvd.global_state().config
    before = _counter(SE._m_sched)
    decomposed = 0
    for tag, mode, op, numel in SCHED_CASES:
        x = _t(rows(tag, me, numel))
        cfg.sched_mode = "monolithic"
        arrays[f"{tag}.mono"] = _np(hvd.allreduce(
            x, _op(hvd, op), compression=mode, name=f"{tag}.mono"))
        cfg.sched_mode = "decomposed"
        for k in SCHED_CHUNKS:
            cfg.sched_chunks = k
            arrays[f"{tag}.rs_ag{k}"] = _np(hvd.allreduce(
                x, _op(hvd, op), compression=mode, name=f"{tag}.rs_ag{k}"))
            decomposed += 1
    # pre- and postscale, and a fused group, both ways
    x = _t(rows("scaled", me, 4097))
    eng = hvd.global_state().engine
    for sm in ("monolithic", "decomposed"):
        cfg.sched_mode, cfg.sched_chunks = sm, 4
        arrays[f"scaled.{sm}"] = _np(hvd.allreduce(
            x, hvd.Sum, prescale_factor=0.5, postscale_factor=3.0,
            name=f"scaled.{sm}"))
        eng.pause()
        hs = [hvd.allreduce_async(
            _t(rows(f"fused.{i}", me, SCHED_FUSED[1])), hvd.Average,
            name=f"fused.{sm}.{i}") for i in range(SCHED_FUSED[0])]
        eng.resume()
        for i, h in enumerate(hs):
            arrays[f"fused.{sm}.{i}"] = _np(hvd.synchronize(h))
    decomposed += 2
    # a cast wire keeps the monolithic shape under "decomposed"
    arrays["cast"] = _np(hvd.allreduce(x, hvd.Average, compression="bf16",
                                       name="cast"))
    info["dispatches"] = _counter(SE._m_sched) - before
    info["dispatches_expected"] = decomposed
    info["overlap"] = SE._m_overlap.value
    # the timeline lanes of one decomposed allreduce
    path = os.path.join(os.environ["DATAPLANE_OUT"], f"tl.rank{me}.json")
    hvd.start_timeline(path)
    hvd.allreduce(_t(rows("traced", me, 4096)), hvd.Average,
                  compression="int8", name="traced")
    hvd.stop_timeline()
    cfg.sched_mode = "monolithic"

    # the eager in-context chains
    for mode in ("fp32", "int8", "fp8"):
        arrays[f"overlap_allreduce.{mode}"] = _np(sched.overlap_allreduce(
            _t(rows(f"inctx.{mode}", me, 5000)), None, average=True,
            mode=mode, chunks=INCTX_CHUNKS))
        layout = sched.chunk_layout(5000, n, INCTX_CHUNKS, mode, 512)
        flat = np.zeros(sum(layout), np.float32)
        flat[:5000] = rows(f"inctx.{mode}", me, 5000)
        arrays[f"overlap_reducescatter.{mode}"] = _np(
            sched.overlap_reducescatter(_t(flat), None, layout=layout,
                                        average=True, mode=mode))

    # buckets through the engine, and bucket boundaries on autograd
    grads = {k: _t(rows(f"bucket.{k}", me, v))
             for k, v in BUCKET_SIZES.items()}
    red = hvd.bucketed_distributed_gradients(grads,
                                             bucket_bytes=BUCKET_BYTES)
    for k, v in red.items():
        arrays[f"bucketed.{k}"] = _np(v)
        arrays[f"plain.{k}"] = _np(hvd.allreduce(grads[k], hvd.Average,
                                                 name=f"plain.{k}"))
    w = torch.nn.Parameter(_t(rows("attach.w", 0, 600)).reshape(20, 30))
    b = torch.nn.Parameter(_t(rows("attach.b", 0, 20)))
    ww, bb = attach_gradient_reduction([w, b], None, average=True,
                                       chunks=2, bucket_bytes=1024)
    xin = _t(rows("attach.x", me, 120)).reshape(4, 30)
    (xin @ ww.t() + bb).square().sum().backward()
    arrays["attach.w"], arrays["attach.b"] = _np(w.grad), _np(b.grad)
    w2 = w.detach().clone().requires_grad_()
    b2 = b.detach().clone().requires_grad_()
    (xin @ w2.t() + b2).square().sum().backward()
    arrays["attach_local.w"], arrays["attach_local.b"] = (
        _np(w2.grad), _np(b2.grad))


def _zero_run(hvd, me: int, zero: bool, compression, bucket_bytes):
    """Two Adam steps over ZERO_SHAPES with rank-seeded gradients
    (``loss = sum(p * G)``, so the gradients are exactly G)."""
    import torch
    params = [torch.nn.Parameter(_t(zero_params(i)))
              for i in range(len(ZERO_SHAPES))]
    named = [(f"p{i}", p) for i, p in enumerate(params)]
    adam = torch.optim.Adam(params, lr=ZERO_LR)
    if zero:
        opt = hvd.ZeroDistributedOptimizer(adam, compression=compression,
                                           bucket_bytes=bucket_bytes)
    else:
        opt = hvd.DistributedOptimizer(adam, named_parameters=named,
                                       compression=compression)
    for step in range(ZERO_STEPS):
        opt.zero_grad()
        loss = sum((p * _t(zero_grad(i, me, step))).sum()
                   for i, p in enumerate(params))
        loss.backward()
        opt.step()
    return params, opt


def run_zero(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    import torch

    from horovod_tpu_torch.optim import zero as Z
    cfg = hvd.global_state().config
    for tag, comp, sm, bb in ZERO_SETUPS:
        compression = getattr(hvd.Compression, comp)
        cfg.sched_mode = sm
        # The dense comparator reduces each gradient as its own group, as
        # the reference's per-tensor in-context reduce does.
        cfg.fusion_threshold = 0
        dense, dopt = _zero_run(hvd, me, False, compression, None)
        cfg.fusion_threshold = 64 * 1024 * 1024
        sharded, zopt = _zero_run(hvd, me, True, compression, bb)
        for i, (d, z) in enumerate(zip(dense, sharded)):
            arrays[f"{tag}.dense.{i}"] = _np(d)
            arrays[f"{tag}.zero.{i}"] = _np(z)
        info[f"{tag}.state_bytes"] = zopt.state_bytes()
        info[f"{tag}.gauge"] = Z._g_state_bytes.value
        info[f"{tag}.dense_state_bytes"] = sum(
            v.numel() * v.element_size() for st in dopt.state.values()
            for v in st.values() if isinstance(v, torch.Tensor))
        info[f"{tag}.shard_numel"] = zopt.plan.shard_numel
        info[f"{tag}.pieces"] = sum(len(p) for p in zopt._pieces)
        info[f"{tag}.buckets"] = len(zopt.plan.buckets)
    cfg.sched_mode = "monolithic"
    cfg.zero = True
    info["from_config.zero"] = type(Z.from_config(
        torch.optim.SGD([torch.nn.Parameter(torch.zeros(3))], lr=0.1))
    ).__name__
    cfg.zero = False
    info["from_config.dense"] = type(Z.from_config(
        torch.optim.SGD([torch.nn.Parameter(torch.zeros(3))], lr=0.1))
    ).__name__


def run_compiled(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    """The compiled schedule against the dispatched walk and monolithic
    (the reference's ``main_compiled`` battery)."""
    from horovod_tpu_torch.ops.sched import compiled as SC
    from horovod_tpu_torch.ops.sched import executor as SE
    cfg = hvd.global_state().config
    sched0, comp0 = _counter(SE._m_sched), _counter(SC._m_compiled)
    n_compiled = n_decomposed = 0
    for tag, mode, op, numel in SCHED_CASES:
        x = _t(rows(tag, me, numel))
        cfg.sched_mode = "monolithic"
        arrays[f"{tag}.mono"] = _np(hvd.allreduce(
            x, _op(hvd, op), compression=mode, name=f"{tag}.mono"))
        for k in COMPILED_CHUNKS:
            cfg.sched_chunks = k
            for sm, key in (("decomposed", "rs_ag"),
                            ("compiled", "compiled")):
                cfg.sched_mode = sm
                arrays[f"{tag}.{key}{k}"] = _np(hvd.allreduce(
                    x, _op(hvd, op), compression=mode,
                    name=f"{tag}.{key}{k}"))
            n_decomposed += 1
            n_compiled += 1
    info["sched_dispatches"] = _counter(SE._m_sched) - sched0
    info["sched_expected"] = n_decomposed
    info["compiled_dispatches"] = _counter(SC._m_compiled) - comp0
    info["compiled_expected"] = n_compiled
    info["compiled_label"] = _counter(SC._m_compiled,
                                      schedule="compiled:rs_ag:2")

    # pre- and postscale; a fused async cycle of one compiled group
    x = _t(rows("scaled", me, 4097))
    eng = hvd.global_state().engine
    cfg.sched_chunks = 2
    for sm in ("monolithic", "compiled"):
        cfg.sched_mode = sm
        arrays[f"scaled.{sm}"] = _np(hvd.allreduce(
            x, hvd.Sum, prescale_factor=0.5, postscale_factor=3.0,
            name=f"scaled.{sm}"))
        for mode in ("", "int8"):
            eng.pause()
            hs = [hvd.allreduce_async(
                _t(rows(f"cfused.{i}", me, COMPILED_FUSED[1])),
                hvd.Average, compression=mode or None,
                name=f"cfused.{sm}.{mode}.{i}")
                for i in range(COMPILED_FUSED[0])]
            eng.resume()
            for i, h in enumerate(hs):
                arrays[f"cfused.{sm}.{mode or 'fp32'}.{i}"] = _np(
                    hvd.synchronize(h))

    # mixed pins: the last rank asks for the dispatched walk, the others
    # for the compiled one; every rank adopts the echoed descriptor
    sched1, comp1 = _counter(SE._m_sched), _counter(SC._m_compiled)
    cfg.sched_mode = "decomposed" if me == n - 1 else "compiled"
    arrays["mixed"] = _np(hvd.allreduce(
        _t(rows("mixed", me, 4096)), hvd.Average, name="mixed"))
    info["mixed_sched"] = _counter(SE._m_sched) - sched1
    info["mixed_compiled"] = _counter(SC._m_compiled) - comp1

    # compiled and monolithic entries in one cycle fuse apart alike
    eng.pause()
    cfg.sched_mode = "compiled"
    ha = hvd.allreduce_async(_t(rows("mix.cmp", me, 4096)), hvd.Average,
                             name="mix.cmp")
    cfg.sched_mode = "monolithic"
    hb = hvd.allreduce_async(_t(rows("mix.mono", me, 64)), hvd.Average,
                             name="mix.mono")
    eng.resume()
    arrays["mix.cmp"] = _np(hvd.synchronize(ha))
    arrays["mix.mono"] = _np(hvd.synchronize(hb))

    # join: rank 0 stops after one step; the others rebuild the compiled
    # descriptor for its zeros from the echoed meta
    cfg.sched_mode, cfg.sched_chunks = "compiled", 2
    for step in range(1 if me == 0 else 3):
        arrays[f"cjoin.{step}"] = _np(hvd.allreduce(
            _t(rows(f"cjoin.{step}", me, COMPILED_JOIN)), hvd.Average,
            name=f"cjoin.{step}"))
    info["join_last"] = hvd.join(timeout=60)
    info["sched_total"] = _counter(SE._m_sched) - sched0
    cfg.sched_mode = "monolithic"


def run_average(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    """AVERAGE of :func:`avg_rows` in each payload dtype: monolithic, a
    fused cycle, ``rs_ag:<k>`` and ``compiled:rs_ag:<k>``."""
    import torch
    cfg = hvd.global_state().config
    eng = hvd.global_state().engine
    for dt, _ in AVG_DTYPES:
        x = _t(avg_rows(dt, me, n)).to(getattr(torch, dt))
        cfg.sched_mode = "monolithic"
        arrays[f"{dt}.mono"] = _np(hvd.allreduce(x, hvd.Average,
                                                 name=f"{dt}.mono"))
        half = AVG_NUMEL // 2
        eng.pause()
        hs = [hvd.allreduce_async(x[i * half:(i + 1) * half], hvd.Average,
                                  name=f"{dt}.fused.{i}") for i in (0, 1)]
        eng.resume()
        arrays[f"{dt}.fused"] = np.concatenate(
            [_np(hvd.synchronize(h)) for h in hs])
        for k in AVG_CHUNKS:
            cfg.sched_chunks = k
            for sm, key in (("decomposed", "rs_ag"),
                            ("compiled", "compiled")):
                cfg.sched_mode = sm
                arrays[f"{dt}.{key}{k}"] = _np(hvd.allreduce(
                    x, hvd.Average, name=f"{dt}.{key}{k}"))
    cfg.sched_mode = "monolithic"


def run_hier(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    """The two tiers at np=4 as 2 x 2 (the knobs of :data:`HIER_ENV`):
    each case flat (monolithic and ``rs_ag``) and through ``hier:2:2``;
    the monolithic route, single, fused and grouped; the flat fallbacks;
    the compiled request; the gauges; the standalone entries."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import hierarchical as H
    from horovod_tpu_torch.ops.sched import compiled as CP
    from horovod_tpu_torch.ops.sched import executor as SE
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh
    cfg = hvd.global_state().config
    info["split"] = C._hier_split(None)
    groups = hvd.global_state().tier_groups[(2, 2)]
    info["local_ranks"] = dist.get_process_group_ranks(groups["hvd_local"][0])
    info["cross_ranks"] = dist.get_process_group_ranks(groups["hvd_cross"][0])
    routes = {"n": 0}
    real = H.hierarchical_allreduce_

    def counting(*a, **kw):
        routes["n"] += 1
        return real(*a, **kw)

    H.hierarchical_allreduce_ = counting
    hier = SE._m_sched.labels(schedule="hier:2:2")
    cfg.sched_chunks = HIER_CHUNKS
    for tag, mode, op, numel, cross in HIER_CASES:
        x = _t(rows(tag, me, numel))
        cfg.hierarchical_cross_precision = cross
        cfg.hierarchical_allreduce = False
        for sm, key in (("monolithic", "flat"), ("decomposed", "rs_ag")):
            cfg.sched_mode = sm
            arrays[f"{tag}.{key}"] = _np(hvd.allreduce(
                x, _op(hvd, op), compression=mode, name=f"{tag}.{key}"))
        cfg.hierarchical_allreduce = True
        before = hier.value
        arrays[f"{tag}.hier"] = _np(hvd.allreduce(
            x, _op(hvd, op), compression=mode, name=f"{tag}.hier"))
        info[f"{tag}.hier_dispatches"] = hier.value - before
    cfg.hierarchical_cross_precision = ""
    x = _t(rows("scaled", me, HIER_NUMEL))
    arrays["scaled.hier"] = _np(hvd.allreduce(
        x, hvd.Sum, prescale_factor=0.5, postscale_factor=2.0,
        name="scaled.hier"))
    cfg.hierarchical_allreduce = False
    cfg.sched_mode = "monolithic"
    arrays["scaled.flat"] = _np(hvd.allreduce(
        x, hvd.Sum, prescale_factor=0.5, postscale_factor=2.0,
        name="scaled.flat"))

    # the monolithic two-tier route: single, fused in one cycle, grouped
    eng = hvd.global_state().engine
    x = _t(rows("mono", me, HIER_NUMEL))
    for flag in (False, True):
        cfg.hierarchical_allreduce = flag
        key = "tiers" if flag else "flat"
        r0 = routes["n"]
        for op in ("average", "sum"):
            arrays[f"mono.{op}.{key}"] = _np(hvd.allreduce(
                x, _op(hvd, op), name=f"mono.{op}.{key}"))
        eng.pause()
        hs = [hvd.allreduce_async(_t(rows(f"fused.{i}", me, HIER_FUSED[1])),
                                  hvd.Average, name=f"fused.{key}.{i}")
              for i in range(HIER_FUSED[0])]
        eng.resume()
        for i, h in enumerate(hs):
            arrays[f"fused.{key}.{i}"] = _np(hvd.synchronize(h))
        outs = hvd.grouped_allreduce([x, 2 * x], hvd.Sum,
                                     name=f"grouped.{key}")
        for i, o in enumerate(outs):
            arrays[f"grouped.{key}.{i}"] = _np(o)
        info[f"mono_routes.{key}"] = routes["n"] - r0
    # an integer AVERAGE keeps the flat path (floor division)
    r0 = routes["n"]
    arrays["int.average"] = _np(hvd.allreduce(
        torch.full((3,), me, dtype=torch.int32), hvd.Average, name="int"))
    info["int_routes"] = routes["n"] - r0
    # invalid splits fall back to flat
    for ls in (3, 1, 4):
        cfg.hierarchical_local_size = ls
        r0 = routes["n"]
        info[f"invalid{ls}.split"] = C._hier_split(None)
        arrays[f"invalid{ls}"] = _np(hvd.allreduce(x, hvd.Average,
                                                   name=f"invalid{ls}"))
        info[f"invalid{ls}.routes"] = routes["n"] - r0
    cfg.hierarchical_local_size = 2
    ps = hvd.add_process_set([0, 2])
    r0 = routes["n"]
    if me in (0, 2):
        arrays["ps"] = _np(hvd.allreduce(x, hvd.Average, name="ps",
                                         process_set=ps))
    info["ps_routes"] = routes["n"] - r0
    # a compiled request under the split runs the dispatched hier: walk
    cfg.sched_mode = "compiled"
    before = (hier.value, CP._m_compiled.total())
    arrays["compiled"] = _np(hvd.allreduce(
        _t(rows("compiled", me, 5000)), hvd.Average, name="compiled"))
    info["compiled.hier_dispatches"] = hier.value - before[0]
    info["compiled.compiled_dispatches"] = \
        CP._m_compiled.total() - before[1]
    cfg.sched_mode = "monolithic"
    info["prometheus"] = hvd.metrics("prometheus")
    H.hierarchical_allreduce_ = real

    # the standalone entries over a 2-D mesh of the reference's axes
    mesh = build_mesh(MeshConfig(dp=2, tp=2))
    y = _t(rows("standalone", me, 1001))
    arrays["standalone.sum"] = _np(H.hierarchical_allreduce(
        y, mesh, local_axis="tp", cross_axis="dp"))
    arrays["standalone.average"] = _np(H.hierarchical_allreduce(
        y, mesh, local_axis="tp", cross_axis="dp", average=True))
    g = {a: (mesh.get_group(a), 2) for a in ("tp", "dp")}
    arrays["allgather"] = _np(H.hierarchical_allgather_local(
        _t(rows("allgather", me, 6)).reshape(2, 3), g, local_axis="tp",
        cross_axis="dp"))


def run_parallel(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    """The mesh and the MoE layers at world size n: ``moe_layer`` at
    ep = n on the oracle's case and on the capacity-drop case,
    ``moe_layer_hvd`` on the capacity oracle's case."""
    import torch.distributed as dist

    from horovod_tpu_torch.parallel import MeshConfig, build_mesh, moe
    mesh = build_mesh(MeshConfig(ep=n))
    info["ep_ranks"] = dist.get_process_group_ranks(mesh.get_group("ep"))
    info["mesh_shape"] = list(mesh.mesh.shape)
    info["mesh_names"] = list(mesh.mesh_dim_names)
    auto = build_mesh(MeshConfig.auto(n))
    info["auto_tp_ranks"] = dist.get_process_group_ranks(
        auto.get_group("tp"))
    try:
        build_mesh(MeshConfig(dp=3))
    except ValueError as e:
        info["wrong_count"] = str(e)

    def expert(w, x):
        return x @ w

    for tag, (tokens, router, we), cf in (
            ("ep", moe_ep_inputs(), float(MOE_EP["E"])),
            ("drop", moe_drop_inputs(), MOE_DROP["cf"])):
        t_loc, e_loc = tokens.shape[0] // n, we.shape[0] // n
        fam = moe._m_dropped.labels(layer=f"t_{tag}")
        before = fam.value
        out, aux = moe.moe_layer(
            _t(tokens[me * t_loc:(me + 1) * t_loc]), _t(router), expert,
            _t(we[me * e_loc:(me + 1) * e_loc]), mesh, capacity_factor=cf,
            layer=f"t_{tag}")
        arrays[f"moe.{tag}"] = _np(out)
        info[f"moe.{tag}.aux"] = float(aux)
        info[f"moe.{tag}.drops"] = fam.value - before

    router, w, toks = moe_hvd_inputs(n)
    e_loc = MOE_HVD["E"] // n
    fam = moe._m_dropped.labels(layer="t_hvd")
    before = fam.value
    out, aux, dropped = moe.moe_layer_hvd(
        _t(toks[me]), _t(router), expert,
        _t(w[me * e_loc:(me + 1) * e_loc]), capacity_factor=MOE_HVD["cf"],
        layer="t_hvd")
    arrays["hvd"] = _np(out)
    info.update({"hvd.aux": aux, "hvd.dropped": dropped,
                 "hvd.counted": fam.value - before})


def run_chaos_moe(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    """The chaos harness's expert-parallel layer, step by step, on the
    inputs its worker draws."""
    from horovod_tpu_torch.chaos import run as chaos_run
    from horovod_tpu_torch.parallel import moe
    fam = moe._m_dropped.labels(layer="chaos")
    for step in range(CHAOS_STEPS):
        before = fam.value
        out, aux, dropped = chaos_run.moe_layer(
            *chaos_run.moe_inputs(me, n, step))
        arrays[f"step{step}"] = _np(out)
        info[f"step{step}"] = {"aux": aux, "dropped": dropped,
                               "counted": fam.value - before}


BATTERIES = {"reduction": run_reduction, "sched": run_sched,
             "zero": run_zero, "compiled": run_compiled,
             "average": run_average, "hier": run_hier,
             "parallel": run_parallel, "chaos_moe": run_chaos_moe}


def main(mode: str, outdir: str) -> int:
    sys.path.insert(0, W.REPO)
    import horovod_tpu_torch as hvd
    os.environ["DATAPLANE_OUT"] = outdir
    hvd.init()
    me, n = hvd.rank(), hvd.size()
    arrays: dict = {}
    info: dict = {"jax_loaded": any(
        m == "jax" or m.startswith(("jax.", "jaxlib"))
        or m.split(".")[0] == "horovod_tpu" for m in list(sys.modules))}
    BATTERIES[mode](hvd, me, n, arrays, info)
    np.savez(os.path.join(outdir, f"{mode}.rank{me}.npz"), **arrays)
    with open(os.path.join(outdir, f"{mode}.rank{me}.json"), "w") as f:
        json.dump(info, f)
    hvd.shutdown()
    print(f"rank {me}: {mode} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))

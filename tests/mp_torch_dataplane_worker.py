"""Multi-process worker of the port's collective data plane parity tests.

``launch(mode, outdir, np_)`` runs ``np_`` copies of this script, one rank
each, through the port's launcher on the CPU over Gloo (the machinery of
``tests/mp_torch_port_worker.py``), with ``HVDTPU_QUANT_MIN_BYTES=0``.
Every rank runs the battery of ``mode`` (``reduction``, ``sched`` or
``zero``) and writes what it got to ``outdir/<mode>.rank<r>.npz`` and
``.json``; ``tests/test_torch_reduction.py``, ``_sched.py`` and
``_zero.py`` compare it with the JAX package run in-process on the same
rows, which the functions below make with numpy from fixed seeds.
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


def launch(mode: str, outdir: str, np_: int, timeout: float = 150) -> list:
    return W.launch(mode, outdir, np_=np_, timeout=timeout, extra_env=ENV,
                    script=__file__)


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


BATTERIES = {"reduction": run_reduction, "sched": run_sched,
             "zero": run_zero}


def main(mode: str, outdir: str) -> int:
    sys.path.insert(0, W.REPO)
    import horovod_tpu_torch as hvd
    os.environ["DATAPLANE_OUT"] = outdir
    hvd.init()
    me, n = hvd.rank(), hvd.size()
    arrays: dict = {}
    info: dict = {"jax_loaded": any(
        m == "jax" or m.startswith(("jax.", "jaxlib"))
        or m.split(".")[0] == "horovod_tpu" for m in sys.modules)}
    BATTERIES[mode](hvd, me, n, arrays, info)
    np.savez(os.path.join(outdir, f"{mode}.rank{me}.npz"), **arrays)
    with open(os.path.join(outdir, f"{mode}.rank{me}.json"), "w") as f:
        json.dump(info, f)
    hvd.shutdown()
    print(f"rank {me}: {mode} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))

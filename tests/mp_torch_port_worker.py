"""Multi-process worker of the port's runtime parity tests.

``launch(mode, outdir)`` runs ``np`` copies of this script, one rank each,
through the port's launcher::

    python -m horovod_tpu_torch.runner -np 2 --platform cpu --verbose \
        -- python tests/mp_torch_port_worker.py <mode> <outdir>

so every rank gets the env ``hvdrun`` injects (the native controller and KV
store with the job's secret, rank 0's store port, ``HVDTPU_LOCAL_RANK``)
and runs on the CPU over Gloo.  Every rank runs the battery of ``mode`` and
writes what it got to ``outdir/<mode>.rank<r>.npz`` (arrays) and ``.json``
(everything else); the test files compare that with the JAX package run
in-process.

The worker imports the port and never jax: each rank also records
whether ``jax`` reached ``sys.modules`` after ``init``.

Inputs are made with numpy from fixed seeds by the functions below, which
the tests import to build the same inputs for the JAX side.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NP = 2

# ---------------------------------------------------------------------------
# inputs (shared with the tests)
# ---------------------------------------------------------------------------

OPS = ("average", "sum", "min", "max", "product")
DTYPES = ("float32", "bfloat16", "int32")


def _case(name, verb, dtype="float32", **kw) -> dict:
    return dict(name=name, verb=verb, dtype=dtype, **kw)


COLLECTIVE_CASES = (
    [_case(f"allreduce.{op}.{dt}", "allreduce", dt, op=op)
     for op in OPS for dt in DTYPES]
    + [_case("allreduce.scaled", "allreduce", op="sum", prescale=0.5,
             postscale=3.0),
       _case("allreduce.process_set", "allreduce", op="sum", ps="all"),
       _case("allreduce.one_rank_set", "allreduce", op="sum", ps="one"),
       _case("grouped_allreduce", "grouped_allreduce", op="average"),
       _case("grouped_allreduce_sync", "grouped_allreduce_sync", op="sum"),
       _case("reducescatter.sum", "reducescatter", op="sum", rows=4),
       _case("reducescatter.average", "reducescatter", op="average",
             rows=4),
       _case("alltoall", "alltoall", rows=4),
       _case("alltoall.splits", "alltoall", splits=((1, 2), (3, 1))),
       _case("allgather.ragged", "allgather", ragged=True),
       _case("allreduce_.in_place", "allreduce_", op="average"),
       _case("allreduce_async_.in_place", "allreduce_async_", op="max"),
       _case("broadcast_.in_place", "broadcast_", root=1)]
    + [_case(f"allgather.{dt}", "allgather", dt) for dt in DTYPES]
    + [_case(f"broadcast.root1.{dt}", "broadcast", dt, root=1)
       for dt in DTYPES])


def case_input(case: dict, rank: int, part: int = 0) -> np.ndarray:
    """Rank ``rank``'s input to ``case`` (float32 or int32; a bfloat16
    case's values are exact in bfloat16)."""
    seed = (zlib.crc32(case["name"].encode()) + 1000 * part + rank) % 2**31
    rng = np.random.RandomState(seed)
    rows = case.get("rows", 5)
    if case.get("ragged"):
        rows = 2 + rank
    if case.get("splits"):
        rows = sum(case["splits"][rank])
    shape = (rows, 3)
    if case["dtype"] == "int32":
        lo, hi = (-3, 4) if case.get("op") == "product" else (-20, 20)
        return rng.randint(lo, hi, shape).astype(np.int32)
    if case["dtype"] == "bfloat16":
        return (rng.randint(-64, 64, shape) / 8.0).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def join_input(rank: int, step: int) -> np.ndarray:
    return np.full((4,), float(rank + 1 + step), np.float32)


def engine_input(tag: str, rank: int, i: int, n: int = 5) -> np.ndarray:
    seed = (zlib.crc32(tag.encode()) + 97 * i + rank) % 2**31
    return np.random.RandomState(seed).randn(n).astype(np.float32)


OBS_ALLREDUCES = 3         # allreduces of the obs battery before publishing
ENGINE_FUSED = 20          # tensors enqueued in one cycle
ENGINE_THRESHOLD = 4       # tensors of 8 floats under a 40-byte threshold
JOIN_STEPS = (3, 5)        # steps of rank 0 and rank 1 before join()
PLANE_STEPS = 12           # traced steps of the plane battery
PLANE_SIZES = (1000, 300_000, 50, 200_000, 7, 262_144)   # floats a step
PLANE_CAPS = (4096, 64 << 20)  # rank 0's and rank 1's own group caps
PLANE_ALERT = "busy"
PLANE_ENV = {
    "HVDTPU_SLO": "cycle=p99(cycle) < 250ms over 5m",
    "HVDTPU_ALERTS": f"{PLANE_ALERT}: rate(hvd_collectives_total[10s]) > 0 "
                     ": info",
    "HVDTPU_TSDB_INTERVAL": "0.2", "HVDTPU_PROF_HZ": "100",
    "HVDTPU_AUTOTUNE_WARMUP_SAMPLES": "1",
    "HVDTPU_AUTOTUNE_STEPS_PER_SAMPLE": "2"}

# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _rank_outputs(stdout: str, stderr: str, np_: int) -> list:
    """Split the launcher's output by its ``[r]<stdout>: `` prefixes and
    read each rank's exit code from its ``[launcher] rank r exited c``
    lines (``--verbose``); a rank with no such line did not exit by
    itself (None).  The launcher's own stderr ends every rank's text."""
    texts: list = [[] for _ in range(np_)]
    for line in stdout.splitlines(keepends=True):
        head, sep, rest = line.partition("]<stdout>: ")
        if sep and head.startswith("[") and head[1:].isdigit() \
                and int(head[1:]) < np_:
            texts[int(head[1:])].append(rest)
    codes: list = [None] * np_
    for line in stderr.splitlines():
        words = line.split()
        if words[:2] == ["[launcher]", "rank"] and len(words) == 5 \
                and words[3] == "exited":
            codes[int(words[2])] = int(words[4])
    return [(codes[r], "".join(texts[r]) + "\n[launcher stderr]\n" + stderr)
            for r in range(np_)]


def launch(mode: str, outdir: str, *, np_: int = NP, timeout: float = 120,
           extra_env: dict | None = None, flags: tuple = (),
           script: str = __file__) -> list:
    """Run ``mode`` of ``script`` (this worker by default) on ``np_``
    ranks through the port's launcher, with the launcher's ``flags``;
    returns each rank's (exit code, output).  At ``timeout`` seconds the launcher
    is sent SIGTERM, on which it kills every rank still running, and those
    ranks report exit code None, so a hang fails its test instead of
    eating the suite's time."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env.update(extra_env or {})
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(np_), "--platform", "cpu", "--verbose", *flags, "--",
           sys.executable, os.path.abspath(script), mode, outdir]
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        err += f"\n[test] launcher stopped after {timeout} s\n"
    return _rank_outputs(out, err, np_)


# ---------------------------------------------------------------------------
# the batteries (run in the worker processes)
# ---------------------------------------------------------------------------

def _t(a: np.ndarray, dtype: str):
    import torch
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(getattr(torch, dtype))


def _np(t) -> np.ndarray:
    import torch
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _op(hvd, name: str):
    return getattr(hvd.ReduceOp, name.upper())


def run_collectives(hvd, me: int, arrays: dict, info: dict) -> None:
    # Every call is named: the one-rank set's call raises on rank 0
    # only, and unnamed calls after it would be numbered differently on
    # the two ranks († the same holds upstream).
    sets = {"all": hvd.add_process_set([0, 1]),
            "one": hvd.add_process_set([1])}
    for case in COLLECTIVE_CASES:
        name, verb, dt = case["name"], case["verb"], case["dtype"]
        x = _t(case_input(case, me), dt)
        ps = sets.get(case.get("ps"))
        if ps is not None and not ps.included(me):
            try:
                hvd.allreduce(x, hvd.Sum, name=name, process_set=ps)
            except ValueError as e:
                info[f"{name}.error"] = str(e)
            continue
        if verb == "allreduce":
            out = hvd.allreduce(x, _op(hvd, case["op"]),
                                prescale_factor=case.get("prescale", 1.0),
                                postscale_factor=case.get("postscale", 1.0),
                                name=name, process_set=ps)
        elif verb.startswith("grouped_allreduce"):
            xs = [_t(case_input(case, me, part), dt) for part in range(3)]
            for i, o in enumerate(getattr(hvd, verb)(
                    xs, _op(hvd, case["op"]), name=name)):
                arrays[f"{name}.{i}"] = _np(o)
            continue
        elif verb == "reducescatter":
            out = hvd.reducescatter(x, _op(hvd, case["op"]), name=name)
        elif verb == "alltoall":
            out = hvd.alltoall(x, splits=case["splits"][me]
                               if case.get("splits") else None, name=name)
        elif verb == "allgather":
            out = hvd.allgather(x, name=name)
        elif verb == "broadcast":
            out = hvd.broadcast(x, case["root"], name=name)
        elif verb == "allreduce_":
            out = hvd.allreduce_(x, _op(hvd, case["op"]), name=name)
        elif verb == "allreduce_async_":
            out = hvd.synchronize(hvd.allreduce_async_(
                x, _op(hvd, case["op"]), name=name))
        elif verb == "broadcast_":
            out = hvd.broadcast_(x, case["root"], name=name)
        if verb.endswith("_"):
            info[f"{name}.same_tensor"] = out.data_ptr() == x.data_ptr()
        arrays[name] = _np(out)


def run_engine(hvd, me: int, arrays: dict, info: dict) -> None:
    import torch

    from horovod_tpu_torch.ops import engine as E
    eng = hvd.global_state().engine
    state = hvd.global_state()

    # async roundtrip
    h = hvd.allreduce_async(_t(engine_input("rt", me, 0), "float32"),
                            name="t.async")
    arrays["roundtrip"] = _np(hvd.synchronize(h))
    info["roundtrip_polled"] = hvd.poll(h)

    # fusion: ENGINE_FUSED tensors in one cycle -> one fused dispatch
    before = E._m_fusion_batch._default().cumulative_buckets()
    eng.pause()
    hs = [hvd.allreduce_async(_t(engine_input("fused", me, i), "float32"),
                              hvd.Sum, name=f"t.fused.{i}")
          for i in range(ENGINE_FUSED)]
    eng.resume()
    for i, h in enumerate(hs):
        arrays[f"fused.{i}"] = _np(hvd.synchronize(h))
    after = E._m_fusion_batch._default().cumulative_buckets()
    info["fusion_batches"] = [a[1] - b[1] for a, b in zip(after, before)]

    # threshold: 32-byte tensors under a 40-byte threshold never fuse
    old = state.config.fusion_threshold
    state.config.fusion_threshold = 40
    before = E._m_fusion_batch._default().cumulative_buckets()
    eng.pause()
    hs = [hvd.allreduce_async(
        _t(engine_input("thresh", me, i, 8), "float32"), hvd.Sum,
        name=f"t.thresh.{i}") for i in range(ENGINE_THRESHOLD)]
    eng.resume()
    for i, h in enumerate(hs):
        arrays[f"thresh.{i}"] = _np(hvd.synchronize(h))
    after = E._m_fusion_batch._default().cumulative_buckets()
    info["threshold_batches"] = [a[1] - b[1] for a, b in zip(after, before)]
    state.config.fusion_threshold = old

    # duplicate in-flight name
    x = torch.zeros(10)
    eng.pause()
    h1 = hvd.allreduce_async(x, name="t.dup")
    h2 = hvd.allreduce_async(x, name="t.dup")
    eng.resume()
    try:
        hvd.synchronize(h2)
        info["duplicate"] = "no error"
    except hvd.HorovodInternalError as e:
        info["duplicate"] = str(e)
    hvd.synchronize(h1)

    # an error at dispatch reaches the handle on every rank
    try:
        hvd.synchronize(hvd.alltoall_async(torch.zeros(5), name="t.err"))
        info["dispatch_error"] = "no error"
    except hvd.HorovodInternalError as e:
        info["dispatch_error"] = str(e)

    # a negotiator that fails fails the handles, then the name is free
    class Exploding(E.Negotiator):
        def negotiate(self, entries, *, joined=False):
            raise ConnectionError("controller gone")

    real = eng._negotiator
    eng._negotiator = Exploding()
    try:
        hvd.synchronize(hvd.allreduce_async(torch.ones(2), name="t.neg"))
        info["negotiator_error"] = "no error"
    except hvd.HorovodInternalError as e:
        info["negotiator_error"] = str(e)
    finally:
        eng._negotiator = real
    arrays["negotiator_retry"] = _np(hvd.allreduce(
        torch.full((2,), float(me)), hvd.Sum, name="t.neg"))

    # join: rank 0 stops after JOIN_STEPS[0] steps, rank 1 runs on; the
    # joined rank takes part with zeros and Average divides by 2
    for step in range(JOIN_STEPS[me]):
        arrays[f"join.{step}"] = _np(hvd.allreduce(
            _t(join_input(me, step), "float32"), hvd.Average,
            name=f"t.join.{step}"))
    info["join_last"] = hvd.join(timeout=60)
    info["cycles"] = eng.cycle_count


def run_runtime(hvd, me: int, arrays: dict, info: dict) -> None:
    import torch
    info["launcher_env"] = sorted(
        k for k in ("HVDTPU_SECRET", "HVDTPU_CONTROLLER_ADDR",
                    "HVDTPU_RENDEZVOUS_ADDR", "HVDTPU_COORDINATOR_ADDR",
                    "HVDTPU_LOCAL_RANK", "HVDTPU_PLATFORM")
        if os.environ.get(k))
    info.update(rank=hvd.rank(), size=hvd.size(),
                local_rank=hvd.local_rank(), local_size=hvd.local_size(),
                cross_rank=hvd.cross_rank(), cross_size=hvd.cross_size(),
                backend=hvd.global_state().backend,
                device=str(hvd.global_state().device),
                gloo_enabled=hvd.gloo_enabled(),
                distributed=hvd.global_state().engine.distributed)
    hvd.barrier()
    info["object"] = hvd.broadcast_object({"from": me, "x": [me] * 3}, 1)
    info["objects"] = hvd.allgather_object(("rank", me))
    ps = hvd.add_process_set([1])
    info["set"] = [ps.size(), ps.included(me), ps.ranks[0]]
    hvd.barrier(process_set=hvd.global_process_set())
    # shutdown and a second init in the same processes
    hvd.shutdown()
    hvd.init()
    arrays["after_reinit"] = _np(hvd.allreduce(
        torch.full((3,), float(me + 1)), hvd.Sum, name="reinit"))


def _tiny_llama():
    import torch

    from horovod_tpu_torch.models import llama as tllama
    cfg = tllama.LlamaConfig.tiny(**LLAMA_DIMS)
    return torch, tllama, cfg


LLAMA_DIMS = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                  d_ff=256, vocab_size=128)
LLAMA_LR = 1e-2
# DistributedOptimizer's Adasum and quantized wires (above the default
# 64 KiB quantization floor)
OPT_WIRES = {"adasum": {"op": "Adasum"}, "int8": {"compression": "int8"},
             "fp8": {"compression": "fp8"}}
OPT_WIRE_SHAPE = (4, 4250)
LLAMA_STEPS = 2


def _load_params(outdir: str) -> dict:
    """The JAX package's initial parameters, which the test saved."""
    with np.load(os.path.join(outdir, "llama_params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree: dict = {"layers": {}}
    for k, v in flat.items():
        if k.startswith("layers."):
            tree["layers"][k.split(".", 1)[1]] = v
        else:
            tree[k] = v
    return tree


def run_optimizer(hvd, me: int, arrays: dict, info: dict,
                  outdir: str) -> None:
    torch, tllama, cfg = _tiny_llama()

    # two data-parallel Adam steps of a tiny Llama, one sequence a rank
    params = tllama.params_from_jax(_load_params(outdir), device="cpu")
    named = tllama.named_trainable(params)
    hvd.broadcast_parameters(named, root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam([t for _, t in named], lr=LLAMA_LR, eps=1e-8),
        named_parameters=named)
    step = tllama.make_train_step(cfg, opt)
    tokens = np.load(os.path.join(outdir, "llama_tokens.npy"))
    batch = {"tokens": torch.from_numpy(tokens[me:me + 1])}
    arrays["llama.losses"] = np.array(
        [step(params, batch).item() for _ in range(LLAMA_STEPS)])
    for name, t in named:
        arrays[f"llama.{name}"] = _np(t)

    # bucket_cap_bytes: accepted, and the averaged gradients are those of
    # the same optimizer without it
    for cap in (None, 64):
        torch.manual_seed(0)
        lin = torch.nn.Linear(4, 3)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(lin.parameters(), lr=0.5),
            named_parameters=lin.named_parameters(), bucket_cap_bytes=cap)
        x = torch.from_numpy(engine_input("bucket", me, 0, 8)).reshape(2, 4)
        lin(x).square().sum().backward()
        opt.synchronize()
        arrays[f"bucket_cap.{cap}.grad"] = _np(lin.weight.grad)

    # backward_passes_per_step: two local passes, one allreduce
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.5),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2)
    for k in range(2):
        x = torch.from_numpy(engine_input("bpps", me, k, 8)).reshape(2, 4)
        model(x).square().sum().backward()
    opt.step()
    arrays["bpps.weight"] = _np(model.weight)
    arrays["bpps.bias"] = _np(model.bias)
    # step too early: one pass of two
    opt.zero_grad()
    model(torch.ones(2, 4)).sum().backward()
    try:
        opt.step()
        info["too_early"] = "no error"
    except RuntimeError as e:
        info["too_early"] = str(e)
    # step before every gradient was reduced
    opt2 = hvd.DistributedOptimizer(
        torch.optim.SGD(torch.nn.Linear(2, 2).parameters(), lr=0.1))
    try:
        opt2.step()
        info["missing"] = "no error"
    except RuntimeError as e:
        info["missing"] = str(e)

    # broadcasts of parameters and optimizer state from root 1
    torch.manual_seed(100 + me)
    net = torch.nn.Linear(3, 2)
    adam = torch.optim.Adam(net.parameters(), lr=0.1)
    net(torch.randn(4, 3)).sum().backward()
    adam.step()
    hvd.broadcast_parameters(net.state_dict(), root_rank=1)
    hvd.broadcast_optimizer_state(adam, root_rank=1)
    arrays["bcast.weight"] = _np(net.weight)
    st = adam.state[net.weight]
    arrays["bcast.exp_avg"] = _np(st["exp_avg"])
    arrays["bcast.step"] = _np(torch.as_tensor(st["step"]))

    # fp16 compression: a bfloat16 wire
    g = torch.from_numpy(engine_input("fp16", me, 0, 16))
    arrays["fp16"] = _np(hvd.allreduce(
        g, hvd.Average, compression=hvd.Compression.fp16))
    arrays["fp16_ieee"] = _np(hvd.allreduce(
        g, hvd.Average, compression=hvd.Compression.fp16_ieee))

    # Adasum and the quantized wires through the optimizer: one weight
    # above the quantization floor whose gradient is this rank's G
    for key, kw in OPT_WIRES.items():
        w = torch.nn.Parameter(torch.zeros(OPT_WIRE_SHAPE))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w], lr=1.0), named_parameters=[(key, w)],
            **{k: getattr(hvd.Compression, v) if k == "compression"
               else getattr(hvd, v) for k, v in kw.items()})
        g = engine_input(f"opt.{key}", me, 0, int(np.prod(OPT_WIRE_SHAPE)))
        (w * torch.from_numpy(g).reshape(OPT_WIRE_SHAPE)).sum().backward()
        opt.synchronize()
        arrays[f"opt.{key}"] = _np(w.grad)

    # SyncBatchNorm over the joined batch of both ranks
    sbn = hvd.SyncBatchNorm(3)
    x = torch.from_numpy(np.random.RandomState(7).randn(
        2 * NP, 3, 5, 5).astype(np.float32))[2 * me:2 * me + 2]
    x.requires_grad_(True)
    y = sbn(x)
    y.square().sum().backward()
    for k, v in (("y", y), ("dx", x.grad), ("dw", sbn.weight.grad),
                 ("db", sbn.bias.grad), ("rm", sbn.running_mean),
                 ("rv", sbn.running_var)):
        arrays[f"sbn.{k}"] = _np(v)


def run_obs(hvd, me: int, arrays: dict, info: dict, outdir: str) -> None:
    """The metrics plane under the launcher: every rank publishes its
    registry after ``OBS_ALLREDUCES`` named allreduces; rank 0 reads the
    merged view; the rank that bound ``HVDTPU_METRICS_PORT`` (if any)
    holds its ``/metrics`` against ``hvd.metrics("prometheus")``; every
    rank writes a flight-recorder bundle."""
    import time
    import urllib.request

    import torch

    from horovod_tpu_torch.obs import aggregate, prof

    info["launcher_env"] = sorted(
        k for k in ("HVDTPU_SECRET", "HVDTPU_CONTROLLER_ADDR",
                    "HVDTPU_RENDEZVOUS_ADDR") if os.environ.get(k))
    for i in range(OBS_ALLREDUCES):
        hvd.allreduce(torch.ones(4), hvd.Sum, name=f"obs.{i}")
    info["published"] = aggregate.publish_now()
    info["own"] = _collectives(hvd.metrics())
    hvd.barrier(process_set=hvd.global_process_set())  # all published
    if me == 0:
        info["cluster"] = _collectives(hvd.cluster_metrics(), by_rank=True)
        info["registry_at_cluster"] = _collectives(hvd.metrics())
    srv = hvd.global_state().metrics_server
    info["bound_metrics_port"] = srv is not None
    if srv is not None:
        # Let the engine's thread close the cycle that served the barrier
        # (its cycle histogram): two equal reads 0.2 s apart.  The
        # sampling profiler counts its ticks into the registry 10 times a
        # second, so it pauses for the reads.
        prof.PROFILER.stop()
        text = hvd.metrics("prometheus")
        for _ in range(50):
            time.sleep(0.2)
            again, text = text, hvd.metrics("prometheus")
            if again == text:
                break
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            info["metrics_equal"] = r.read().decode() == text
        prof.PROFILER.start()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/cluster", timeout=10) as r:
            info["cluster_http_ok"] = r.status == 200
    path = hvd.flight_record(os.path.join(outdir, f"flight.rank{me}.json"))
    with open(path) as fh:
        bundle = json.load(fh)
    info["flight"] = [bundle["rank"], bundle["size"], bundle["reason"]]
    hvd.barrier(process_set=hvd.global_process_set())  # rank 0 has read


def run_plane(hvd, me: int, arrays: dict, info: dict, outdir: str) -> None:
    """The rest of the observability plane at two ranks, armed by the env
    (``PLANE_ENV``) and the launcher's ``--autotune``: ranks with
    different group caps fuse one cycle alike; ``PLANE_STEPS`` traced
    steps of allreduces the tuner retunes; then the performance model's
    series, the profiler's engine phases, the SLO and the alert, and rank
    0's merged ``/tracez`` (``/profz.json`` and ``/alertz.json`` beside
    it) while rank 1 still answers its clock pings."""
    import time
    import urllib.request

    from horovod_tpu_torch.obs import alerts, prof, server, slo, tracemerge
    from horovod_tpu_torch.obs import trace

    cfg = hvd.global_state().config
    info["config"] = [cfg.autotune, cfg.autotune_log, cfg.slo, cfg.alerts]
    eng = hvd.global_state().engine
    # one cycle of eight 4000-byte tensors under caps of 4096 and 64 MB
    cfg.fusion_threshold = PLANE_CAPS[me]
    eng.pause()
    hs = [hvd.allreduce_async(_t(engine_input("caps", me, i, 1000),
                                 "float32"), hvd.Sum, name=f"caps.{i}")
          for i in range(8)]
    eng.resume()
    for i, h in enumerate(hs):
        arrays[f"caps.{i}"] = _np(hvd.synchronize(h))
    for i in range(PLANE_STEPS):
        with trace.start_trace("plane.step", lane="steps", step=i):
            eng.pause()
            hs = [hvd.allreduce_async(
                _t(engine_input("plane", me, i * 10 + j, n), "float32"),
                hvd.Sum, name=f"plane.{i}.{j}")
                for j, n in enumerate(PLANE_SIZES)]
            eng.resume()
            for j, h in enumerate(hs):
                arrays[f"plane.{i}.{j}"] = _np(hvd.synchronize(h))
    snap = hvd.metrics()
    info["perf"] = {f["name"]: [[s["labels"], s["value"]]
                                for s in f["samples"]]
                    for f in snap if f["name"].startswith("hvd_perf_")}
    info["knobs"] = [cfg.fusion_threshold, cfg.cycle_time_ms,
                     cfg.bucket_bytes]
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and \
            alerts.status()["firing"] == 0:
        time.sleep(0.1)
    info["alerts"] = alerts.status()
    info["slo"] = slo.status()
    info["engine_phases"] = prof.PROFILER.snapshot()["engine_phases"]
    info["published"] = tracemerge.publish_now()
    hvd.barrier(process_set=hvd.global_process_set())  # both published
    if me == 0:
        srv = server.MetricsServer(0, addr="127.0.0.1")
        try:
            for path in ("/tracez", "/profz.json", "/alertz.json"):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}{path}",
                        timeout=30) as r:
                    info[path] = json.loads(r.read().decode())
        finally:
            srv.close()
    hvd.barrier(process_set=hvd.global_process_set())  # rank 0 has read


def _collectives(snap: list, by_rank: bool = False) -> dict:
    """``hvd_collectives_total`` of a snapshot: verb -> count, or with
    ``by_rank`` "<rank label or sum>.<verb>" -> count."""
    [fam] = [f for f in snap if f["name"] == "hvd_collectives_total"]
    out = {}
    for smp in fam["samples"]:
        lab = smp["labels"]
        key = lab["verb"] if not by_rank else \
            f"{lab.get('rank', 'sum')}.{lab['verb']}"
        out[key] = smp["value"]
    return out


BATTERIES = {"collectives": run_collectives, "engine": run_engine,
             "runtime": run_runtime, "optimizer": run_optimizer,
             "obs": run_obs, "plane": run_plane}


def main(mode: str, outdir: str) -> int:
    sys.path.insert(0, REPO)
    import horovod_tpu_torch as hvd
    hvd.init()
    me = hvd.rank()
    arrays: dict = {}
    info: dict = {"jax_loaded": any(
        m == "jax" or m.startswith(("jax.", "jaxlib"))
        or m.split(".")[0] == "horovod_tpu" for m in list(sys.modules))}
    fn = BATTERIES[mode]
    if mode in ("optimizer", "obs", "plane"):
        fn(hvd, me, arrays, info, outdir)
    else:
        fn(hvd, me, arrays, info)
    np.savez(os.path.join(outdir, f"{mode}.rank{me}.npz"), **arrays)
    with open(os.path.join(outdir, f"{mode}.rank{me}.json"), "w") as f:
        json.dump(info, f)
    hvd.shutdown()
    print(f"rank {me}: {mode} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))

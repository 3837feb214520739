"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu, for NVIDIA Hopper.

The port is built slice by slice beside the JAX package ``horovod_tpu``,
which stays as it is and is the reference.  It has Horovod's runtime and
serves and trains Llama-family models end to end on H100s:

- ``init()``, one process a rank on ``cuda:<local_rank>``, over
  ``torch.distributed`` (NCCL on the card, Gloo on the CPU when asked);
  the eager and async verbs below, through a negotiating, fusing engine
  (``ops/engine.py``); ``DistributedOptimizer`` (gradient hooks feed async
  allreduces, ``step()`` synchronizes) and ``SyncBatchNorm``;
- ``serving.serve()`` over a continuous-batching engine with a block-paged
  KV cache, decode attention in ``csrc/paged_decode.cu``;
- ``models.llama.make_train_step`` (Adam steps on full-width Llama-2-7B
  with per-layer recompute), attention forward and backward in
  ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` behind a
  ``torch.autograd.Function``.

Usage, one process a card::

    import horovod_tpu_torch as hvd
    hvd.init()
    hvd.broadcast_parameters(named_params, root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.Adam(params),
                                   named_parameters=named_params)

Every kernel is hand-written CUDA C++ for ``sm_90a``, built with ``nvcc``
at first use and bound with ctypes.

Ground rules:

- **Imports.** The port imports ``torch``, never ``jax``, and nothing of
  ``horovod_tpu`` — not even its JAX-free modules, since importing any
  ``horovod_tpu.*`` module runs ``horovod_tpu/__init__.py``, which imports
  jax.  What the port needs from those modules is copied into it
  (``config.py``, ``_native/``, ``utils/logging.py``, ``utils/timeline.py``,
  ``obs/``, ``chaos/``, the serving pager and scheduler).
- **Device.** Entry points run on ``cuda:<local_rank>`` unless the caller
  asks for the CPU (``device="cpu"``; ``HVDTPU_PLATFORM=cpu`` for the
  runtime), as the tests do.  Without a card they raise; they never carry
  on quietly on the CPU.
- **No fallback.** Every kernel has a plain PyTorch version beside it.  A
  wrapper runs the plain version only for tensors on the CPU; for a CUDA
  tensor it launches the kernel or raises.  A CUDA runtime without NCCL
  raises rather than use Gloo.
- **Layouts.** Public functions keep the JAX package's layouts (stacked
  layer weights ``[L, D, H, Dh]``, q ``[B, H, Dh]``, pools
  ``[L, NB, BS, KV, Dh]``), so parameters move across with
  :func:`~horovod_tpu_torch.models.llama.params_from_jax` and the tests
  compare the two packages on the same inputs.

The collective data plane: wire precision (``compression=`` or
``HVDTPU_WIRE_PRECISION``: cast and block-scaled int8/fp8 wires,
``ops/reduction.py``), the decomposed ``rs_ag:<k>`` schedule
(``HVDTPU_SCHED_MODE=decomposed``, ``ops/sched/``) and its compiled form,
one CUDA graph a schedule signature (``HVDTPU_SCHED_MODE=compiled``),
Adasum (``op=hvd.Adasum``) and ``ZeroDistributedOptimizer`` (ZeRO-1).

Elastic training: ``hvd.elastic`` (``run``, ``ObjectState``,
``FileBackedState``, ``TorchState``, ``ElasticSampler``), the launcher's
elastic driver (``--host-discovery-script``, ``runner/elastic.py``) and
autoscale (``--autoscale``, ``autoscale/``).

Not yet ported, and raising ``NotImplementedError`` where a caller could
reach them: sharded models (``mesh=``) for serving, training and
``generate``, MoE configs, the front door's router and transport, KV
migration, the hierarchical allreduce, and the knobs
:func:`.config.check_ported` lists.
"""

from __future__ import annotations

import itertools
import pickle
from typing import Any, Optional, Sequence

import torch

from . import config  # noqa: F401
from .config import Config  # noqa: F401
from .context import (  # noqa: F401
    HorovodInternalError,
    NotInitializedError,
    component_health,
    cross_rank,
    cross_size,
    device,
    global_state,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    set_component_health,
    shutdown,
    size,
)
from .ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
)
from . import obs
from .ops.compression import Compression, routes_engine_side
from .ops.engine import Handle, TensorTableEntry

__version__ = "0.1.0"

_name_counter = itertools.count()


def _auto_name(prefix: str, name: Optional[str]) -> str:
    # † the reference auto-names tensors per op when name is omitted; the
    # counter runs in call order, so every rank names alike.
    return name if name is not None else f"{prefix}.noname.{next(_name_counter)}"


def _engine():
    state = global_state()
    if not state.initialized or state.engine is None:
        raise NotInitializedError()
    return state.engine


def _entry(verb: str, tensor: torch.Tensor, *, name: str,
           in_place: bool = False, process_set=None,
           **kw) -> TensorTableEntry:
    """One engine entry for ``tensor``, this rank's contribution."""
    state = global_state()
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"{verb} takes a torch.Tensor, got "
                        f"{type(tensor).__name__}")
    if tensor.device != state.device:
        raise ValueError(
            f"{verb}: the tensor is on {tensor.device}, the runtime on "
            f"{state.device}; move it there first")
    if process_set is not None and process_set.group is None:
        raise ValueError(f"rank {state.rank} is not in {process_set}")
    payload = tensor.detach()
    return TensorTableEntry(
        name=name, verb=verb, payload=payload,
        output=payload if in_place else None, process_set=process_set,
        **kw)


def _enqueue(verb: str, tensor: torch.Tensor, *, name: Optional[str],
             **kw) -> Handle:
    eng = _engine()
    return eng.enqueue(_entry(verb, tensor, name=_auto_name(verb, name),
                              **kw))


def _wire(op: ReduceOp, dtype: torch.dtype, nbytes: int, compression,
          process_set) -> dict:
    """The wire mode and schedule of an allreduce entry, resolved at
    enqueue from what every rank agrees on (op, dtype, bytes a rank, the
    group's size, the config) († ``_resolve_entry_precision`` and
    ``_resolve_entry_schedule``)."""
    from .ops import reduction, sched
    _engine()                               # raises before init()
    cfg = global_state().config
    n = _group_size(process_set)
    mode = reduction.resolve_precision(
        reduction.as_wire_mode(compression), op, dtype, nbytes, cfg, n)
    return dict(precision=mode, schedule=sched.resolve_schedule(
        "", "allreduce", op, dtype, nbytes, cfg, n, mode))


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(process_set) -> int:
    return process_set.size() if process_set is not None else size()


def _check_root(root_rank: int, process_set) -> None:
    n = _group_size(process_set)
    if not 0 <= root_rank < n:
        raise ValueError(f"root_rank {root_rank} out of range [0,{n})")


# ---------------------------------------------------------------------------
# Async verbs († horovod/torch *_async / *_async_ + synchronize/poll).
# Every verb, synchronous or not, is an engine entry: the engine's thread
# issues all collectives, in the negotiated order.
# ---------------------------------------------------------------------------

def _allreduce_entry(tensor: torch.Tensor, op: ReduceOp, name: str,
                     prescale: float, postscale: float, compression,
                     process_set, *, in_place: bool = False,
                     nbytes: Optional[int] = None) -> TensorTableEntry:
    """An allreduce entry whose wire mode and schedule are resolved from
    ``nbytes`` (the tensor's own bytes by default)."""
    return _entry("allreduce", tensor, name=name, in_place=in_place, op=op,
                  prescale=prescale, postscale=postscale,
                  process_set=process_set,
                  **_wire(op, tensor.dtype, _tensor_bytes(tensor)
                          if nbytes is None else nbytes, compression,
                          process_set))


def allreduce_async(tensor: torch.Tensor, op: ReduceOp = Average, *,
                    name: Optional[str] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=None, process_set=None) -> Handle:
    """Enqueue an allreduce; returns a :class:`Handle` at once.  Entries
    enqueued within one engine cycle fuse into one collective, entries of
    one wire mode and schedule together.  ``compression`` is a wire mode
    (``"fp32"``, ``"bf16"``, ``"fp16"``, ``"int8"``, ``"fp8"``) or a
    ``Compression`` entry, applied inside the collective; None defers to
    ``HVDTPU_WIRE_PRECISION``."""
    return _engine().enqueue(_allreduce_entry(
        tensor, op, _auto_name("allreduce", name), prescale_factor,
        postscale_factor, compression, process_set))


def allreduce_async_(tensor: torch.Tensor, op: ReduceOp = Average, *,
                     name: Optional[str] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     compression=None, process_set=None) -> Handle:
    """In-place :func:`allreduce_async`: the result lands in ``tensor``."""
    return _engine().enqueue(_allreduce_entry(
        tensor, op, _auto_name("allreduce", name), prescale_factor,
        postscale_factor, compression, process_set, in_place=True))


def _grouped(tensors, op, name, prescale, postscale, compression,
             process_set, by_total: bool) -> list[Handle]:
    """One entry a tensor, enqueued together so that they meet one engine
    cycle and fuse (up to the threshold); each wire mode resolved by the
    tensor's own bytes, or by the group's (``by_total``)."""
    base = _auto_name("grouped", name)
    total = sum(_tensor_bytes(t) for t in tensors)
    return _engine().enqueue_many([
        _allreduce_entry(t, op, f"{base}.{i}", prescale, postscale,
                         compression, process_set,
                         nbytes=total if by_total else None)
        for i, t in enumerate(tensors)])


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            op: ReduceOp = Average, *,
                            name: Optional[str] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            compression=None,
                            process_set=None) -> list[Handle]:
    """Enqueue several allreduces at once († ``hvd.grouped_allreduce_async``);
    they meet one engine cycle together, so they fuse (up to the
    threshold); each entry's wire mode is resolved by its own bytes."""
    return _grouped(tensors, op, name, prescale_factor, postscale_factor,
                    compression, process_set, by_total=False)


def allgather_async(tensor: torch.Tensor, *, name: Optional[str] = None,
                    process_set=None) -> Handle:
    return _enqueue("allgather", tensor, name=name, process_set=process_set)


def broadcast_async(tensor: torch.Tensor, root_rank: int, *,
                    name: Optional[str] = None, process_set=None) -> Handle:
    _check_root(root_rank, process_set)
    return _enqueue("broadcast", tensor, name=name, root_rank=root_rank,
                    process_set=process_set)


def broadcast_async_(tensor: torch.Tensor, root_rank: int, *,
                     name: Optional[str] = None, process_set=None) -> Handle:
    """In-place :func:`broadcast_async`: ``tensor`` becomes the root's."""
    _check_root(root_rank, process_set)
    return _enqueue("broadcast", tensor, name=name, in_place=True,
                    root_rank=root_rank, process_set=process_set)


def alltoall_async(tensor: torch.Tensor,
                   splits: Optional[Sequence[int]] = None, *,
                   name: Optional[str] = None, process_set=None) -> Handle:
    return _enqueue("alltoall", tensor, name=name,
                    splits=None if splits is None else
                    [int(s) for s in splits], process_set=process_set)


def reducescatter_async(tensor: torch.Tensor, op: ReduceOp = Sum, *,
                        name: Optional[str] = None,
                        process_set=None) -> Handle:
    return _enqueue("reducescatter", tensor, name=name, op=op,
                    process_set=process_set)


def synchronize(handle: Handle) -> Any:
    """Wait for an async collective and return its output
    († ``hvd.synchronize``).  Nudges the engine for an immediate cycle; on
    the card the caller's stream waits on the collective, the host does
    not."""
    if not handle.poll():
        _engine().nudge()
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True once the async collective has completed († ``hvd.poll``)."""
    return handle.poll()


# ---------------------------------------------------------------------------
# Synchronous verbs († hvd.allreduce et al.)
# ---------------------------------------------------------------------------

def _sync(handle: Handle) -> Any:
    _engine().nudge()
    return handle.wait()


def allreduce(tensor: torch.Tensor, op: ReduceOp = Average, *,
              name: Optional[str] = None, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              compression=Compression.none,
              process_set=None) -> torch.Tensor:
    """Reduce this rank's tensor across ranks († ``hvd.allreduce``).
    ``compression``: a cast ``Compression`` entry casts the tensor for
    the collective and back after, as upstream's torch binding does; a
    quantized entry or a mode string selects the engine's wire mode
    (:func:`allreduce_async`)."""
    if routes_engine_side(compression) or isinstance(compression, str):
        return _sync(allreduce_async(
            tensor, op, name=name, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, compression=compression,
            process_set=process_set))
    wire, ctx = compression.compress(tensor)
    out = _sync(allreduce_async(
        wire, op, name=name, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set))
    return compression.decompress(out, ctx)


def allreduce_(tensor: torch.Tensor, op: ReduceOp = Average, *,
               name: Optional[str] = None, prescale_factor: float = 1.0,
               postscale_factor: float = 1.0, compression=None,
               process_set=None) -> torch.Tensor:
    """In-place :func:`allreduce` († ``hvd.allreduce_``)."""
    _sync(allreduce_async_(tensor, op, name=name,
                           prescale_factor=prescale_factor,
                           postscale_factor=postscale_factor,
                           compression=compression,
                           process_set=process_set))
    return tensor


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = Average, *, name: Optional[str] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      compression=None,
                      process_set=None) -> list[torch.Tensor]:
    """Fused allreduce of several tensors († ``hvd.grouped_allreduce``);
    the wire mode resolves against the group's total bytes, as the
    reference's one program over the group does."""
    handles = _grouped(tensors, op, name, prescale_factor,
                       postscale_factor, compression, process_set,
                       by_total=True)
    if handles:
        _engine().nudge()
    return [h.wait() for h in handles]


def grouped_allreduce_sync(tensors: Sequence[torch.Tensor],
                           op: ReduceOp = Average, **kw) -> list[torch.Tensor]:
    """† ``hvd.grouped_allreduce``: the fused sync variant, under the name
    the JAX package gives it; the same as :func:`grouped_allreduce`."""
    return grouped_allreduce(tensors, op, **kw)


def allgather(tensor: torch.Tensor, *, name: Optional[str] = None,
              process_set=None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0 († ``hvd.allgather``);
    the ranks' dim-0 lengths may differ († ``MPI_Allgatherv``)."""
    return _sync(allgather_async(tensor, name=name, process_set=process_set))


def broadcast(tensor: torch.Tensor, root_rank: int, *,
              name: Optional[str] = None, process_set=None) -> torch.Tensor:
    """Every rank receives the root's tensor († ``hvd.broadcast``);
    ``root_rank`` counts within ``process_set`` when one is given."""
    return _sync(broadcast_async(tensor, root_rank, name=name,
                                 process_set=process_set))


def broadcast_(tensor: torch.Tensor, root_rank: int, *,
               name: Optional[str] = None,
               process_set=None) -> torch.Tensor:
    """In-place :func:`broadcast` († ``hvd.broadcast_``)."""
    _sync(broadcast_async_(tensor, root_rank, name=name,
                           process_set=process_set))
    return tensor


def alltoall(tensor: torch.Tensor, splits: Optional[Sequence[int]] = None,
             *, name: Optional[str] = None,
             process_set=None) -> torch.Tensor:
    """Send dim-0 slices of this rank's tensor to every rank and return
    what every rank sent here († ``hvd.alltoall``).  ``splits[j]`` rows go
    to rank ``j``; without ``splits`` the rows divide evenly."""
    return _sync(alltoall_async(tensor, splits, name=name,
                                process_set=process_set))


def reducescatter(tensor: torch.Tensor, op: ReduceOp = Sum, *,
                  name: Optional[str] = None,
                  process_set=None) -> torch.Tensor:
    """Reduce across ranks, then rank *i* keeps the *i*-th dim-0 slice."""
    return _sync(reducescatter_async(tensor, op, name=name,
                                     process_set=process_set))


def barrier(process_set=None) -> None:
    """Block until every rank of the set arrives († ``hvd.barrier``): an
    allreduce of ones through the engine, checked on the host."""
    n = _group_size(process_set)
    ones = torch.ones((1,), dtype=torch.int32, device=global_state().device)
    total = int(allreduce(ones, Sum, name=_auto_name("barrier", None),
                          process_set=process_set).item())
    if total != n:
        raise RuntimeError(f"barrier allreduce returned {total} != {n}")


def join(timeout: Optional[float] = None) -> int:
    """Signal that this rank has no more input († ``hvd.join()``,
    ``RequestType::JOIN``); returns the last rank to join.  Until every
    rank has joined, this rank takes part in the others' allreduces with
    zeros (``Average`` still divides by the whole world).  One rank joins
    by a barrier and returns 0."""
    eng = _engine()
    if eng.distributed:
        return eng.join(timeout=timeout)
    barrier()
    return size() - 1


# ---------------------------------------------------------------------------
# Objects († broadcast_object / allgather_object)
# ---------------------------------------------------------------------------

def _to_bytes_tensor(obj: Any) -> torch.Tensor:
    raw = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    return raw.to(global_state().device)


def broadcast_object(obj: Any, root_rank: int = 0, *,
                     name: Optional[str] = None) -> Any:
    """The root's picklable object, on every rank
    († ``hvd.broadcast_object``): its length, then its pickle."""
    base = _auto_name("broadcast_object", name)
    payload = _to_bytes_tensor(obj if rank() == root_rank else None)
    length = torch.tensor([payload.numel()], dtype=torch.int64,
                          device=payload.device)
    length = int(broadcast(length, root_rank, name=f"{base}.len").item())
    buf = payload if rank() == root_rank else torch.zeros(
        length, dtype=torch.uint8, device=payload.device)
    buf = broadcast(buf, root_rank, name=f"{base}.data")
    return pickle.loads(buf.cpu().numpy().tobytes())


def allgather_object(obj: Any, *, name: Optional[str] = None) -> list:
    """Every rank's picklable object, in rank order
    († ``hvd.allgather_object``)."""
    base = _auto_name("allgather_object", name)
    payload = _to_bytes_tensor(obj)
    sizes = allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                   device=payload.device),
                      name=f"{base}.len").tolist()
    data = allgather(payload, name=f"{base}.data").cpu().numpy().tobytes()
    out, offset = [], 0
    for k in sizes:
        out.append(pickle.loads(data[offset:offset + k]))
        offset += k
    return out


# ---------------------------------------------------------------------------
# Process sets († hvd.add_process_set, v0.23): collective over the job —
# every rank adds every set, in the same order.
# ---------------------------------------------------------------------------

def add_process_set(ranks: Sequence[int]):
    state = global_state()
    if not state.initialized:
        raise NotInitializedError()
    return state.process_set_table.add(ranks)


def remove_process_set(ps) -> None:
    state = global_state()
    if not state.initialized:
        raise NotInitializedError()
    state.process_set_table.remove(ps)


def global_process_set():
    state = global_state()
    if not state.initialized:
        raise NotInitializedError()
    return state.process_set_table.global_set


# ---------------------------------------------------------------------------
# Telemetry (horovod_tpu_torch.obs; beyond the reference, whose surface
# stops at the timeline)
# ---------------------------------------------------------------------------

def metrics(fmt: str = "dict"):
    """Snapshot of the process-wide metrics registry, every layer's
    counters, gauges and histograms: ``fmt="dict"`` the plain data,
    ``"json"`` the ``/metrics.json`` body, ``"prometheus"`` the text
    exposition, byte-identical to ``GET :$HVDTPU_METRICS_PORT/metrics``.
    Works before and without ``init()``."""
    return _format_snapshot(obs.REGISTRY.snapshot(), fmt)


def cluster_metrics(fmt: str = "dict"):
    """The job's merged view of every rank's registry, formatted as
    :func:`metrics`: each rank publishes its snapshot into the job's KV
    store (armed by ``init()`` under the launcher), and this merges them —
    counters per rank (a ``rank`` label) plus their sum, gauges per rank,
    histogram buckets merged where the edges agree.  Served as
    ``/cluster`` and ``/cluster.json`` too.  A process started without a
    launcher is the world-size-1 cluster, labeled ``rank="0"``."""
    return _format_snapshot(obs.aggregate.cluster_snapshot(), fmt)


def flight_record(path: Optional[str] = None) -> Optional[str]:
    """Write a flight-recorder bundle now and return its path
    (:mod:`.obs.flightrec`): the recent event ring, a registry snapshot,
    the process identity and, across processes, the controller's last
    straggler attribution.  ``path=None`` names a file under the armed
    directory (or the working directory).  None only when the dump itself
    failed (logged, never raised).  Works before and without ``init()``."""
    state = global_state()
    stall = None
    if state.engine is not None:
        stall = getattr(state.engine._negotiator, "last_stall_info", None)
    return obs.flightrec.RECORDER.dump(path, reason="manual", stall=stall)


def _format_snapshot(snap, fmt: str):
    if fmt == "dict":
        return snap
    if fmt == "json":
        return obs.export.to_json(snap)
    if fmt == "prometheus":
        return obs.export.to_prometheus(snap)
    raise ValueError(
        f"fmt must be 'dict', 'json' or 'prometheus', got {fmt!r}")


# ---------------------------------------------------------------------------
# Runtime timeline control († hvd.start_timeline / stop_timeline, v0.21)
# ---------------------------------------------------------------------------

def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Begin writing the Chrome-trace timeline; replaces any active one."""
    from .utils.timeline import Timeline
    state = global_state()
    if not state.initialized:
        raise NotInitializedError()
    old = state.timeline
    state.timeline = Timeline(file_path, mark_cycles=mark_cycles,
                              rank=state.rank)
    if old is not None:
        old.close()


def stop_timeline() -> None:
    """Stop and flush the active timeline."""
    state = global_state()
    if not state.initialized:
        raise NotInitializedError()
    old, state.timeline = state.timeline, None
    if old is not None:
        old.close()


# ---------------------------------------------------------------------------
# Capability queries († basics.py mpi_built/nccl_built/gloo_built/...),
# answered for this torch.
# ---------------------------------------------------------------------------

def nccl_built() -> int:
    """The NCCL version torch was built with, as upstream encodes it
    (major * 10000 + minor * 100 + patch), or 0 without NCCL."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_nccl_available()):
        return 0
    major, minor, patch = torch.cuda.nccl.version()[:3]
    return major * 10000 + minor * 100 + patch


def cuda_built() -> bool:
    return torch.version.cuda is not None


def gloo_built() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_gloo_available()


def gloo_enabled() -> bool:
    """Gloo carries the collectives only on the CPU."""
    state = global_state()
    return state.initialized and state.backend == "gloo"


def native_built() -> bool:
    """True when the C++ control plane (KV store, controller) loads."""
    try:
        from . import _native
        _native.load()
        return True
    except OSError:
        return False


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def xla_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def rocm_built() -> bool:
    return False


def mpi_threads_supported() -> bool:
    """Collective submission is thread-safe; the engine's one thread
    issues every collective."""
    return True


def is_homogeneous() -> bool:
    """Every host runs as many ranks as this one († upstream: equal local
    sizes on all hosts)."""
    return size() == local_size() * cross_size()


from .optim.distributed import (  # noqa: E402,F401
    DistributedOptimizer,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .optim.zero import ZeroDistributedOptimizer  # noqa: E402,F401
from .ops.sched.buckets import (  # noqa: E402,F401
    bucketed_distributed_gradients,
)
from .sync_batch_norm import SyncBatchNorm  # noqa: E402,F401


def __getattr__(name: str):
    if name == "elastic":
        # † ``import horovod.torch as hvd; hvd.elastic.run`` — lazy so the
        # elastic machinery is not paid for by collective-only users.
        import importlib
        return importlib.import_module("horovod_tpu_torch.elastic")
    raise AttributeError(
        f"module 'horovod_tpu_torch' has no attribute {name!r}")

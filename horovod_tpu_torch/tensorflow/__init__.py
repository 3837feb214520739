"""TensorFlow binding: Horovod's TF API surface on the port's runtime.

The port of ``horovod_tpu/tensorflow/__init__.py``
(† ``horovod/tensorflow/__init__.py`` + ``mpi_ops.py``):
``allreduce/allgather/broadcast/alltoall/reducescatter`` on
``tf.Tensor``, ``allreduce_async``/``synchronize``/``poll``,
``DistributedGradientTape`` (TF2 eager gradient averaging, ``IndexedSlices``
densified), ``DistributedOptimizer`` (a Keras optimizer of the same class
whose ``apply_gradients`` averages first; ``backward_passes_per_step``
aggregates locally, † ``gradient_aggregation_eager.py``),
``broadcast_variables`` (the step-0 sync) and the lazy ``elastic``.

The bridge: a TF tensor goes to numpy, then to a torch tensor on the
runtime's device (``cuda:<local_rank>`` under NCCL, the CPU under Gloo),
through the port's verb, and back through numpy to TF.  Inside
``tf.function`` graphs the bridge rides ``tf.py_function`` (an eager
host call, as the reference's async kernel hands off to its background
thread); ``jit_compile=True`` graphs cannot host-call.  A process is one
rank, so nothing is tiled over local devices (the JAX package's
``replicate_local``).  A gradient list is one async allreduce a gradient,
synchronized together, so the engine fuses them.

TensorFlow is imported here and only here (and in ``keras/``): the rest of
the port runs without it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

try:
    import tensorflow as tf
except ImportError as e:            # the card's machine has no TensorFlow
    raise ImportError(
        "horovod_tpu_torch.tensorflow needs TensorFlow, which is not "
        f"installed ({e}); the rest of horovod_tpu_torch runs without "
        "it") from e

import horovod_tpu_torch as _hvd
from horovod_tpu_torch import (  # noqa: F401  (re-exported basics †basics.py)
    Adasum,
    Average,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
    broadcast_object,
    cross_rank,
    cross_size,
    init,
    is_initialized,
    join,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.ops.compression import (  # noqa: F401
    Compression,
    routes_engine_side,
)


def _to_torch(arr) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a torch tensor
    on the runtime's device."""
    state = _hvd.global_state()
    if not state.initialized:
        raise _hvd.NotInitializedError()
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(
        state.device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Eager verbs
# ---------------------------------------------------------------------------

def allreduce(tensor: tf.Tensor, op: ReduceOp = Average,
              name: Optional[str] = None) -> tf.Tensor:
    """† ``hvd.allreduce`` on a TF tensor (eager, or inside
    ``tf.function`` through a host call)."""
    if tf.executing_eagerly() and not isinstance(tensor, tf.Variable) \
            and not hasattr(tensor, "graph"):
        out = _np(_hvd.allreduce(_to_torch(tensor), op, name=name))
        return tf.constant(out, dtype=tensor.dtype)
    dtype = tensor.dtype

    def _host(t):
        out = _np(_hvd.allreduce(_to_torch(t.numpy()), op, name=name))
        return tf.constant(out.astype(dtype.as_numpy_dtype))

    result = tf.py_function(_host, inp=[tensor], Tout=dtype)
    result.set_shape(tensor.shape)
    return result


def allgather(tensor: tf.Tensor, name: Optional[str] = None) -> tf.Tensor:
    out = _np(_hvd.allgather(_to_torch(tensor), name=name))
    return tf.constant(out, dtype=tensor.dtype)


def broadcast(tensor: tf.Tensor, root_rank: int,
              name: Optional[str] = None) -> tf.Tensor:
    out = _np(_hvd.broadcast(_to_torch(tensor), root_rank, name=name))
    return tf.constant(out, dtype=tensor.dtype)


def alltoall(tensor: tf.Tensor, splits: Optional[Sequence[int]] = None,
             name: Optional[str] = None) -> tf.Tensor:
    out = _np(_hvd.alltoall(_to_torch(tensor), splits, name=name))
    return tf.constant(out, dtype=tensor.dtype)


def reducescatter(tensor: tf.Tensor, op: ReduceOp = Sum,
                  name: Optional[str] = None) -> tf.Tensor:
    out = _np(_hvd.reducescatter(_to_torch(tensor), op, name=name))
    return tf.constant(out, dtype=tensor.dtype)


# ---------------------------------------------------------------------------
# Async verbs
# ---------------------------------------------------------------------------

def allreduce_async(tensor: tf.Tensor, op: ReduceOp = Average,
                    name: Optional[str] = None):
    return _hvd.allreduce_async(_to_torch(tensor), op, name=name)


def synchronize(handle) -> tf.Tensor:
    return tf.constant(_np(_hvd.synchronize(handle)))


def poll(handle) -> bool:
    return _hvd.poll(handle)


# ---------------------------------------------------------------------------
# Variable sync († broadcast_variables / BroadcastGlobalVariablesCallback)
# ---------------------------------------------------------------------------

def _broadcast_arrays(arrays: list, root_rank: int) -> list:
    """Every array from ``root_rank``, as one batch of in-place broadcasts
    (one collective each would cost a round trip each at startup)."""
    tensors = {f"{i:06d}": _to_torch(a) for i, a in enumerate(arrays)}
    _hvd.broadcast_parameters(tensors, root_rank=root_rank)
    return [_np(tensors[f"{i:06d}"]) for i in range(len(arrays))]


def broadcast_variables(variables: Sequence[tf.Variable],
                        root_rank: int = 0) -> None:
    """In-place broadcast of TF variables from ``root_rank``
    († ``hvd.broadcast_variables``, the step-0 weight sync)."""
    variables = list(variables)
    if not variables:
        return
    if tf.executing_eagerly():
        synced = _broadcast_arrays([np.asarray(v) for v in variables],
                                   root_rank)
        for v, value in zip(variables, synced):
            v.assign(tf.constant(value, dtype=v.dtype, shape=v.shape))
        return
    # Inside tf.function: read the values as graph tensors, broadcast them
    # in one host call, assign back (the reference's documented pattern of
    # a first-batch sync inside @tf.function).
    values = [tf.convert_to_tensor(v) for v in variables]

    def _host(*vals):
        synced = _broadcast_arrays([val.numpy() for val in vals], root_rank)
        return [tf.constant(s) for s in synced]

    out = tf.py_function(_host, inp=values, Tout=[v.dtype for v in values])
    if not isinstance(out, (list, tuple)):
        out = [out]
    for v, r in zip(variables, out):
        r.set_shape(v.shape)
        v.assign(r)


# ---------------------------------------------------------------------------
# DistributedGradientTape († _DistributedGradientTape)
# ---------------------------------------------------------------------------

class _DistributedGradientTape:
    """Wraps ``tf.GradientTape``; ``gradient()`` returns the gradients
    averaged (``op``) across ranks, all in one engine cycle."""

    def __init__(self, tape: tf.GradientTape, op: ReduceOp = Average,
                 compression=Compression.none) -> None:
        self._tape = tape
        self._op = op
        self._compression = compression

    def __getattr__(self, name):
        return getattr(self._tape, name)

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources,
                                    output_gradients=output_gradients)
        flat = tf.nest.flatten(grads)
        reduced = _grouped_allreduce_grads(flat, self._op, self._compression)
        return tf.nest.pack_sequence_as(grads, reduced)


def DistributedGradientTape(tape: tf.GradientTape, op: ReduceOp = Average,
                            compression=Compression.none
                            ) -> _DistributedGradientTape:
    """† ``hvd.DistributedGradientTape``."""
    return _DistributedGradientTape(tape, op=op, compression=compression)


def _grouped_allreduce_grads(flat_grads, op: ReduceOp, compression):
    """Allreduce a flat gradient list in one fused cycle; None passes
    through (untrained variables have None gradients, † _allreduce_grads).
    Inside ``tf.function`` the whole list rides one host call."""
    if tf.executing_eagerly():
        return _grouped_allreduce_grads_eager(flat_grads, op, compression)
    live = [tf.convert_to_tensor(g) for g in flat_grads if g is not None]
    if not live:
        return list(flat_grads)

    def _host(*gs):
        outs = _grouped_allreduce_grads_eager(list(gs), op, compression)
        return [tf.constant(np.asarray(o)) for o in outs]

    reduced_live = tf.py_function(_host, inp=live,
                                  Tout=[g.dtype for g in live])
    if not isinstance(reduced_live, (list, tuple)):
        reduced_live = [reduced_live]
    it = iter(reduced_live)
    out = []
    for g in flat_grads:
        if g is None:
            out.append(None)
            continue
        r = next(it)
        if isinstance(g, tf.Tensor):
            r.set_shape(g.shape)
        out.append(r)
    return out


def _dense(g) -> np.ndarray:
    """A gradient as a dense array († ``sparse_as_dense``: indexed slices
    are summed into their dense shape before the collective)."""
    if not isinstance(g, tf.IndexedSlices):
        return np.asarray(g)
    values = np.asarray(g.values)
    dense = np.zeros(g.dense_shape.numpy(), values.dtype)
    np.add.at(dense, g.indices.numpy(), values)
    return dense


def _grouped_allreduce_grads_eager(flat_grads, op: ReduceOp, compression):
    # Quantized compressors are the engine's wire modes; cast compressors
    # keep their cast around the collective (ops/compression.py).
    kw = ({"compression": compression} if routes_engine_side(compression)
          else {})
    pending = []
    for i, g in enumerate(flat_grads):
        if g is None:
            continue
        t = _to_torch(_dense(g))
        wire, ctx = (t, None) if kw else compression.compress(t)
        pending.append((i, ctx, _hvd.allreduce_async(
            wire, op, name=f"tf.grad.{i}", **kw)))
    out = list(flat_grads)
    for i, ctx, handle in pending:
        reduced = compression.decompress(_hvd.synchronize(handle), ctx)
        out[i] = tf.constant(_np(reduced), dtype=flat_grads[i].dtype)
    return out


# ---------------------------------------------------------------------------
# DistributedOptimizer († Keras optimizer wrap + gradient aggregation)
# ---------------------------------------------------------------------------

def DistributedOptimizer(optimizer, op: ReduceOp = Average,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         name: Optional[str] = None):
    """† ``hvd.DistributedOptimizer``: an optimizer of the same class
    whose ``apply_gradients`` first averages the gradients across ranks.

    Works in eager custom loops and in ``model.fit`` graphs (host call);
    ``backward_passes_per_step > 1`` accumulates locally and applies the
    averaged update every Nth call († ``LocalGradientAggregationHelper``).
    """
    del name
    cls = optimizer.__class__
    dist_cls = type("Distributed" + cls.__name__, (cls,), {
        "_hvd_op": op,
        "_hvd_compression": compression,
        "_hvd_bpps": backward_passes_per_step,
        "apply_gradients": _dist_apply_gradients,
    })
    new = dist_cls.from_config(optimizer.get_config())
    new._hvd_agg_buf = None
    new._hvd_agg_count = 0
    return new


def _dist_apply_gradients(self, grads_and_vars, *args, **kwargs):
    grads_and_vars = list(grads_and_vars)
    grads = [g for g, _ in grads_and_vars]
    tvars = [v for _, v in grads_and_vars]
    eager = tf.executing_eagerly() and all(
        not hasattr(g, "graph") for g in grads if g is not None)
    if self._hvd_bpps > 1:
        if not eager:
            raise RuntimeError(
                "backward_passes_per_step > 1 requires eager execution "
                "(run_eagerly=True) in this binding")
        if self._hvd_agg_buf is None:
            self._hvd_agg_buf = [
                None if g is None else np.asarray(g) for g in grads]
        else:
            for i, g in enumerate(grads):
                if g is not None:
                    self._hvd_agg_buf[i] = self._hvd_agg_buf[i] + np.asarray(g)
        self._hvd_agg_count += 1
        if self._hvd_agg_count < self._hvd_bpps:
            return None  # † aggregation step: no variable update yet
        grads = [None if b is None else tf.constant(b / self._hvd_bpps)
                 for b in self._hvd_agg_buf]
        self._hvd_agg_buf = None
        self._hvd_agg_count = 0

    reduced = _grouped_allreduce_grads(grads, self._hvd_op,
                                       self._hvd_compression)
    return super(type(self), self).apply_gradients(
        zip(reduced, tvars), *args, **kwargs)


def __getattr__(name: str):
    if name == "elastic":
        # † ``import horovod.tensorflow as hvd; hvd.elastic.TensorFlowKerasState``
        import importlib
        return importlib.import_module("horovod_tpu_torch.tensorflow.elastic")
    raise AttributeError(
        f"module 'horovod_tpu_torch.tensorflow' has no attribute {name!r}")

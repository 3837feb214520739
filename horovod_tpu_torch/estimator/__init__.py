"""Estimator API: train from data frames without writing a train loop.

The port of ``horovod_tpu/estimator/__init__.py`` († ``horovod/spark/
torch/TorchEstimator`` / ``horovod/spark/keras/KerasEstimator``): hand it
a model and data, it shards rows across the ranks, wires the distributed
optimizer, checkpoints on rank 0, and returns a Transformer that predicts
locally.  Spark is a cluster launcher and data conduit upstream; here the
launcher is ``hvdrun`` (or :mod:`horovod_tpu_torch.spark` and
:mod:`horovod_tpu_torch.ray`) and the data plane is host numpy copied to
the rank's device a batch at a time:

- :class:`TorchEstimator` — an initialized ``nn.Module`` and a
  ``torch.optim`` optimizer (the JAX package's ``JaxEstimator`` takes a
  flax module and an optax transform); each global batch split into
  contiguous shares over the data ranks, gradients averaged by the
  port's ``DistributedOptimizer``, per-epoch checkpoints through
  :mod:`horovod_tpu_torch.utils.checkpoint` into a :class:`Store`.
- :class:`KerasEstimator` — a Keras 3 model trained through
  ``model.fit`` with the port's Keras callbacks (broadcast, metric
  averaging) attached, rows sharded by rank the way the reference shards
  partitions.

Both return fitted models exposing ``predict(data)`` and Spark-style
``transform(df)`` (appends a prediction column).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .store import (FilesystemStore, InMemoryObjectStore, LocalStore,
                    ParquetBatches, RemoteStore, Store, _is_spark_dataframe,
                    to_columns, train_val_split)

__all__ = [
    "TorchEstimator", "TorchModel", "KerasEstimator", "KerasModel",
    "Store", "FilesystemStore", "LocalStore", "RemoteStore",
    "InMemoryObjectStore", "ParquetBatches", "to_columns",
]


def _default_loss(kind: str) -> Callable:
    import torch.nn.functional as F

    if kind == "mse":
        return lambda preds, labels: torch.mean(
            (preds - labels.to(preds.dtype)) ** 2)
    if kind in ("sparse_categorical_crossentropy", "xent"):
        return lambda preds, labels: F.cross_entropy(preds, labels.long())
    raise ValueError(f"unknown loss {kind!r}; pass a callable")


def _module_device(module: torch.nn.Module) -> torch.device:
    for t in module.parameters():
        return t.device
    return torch.device("cpu")


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@dataclasses.dataclass
class TorchModel:
    """Fitted model († the Transformer returned by ``estimator.fit``):
    ``module`` stays on the device it was fitted on."""

    module: torch.nn.Module
    feature_cols: Sequence[str]
    label_cols: Sequence[str]
    output_col: str = "prediction"
    history: list = dataclasses.field(default_factory=list)

    def predict(self, data: Any, batch_size: int = 1024) -> np.ndarray:
        """The module's outputs for ``data``'s feature columns, in
        batches of ``batch_size`` rows, in eval mode, with no autograd."""
        cols = to_columns(data, columns=list(self.feature_cols))
        feats = _features_matrix(cols, self.feature_cols)
        dev = _module_device(self.module)
        was_training = self.module.training
        self.module.eval()
        outs = []
        try:
            with torch.no_grad():
                for i in range(0, len(feats), batch_size):
                    x = torch.from_numpy(feats[i:i + batch_size]).to(dev)
                    outs.append(_numpy(self.module(x)))
        finally:
            self.module.train(was_training)
        return np.concatenate(outs) if outs else np.empty((0,))

    def transform(self, df):
        """Append ``output_col`` to a pandas DataFrame († Transformer
        .transform on a Spark DataFrame)."""
        return _transform_frame(df, self.predict, self.output_col)


def _features_matrix(cols: dict, feature_cols: Sequence[str]) -> np.ndarray:
    parts = []
    for c in feature_cols:
        v = np.asarray(cols[c])
        parts.append(v[:, None] if v.ndim == 1 else v.reshape(len(v), -1))
    return np.concatenate(parts, axis=1).astype(np.float32) \
        if len(parts) > 1 else parts[0].astype(np.float32)


def _labels_array(cols: dict, label_cols: Sequence[str]) -> np.ndarray:
    if len(label_cols) == 1:
        return np.asarray(cols[label_cols[0]])
    return _features_matrix(cols, label_cols)


def _transform_frame(df, predict: Callable, output_col: str):
    """Spark-style Transformer.transform: append the prediction column.

    A Spark DataFrame input is collected to pandas first (same collect
    semantics as ``fit``); the returned frame is pandas either way.
    """
    if _is_spark_dataframe(df):
        df = df.toPandas()
    preds = predict(df)
    out = df.copy()
    out[output_col] = list(np.asarray(preds))
    return out


def _data_layout(mesh) -> tuple[int, int]:
    """(data ranks, this rank's index among them): the ``dp`` x ``fsdp``
    axes of ``mesh`` (``dp`` major, as ``NamedSharding(P(("dp",
    "fsdp")))`` splits a batch), else every rank of the runtime, else one
    process."""
    from .. import context
    if mesh is not None:
        from ..parallel.sharding import axis_sizes
        sizes = axis_sizes(mesh)
        n, r = 1, 0
        for a in ("dp", "fsdp"):
            k = sizes.get(a, 1)
            r = r * k + (mesh.get_local_rank(a) if k > 1 else 0)
            n *= k
        return n, r
    if context.is_initialized():
        return context.size(), context.rank()
    return 1, 0


def _rank0() -> bool:
    from .. import context
    return not context.is_initialized() or context.rank() == 0


class TorchEstimator:
    """Fit an initialized ``nn.Module`` from column data, each global
    batch split over the data ranks.

    Parameters mirror † ``TorchEstimator``'s surface:
    ``feature_cols``/``label_cols``/``batch_size``/``epochs``/
    ``validation``/``store``/``run_id``.  ``optimizer`` is a
    ``torch.optim`` optimizer over the model's parameters (default Adam
    at 1e-3); under the runtime it is wrapped in the port's
    ``DistributedOptimizer`` and the parameters are broadcast from rank 0
    first.  ``loss`` is ``"mse"``, ``"xent"`` or ``loss(preds, labels)``.
    ``batch_size`` is the GLOBAL batch, rounded down to a multiple of the
    data ranks (``mesh``'s ``dp`` x ``fsdp``, else the runtime's ranks).
    ``device`` is where parameters and batches live
    (:func:`horovod_tpu_torch.context.device`: the runtime's card, else
    ``cuda:<local_rank>``; the CPU only when asked for).
    """

    def __init__(self, *, model: torch.nn.Module,
                 feature_cols: Sequence[str],
                 label_cols: Sequence[str],
                 loss: Any = "mse",
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 batch_size: int = 32,
                 epochs: int = 1,
                 validation: Optional[float] = None,
                 store: Optional[Store] = None,
                 run_id: str = "torch-estimator",
                 mesh: Any = None,
                 shuffle: bool = True,
                 seed: int = 0,
                 verbose: int = 0,
                 device: Any = None) -> None:
        self.model = model
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.loss = loss if callable(loss) else _default_loss(loss)
        self.optimizer = optimizer
        self.batch_size = batch_size
        self.epochs = epochs
        self.validation = validation
        self.store = store
        self.run_id = run_id
        self.mesh = mesh
        self.shuffle = shuffle
        self.seed = seed
        self.verbose = verbose
        self.device = device
        self._opt: Optional[torch.optim.Optimizer] = None

    # -- API ----------------------------------------------------------------

    def fit(self, data: Any) -> TorchModel:
        if isinstance(data, ParquetBatches):
            return self._fit_streaming(data)
        cols = to_columns(data,
                          columns=self.feature_cols + self.label_cols)
        val_cols = None
        if self.validation:
            cols, val_cols = train_val_split(cols, self.validation,
                                             self.seed)

        feats = _features_matrix(cols, self.feature_cols)
        labels = _labels_array(cols, self.label_cols)
        n = len(feats)

        ts = self._train_setup(n)
        step, batch, lo, hi = ts["step"], ts["batch"], ts["lo"], ts["hi"]
        dev = ts["device"]

        history = []
        shuffle_rng = np.random.RandomState(self.seed)
        steps = n // batch
        for epoch in range(self.epochs):
            order = shuffle_rng.permutation(n) if self.shuffle \
                else np.arange(n)
            total = torch.zeros((), dtype=torch.float64, device=dev)
            self.model.train()
            for i in range(steps):
                # this rank's contiguous share of the global batch
                idx = order[i * batch:(i + 1) * batch][lo:hi]
                total += step(torch.from_numpy(feats[idx]).to(dev),
                              torch.from_numpy(labels[idx]).to(dev))
            entry = {"epoch": epoch,
                     "loss": self._mean_over_ranks(total, epoch)
                     / max(steps, 1)}
            if val_cols is not None and len(next(iter(val_cols.values()))):
                entry["val_loss"] = self._eval_loss(
                    _features_matrix(val_cols, self.feature_cols),
                    _labels_array(val_cols, self.label_cols), dev)
            history.append(entry)
            self._epoch_end(entry, epoch)

        return TorchModel(module=self.model,
                          feature_cols=self.feature_cols,
                          label_cols=self.label_cols, history=history)

    # -- internals ----------------------------------------------------------

    def _train_setup(self, n_rows: int) -> dict:
        """Shared device/batch/optimizer/step setup for both fit paths
        (one source of truth: the streaming path must never drift from
        the in-memory path on batch rounding, sharding or step math)."""
        from .. import context

        n_data, r = _data_layout(self.mesh)
        batch = max(self.batch_size // n_data, 1) * n_data
        if n_rows < batch:
            raise ValueError(
                f"{n_rows} rows < one global batch ({batch}); "
                "lower batch_size")
        dev = context.device(self.device)
        model = self.model.to(dev)
        if self._opt is None:
            opt = self.optimizer or torch.optim.Adam(model.parameters(),
                                                     lr=1e-3)
            if context.is_initialized():
                import horovod_tpu_torch as hvd
                from ..optim.distributed import _DistributedOptimizer
                if not isinstance(opt, _DistributedOptimizer):
                    opt = hvd.DistributedOptimizer(
                        opt, named_parameters=list(model.named_parameters()))
            self._opt = opt
        opt = self._opt
        if context.is_initialized():
            import horovod_tpu_torch as hvd
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)

        def step(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
            opt.zero_grad()
            lval = self.loss(model(f), y)
            lval.backward()
            opt.step()
            return lval.detach()

        share = batch // n_data
        return {"batch": batch, "lo": r * share, "hi": (r + 1) * share,
                "device": dev, "step": step}

    def _mean_over_ranks(self, total: torch.Tensor, epoch: int) -> float:
        """This rank's summed step losses, averaged over the ranks (each
        rank's loss is its share's mean, so this is the global batch's)."""
        from .. import context
        if context.is_initialized() and context.size() > 1:
            import horovod_tpu_torch as hvd
            total = hvd.allreduce(total, hvd.Average,
                                  name=f"estimator.{self.run_id}.loss."
                                       f"{epoch}")
        return float(total.item())

    def _eval_loss(self, feats: np.ndarray, labels: np.ndarray,
                   dev: torch.device) -> float:
        self.model.eval()
        with torch.no_grad():
            return float(self.loss(self.model(torch.from_numpy(feats)
                                              .to(dev)),
                                   torch.from_numpy(labels).to(dev)))

    def _epoch_end(self, entry: dict, epoch: int) -> None:
        if self.verbose:
            print(f"[TorchEstimator] {entry}")
        # rank 0 only: concurrent writers on a shared store corrupt the
        # checkpoint († checkpoint on rank 0).
        if self.store is not None and _rank0():
            from ..utils.checkpoint import Checkpointer
            Checkpointer(self.store.checkpoint_path(self.run_id),
                         single_process=True) \
                .save(epoch, {"params": self.model.state_dict()})
            # Remote stores stage on local disk; publish each epoch's
            # checkpoint so a crash never strands artifacts un-uploaded.
            self.store.sync(self.run_id)

    def _fit_streaming(self, batches: ParquetBatches) -> TorchModel:
        """Fit from a :class:`~.store.ParquetBatches` source: row-group
        chunks stream through host RAM one at a time (peak memory = one
        chunk + one global batch), so the dataset can be arbitrarily
        larger than memory — the Petastorm role († ``horovod.spark``
        estimators train from materialized parquet, never a driver
        collect).  Shuffling is within-chunk (plus the chunk remainder
        carried forward); validation needs a separate materialized
        split."""
        if self.validation:
            raise ValueError(
                "streaming fit has no row-level validation split — "
                "materialize a validation parquet and evaluate it with "
                "model.predict")
        ts = self._train_setup(len(batches))
        step, batch, lo, hi = ts["step"], ts["batch"], ts["lo"], ts["hi"]
        dev = ts["device"]

        history = []
        shuffle_rng = np.random.RandomState(self.seed)
        for epoch in range(self.epochs):
            total = torch.zeros((), dtype=torch.float64, device=dev)
            steps = 0
            rem_f = rem_y = None
            self.model.train()
            for chunk in batches:
                f = _features_matrix(chunk, self.feature_cols)
                y = _labels_array(chunk, self.label_cols)
                if self.shuffle:
                    order = shuffle_rng.permutation(len(f))
                    f, y = f[order], y[order]
                if rem_f is not None and len(rem_f):
                    f = np.concatenate([rem_f, f])
                    y = np.concatenate([rem_y, y])
                n_full = (len(f) // batch) * batch
                for i in range(0, n_full, batch):
                    total += step(
                        torch.from_numpy(f[i + lo:i + hi]).to(dev),
                        torch.from_numpy(y[i + lo:i + hi]).to(dev))
                    steps += 1
                rem_f, rem_y = f[n_full:], y[n_full:]
            # The final sub-batch remainder is dropped (drop_last
            # semantics, as the reference's static shapes need).
            entry = {"epoch": epoch,
                     "loss": self._mean_over_ranks(total, epoch)
                     / max(steps, 1),
                     "steps": steps}
            history.append(entry)
            self._epoch_end(entry, epoch)

        return TorchModel(module=self.model,
                          feature_cols=self.feature_cols,
                          label_cols=self.label_cols, history=history)


@dataclasses.dataclass
class KerasModel:
    model: Any
    feature_cols: Sequence[str]
    label_cols: Sequence[str]
    output_col: str = "prediction"
    history: Any = None

    def predict(self, data: Any, batch_size: int = 1024) -> np.ndarray:
        cols = to_columns(data, columns=list(self.feature_cols))
        feats = _features_matrix(cols, self.feature_cols)
        return np.asarray(self.model.predict(feats, batch_size=batch_size,
                                             verbose=0))

    def transform(self, df):
        return _transform_frame(df, self.predict, self.output_col)


class KerasEstimator:
    """† ``horovod.spark.keras.KerasEstimator``: fit a compiled Keras 3
    model from column data.  Rows are sharded by rank (the reference
    shards partitions per worker); the port's Keras callbacks provide the
    step-0 broadcast and cross-rank metric averaging, and its
    ``keras.DistributedOptimizer`` the gradient averaging, when running
    under a multi-process job.
    """

    def __init__(self, *, model: Any, feature_cols: Sequence[str],
                 label_cols: Sequence[str],
                 batch_size: int = 32,
                 epochs: int = 1,
                 validation: Optional[float] = None,
                 store: Optional[Store] = None,
                 run_id: str = "keras-estimator",
                 shuffle: bool = True,
                 seed: int = 0,
                 callbacks: Optional[list] = None,
                 verbose: int = 0) -> None:
        self.model = model
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.batch_size = batch_size
        self.epochs = epochs
        self.validation = validation
        self.store = store
        self.run_id = run_id
        self.shuffle = shuffle
        self.seed = seed
        self.callbacks = callbacks or []
        self.verbose = verbose

    def fit(self, data: Any) -> KerasModel:
        import horovod_tpu_torch as hvd

        cols = to_columns(data,
                          columns=self.feature_cols + self.label_cols)
        val_data = None
        if self.validation:
            cols, val_cols = train_val_split(cols, self.validation,
                                             self.seed)
            if len(next(iter(val_cols.values()))):
                val_data = (_features_matrix(val_cols, self.feature_cols),
                            _labels_array(val_cols, self.label_cols))

        feats = _features_matrix(cols, self.feature_cols)
        labels = _labels_array(cols, self.label_cols)

        callbacks = list(self.callbacks)
        rank0 = True
        if hvd.is_initialized() and hvd.size() > 1:
            from .. import keras as hvd_keras
            # Shard rows by rank († per-worker partitions), equalized so
            # every rank runs the SAME number of batches — unequal counts
            # deadlock any per-batch collective on the surplus batch
            # († steps_per_epoch equalization in the reference estimator).
            # One process is one rank here, so the rank is the shard.
            r, s = hvd.rank(), hvd.size()
            rank0 = r == 0
            per_rank = len(feats) // s
            if per_rank == 0:
                raise ValueError(
                    f"{len(feats)} rows cannot shard over {s} ranks")
            feats, labels = feats[r::s][:per_rank], labels[r::s][:per_rank]
            callbacks = [hvd_keras.BroadcastGlobalVariablesCallback(0),
                         hvd_keras.MetricAverageCallback()] + callbacks
            # Wire gradient averaging († 'wires the distributed optimizer'):
            # without it ranks train independently and diverge after the
            # step-0 broadcast.
            opt = getattr(self.model, "optimizer", None)
            if opt is not None and not hasattr(opt, "_hvd_op"):
                self.model.optimizer = hvd_keras.DistributedOptimizer(opt)
        if self.store is not None and rank0:
            # rank 0 only: concurrent writers on a shared store corrupt the
            # checkpoint († checkpoint on rank 0).
            import os

            import keras
            path = os.path.join(
                self.store.checkpoint_path(self.run_id), "model.keras")
            callbacks.append(keras.callbacks.ModelCheckpoint(path))

        history = self.model.fit(
            feats, labels, batch_size=self.batch_size, epochs=self.epochs,
            shuffle=self.shuffle, validation_data=val_data,
            callbacks=callbacks, verbose=self.verbose)
        if self.store is not None and rank0:
            self.store.sync(self.run_id)
        return KerasModel(model=self.model, feature_cols=self.feature_cols,
                          label_cols=self.label_cols,
                          history=getattr(history, "history", None))

"""Keras binding, the port of ``horovod_tpu/keras/__init__.py``
(† ``horovod/keras/__init__.py`` + ``horovod/_keras/callbacks.py``):
``BroadcastGlobalVariablesCallback`` (the step-0 weight sync),
``MetricAverageCallback`` (epoch-end metrics averaged across ranks),
``LearningRateWarmupCallback``, ``LearningRateScheduleCallback`` and
``DistributedOptimizer``.

Weights move through numpy, collectives through the port's runtime
(a torch tensor on the runtime's device), so the callbacks work with
Keras 3 on any backend; ``DistributedOptimizer`` needs the TensorFlow
backend (:mod:`horovod_tpu_torch.tensorflow`).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

try:
    import keras
except ImportError as e:            # the card's machine has no Keras
    raise ImportError(
        "horovod_tpu_torch.keras needs Keras, which is not installed "
        f"({e}); the rest of horovod_tpu_torch runs without it") from e

import horovod_tpu_torch as _hvd
from horovod_tpu_torch import (  # noqa: F401  (reference: hvd.* passthrough)
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    size,
)


class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
    """† ``BroadcastGlobalVariablesCallback``: broadcast the initial model
    weights from ``root_rank`` before training, so every rank starts from
    the same weights."""

    def __init__(self, root_rank: int = 0) -> None:
        super().__init__()
        self.root_rank = root_rank
        self._done = False

    def on_train_begin(self, logs=None) -> None:
        if self._done:
            return
        dev = _hvd.global_state().device
        weights = {f"{i:06d}": torch.from_numpy(np.array(w)).to(dev)
                   for i, w in enumerate(self.model.get_weights())}
        _hvd.broadcast_parameters(weights, root_rank=self.root_rank)
        self.model.set_weights([weights[k].cpu().numpy()
                                for k in sorted(weights)])
        self._done = True


class MetricAverageCallback(keras.callbacks.Callback):
    """† ``MetricAverageCallback``: average the epoch-end metrics across
    ranks, so rank 0's logs and checkpoint decisions see the whole job."""

    def on_epoch_end(self, epoch, logs=None) -> None:
        if not logs:
            return
        keys = sorted(k for k, v in logs.items()
                      if isinstance(v, (int, float, np.floating)))
        if not keys:
            return
        values = torch.tensor([float(logs[k]) for k in keys],
                              dtype=torch.float32,
                              device=_hvd.global_state().device)
        averaged = _hvd.allreduce(values, _hvd.Average,
                                  name=f"keras.metrics.{epoch}")
        for k, v in zip(keys, averaged.cpu().tolist()):
            logs[k] = float(v)


class LearningRateWarmupCallback(keras.callbacks.Callback):
    """† ``LearningRateWarmupCallback``: ramp the learning rate from
    ``initial_lr`` to ``initial_lr * multiplier`` (default: the world
    size) over ``warmup_epochs``, batch by batch (Goyal et al.)."""

    def __init__(self, initial_lr: float, warmup_epochs: float = 5.0,
                 multiplier: Optional[float] = None,
                 steps_per_epoch: Optional[int] = None,
                 verbose: bool = False) -> None:
        super().__init__()
        self.initial_lr = initial_lr
        self.warmup_epochs = warmup_epochs
        self.multiplier = multiplier if multiplier is not None else \
            float(_hvd.size())
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose
        self._step = 0

    def _set_lr(self, lr: float) -> None:
        self.model.optimizer.learning_rate = lr

    def on_train_begin(self, logs=None) -> None:
        if self.steps_per_epoch is None:
            params = getattr(self, "params", None) or {}
            self.steps_per_epoch = params.get("steps") or 100

    def on_train_batch_begin(self, batch, logs=None) -> None:
        total = self.warmup_epochs * self.steps_per_epoch
        if self._step >= total:
            return
        progress = self._step / max(total, 1)
        self._set_lr(self.initial_lr
                     * (1.0 + progress * (self.multiplier - 1.0)))
        self._step += 1
        if self._step == total:
            self._set_lr(self.initial_lr * self.multiplier)
            if self.verbose:
                print(f"warmup complete: "
                      f"lr={self.initial_lr * self.multiplier}")


class LearningRateScheduleCallback(keras.callbacks.Callback):
    """† ``LearningRateScheduleCallback``: the base learning rate times
    ``multiplier(epoch)`` within [start_epoch, end_epoch)."""

    def __init__(self, initial_lr: float,
                 multiplier: Callable[[int], float] | float,
                 start_epoch: int = 0,
                 end_epoch: Optional[int] = None) -> None:
        super().__init__()
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def on_epoch_begin(self, epoch, logs=None) -> None:
        if epoch < self.start_epoch:
            return
        if self.end_epoch is not None and epoch >= self.end_epoch:
            return
        self.model.optimizer.learning_rate = \
            self.initial_lr * self.multiplier(epoch)


def DistributedOptimizer(optimizer, **kwargs):
    """† ``horovod.keras.DistributedOptimizer``: a Keras optimizer whose
    gradient application averages across ranks first, through the TF
    binding's wrapper.  Other Keras backends raise rather than train
    un-averaged: on torch, wrap a ``torch.optim`` optimizer with
    ``horovod_tpu_torch.DistributedOptimizer``."""
    if keras.backend.backend() != "tensorflow":
        raise RuntimeError(
            "keras.DistributedOptimizer supports the tensorflow backend; "
            "with torch use horovod_tpu_torch.DistributedOptimizer around "
            "a torch.optim optimizer instead")
    from horovod_tpu_torch.tensorflow import DistributedOptimizer as _tf_dist
    return _tf_dist(optimizer, **kwargs)

"""TF/Keras elastic state, the port of ``horovod_tpu/tensorflow/elastic.py``
(† ``horovod/tensorflow/elastic.py``).

``TensorFlowKerasState(model, optimizer=None, epoch=0, ...)`` over the
port's :class:`~horovod_tpu_torch.elastic.State`: ``commit`` snapshots the
weights on the host (numpy), ``restore`` rolls back, ``sync`` broadcasts
rank 0's weights, optimizer variables and attributes to every rank.
Works with Keras 3 models (TF backend) and bare lists of ``tf.Variable``.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np

from horovod_tpu_torch.elastic import (  # noqa: F401  (reference surface)
    HorovodInternalError,
    HostsUpdatedInterrupt,
    ObjectState,
    State,
    run,
)
from . import broadcast_variables


class TensorFlowKerasState(State):
    """† ``TensorFlowKerasState``: model weights, optimizer variables and
    plain attributes under the commit/restore/sync protocol."""

    def __init__(self, model, optimizer=None, **kwargs: Any) -> None:
        super().__init__()
        self._model = model
        self._optimizer = optimizer
        self._objects: dict[str, Any] = dict(kwargs)
        self._saved: dict[str, Any] = {}
        self.save()

    def __getattr__(self, name: str) -> Any:
        if name == "model":
            return self.__dict__["_model"]
        if name == "optimizer":
            return self.__dict__["_optimizer"]
        objects = self.__dict__.get("_objects", {})
        if name in objects:
            return objects[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            super().__setattr__(name, value)
        elif name in ("model", "optimizer"):
            super().__setattr__("_" + name, value)
        else:
            self._objects[name] = value

    def _opt_vars(self) -> list:
        if self._optimizer is None:
            return []
        variables = self._optimizer.variables
        return list(variables() if callable(variables) else variables)

    def save(self) -> None:
        self._saved = {
            "objects": copy.deepcopy(self._objects),
            "weights": [np.array(w) for w in self._model.get_weights()],
            "opt": [np.array(v) for v in self._opt_vars()],
        }

    def restore(self) -> None:
        self._objects = copy.deepcopy(self._saved["objects"])
        self._model.set_weights([w.copy() for w in self._saved["weights"]])
        for var, val in zip(self._opt_vars(), self._saved["opt"]):
            var.assign(val)

    def sync(self) -> None:
        import horovod_tpu_torch as hvd
        broadcast_variables(self._model.variables, root_rank=0)
        opt_vars = self._opt_vars()
        if opt_vars:
            broadcast_variables(opt_vars, root_rank=0)
        self._objects = hvd.broadcast_object(self._objects, root_rank=0)
        self.save()


# † horovod/keras/elastic.py KerasState is the same object in the Keras 3
# world (tf.keras is keras).
KerasState = TensorFlowKerasState

"""Multi-process worker of the estimator's tests
(``tests/test_torch_estimator.py``).

``launch(mode, outdir, np_)`` runs ``np_`` copies of this script, one rank
each, through the port's launcher on the CPU over Gloo (the machinery of
``tests/mp_torch_port_worker.py``).  Every rank runs the battery of
``mode`` and writes what it got to ``outdir/<mode>.rank<r>.npz`` and
``.json``:

- ``torch``: :class:`Linear` from the test's initial weights
  (``outdir/init.npz``) fitted by ``TorchEstimator`` under plain SGD on
  :func:`regression_cols` with a validation split and a ``LocalStore``,
  then again from the same weights as a streaming fit of
  ``outdir/data.parquet``, and with ``mesh=`` meshes of ``fsdp`` and of
  ``tp`` over every rank (rows split over fsdp, whole on each tp rank):
  each fit's predictions and history, the first two's parameters;
- ``keras``: ``KerasEstimator`` on :func:`keras_model` and
  :func:`regression_cols` with a validation split and a ``LocalStore``:
  the weights, the history and the predictions.

The helpers below build the same model and data for the test, which holds
the np=2 fits against one-process fits of the same inputs.  A rank never
imports the JAX package (nor jax, but for Keras's own import of it).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

import mp_torch_port_worker as W

ENV = {"OMP_NUM_THREADS": "1", "TF_CPP_MIN_LOG_LEVEL": "2"}
FIT = dict(batch_size=64, epochs=5, seed=0, validation=0.25)
LR = 0.05
STREAM = dict(n_rows=1024, n_feat=4, rows_per_group=96, batch_rows=96)
MESH_AXES = ("fsdp", "tp")     # rows split over fsdp, whole on each tp rank
KERAS_FIT = dict(batch_size=32, epochs=4, validation=0.25)
KERAS_LR = 0.05


def launch(mode: str, outdir: str, np_: int, timeout: float = 180) -> list:
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
# models and data (shared with the test)
# ---------------------------------------------------------------------------

def regression_cols(n: int = 256, seed: int = 0) -> dict:
    """``tests/test_estimator.py``'s ``_regression_frame`` as columns."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    w = np.asarray([1.0, -2.0, 0.5, 3.0], np.float32)
    y = x @ w + 0.01 * rng.randn(n).astype(np.float32)
    return {"features": x, "label": y}


def linear_cls():
    import torch

    class Linear(torch.nn.Module):
        """``x @ w + b``: the JAX tests' ``_Linear`` as a module, from
        its parameters (numpy)."""

        def __init__(self, params: dict) -> None:
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(params["w"]))
            self.b = torch.nn.Parameter(torch.tensor(params["b"]))

        def forward(self, x):
            return x @ self.w + self.b

    return Linear


def torch_fit(params: dict, data, *, store=None, streaming: bool = False,
              device=None, mesh=None):
    """A ``TorchEstimator`` fit of ``Linear(params)`` under SGD."""
    import torch
    from horovod_tpu_torch.estimator import TorchEstimator
    model = linear_cls()(params)
    kw = dict(FIT)
    if streaming:
        kw.pop("validation")
    est = TorchEstimator(model=model, feature_cols=["features"],
                         label_cols=["label"], loss="mse",
                         optimizer=torch.optim.SGD(model.parameters(),
                                                   lr=LR),
                         store=store, run_id="np", device=device,
                         mesh=mesh, **kw)
    return est.fit(data)


def keras_model():
    """Dense(1) on 4 inputs, its weights drawn with numpy (the same in
    every process), compiled with SGD and MSE."""
    import keras
    model = keras.Sequential([keras.layers.Input(shape=(4,)),
                              keras.layers.Dense(1)])
    rng = np.random.RandomState(3)
    model.set_weights([rng.randn(*w.shape).astype(np.float32) * 0.1
                       for w in model.get_weights()])
    model.compile(optimizer=keras.optimizers.SGD(KERAS_LR), loss="mse")
    return model


# ---------------------------------------------------------------------------
# the batteries (run in the worker processes)
# ---------------------------------------------------------------------------

def run_torch(hvd, me: int, arrays: dict, info: dict, outdir: str) -> None:
    from horovod_tpu_torch.estimator import LocalStore, ParquetBatches
    with np.load(os.path.join(outdir, "init.npz")) as z:
        params = {k: z[k] for k in z.files}
    cols = regression_cols()
    fitted = torch_fit(params, cols,
                       store=LocalStore(os.path.join(outdir, "store")))
    arrays["preds"] = fitted.predict(cols)
    info["history"] = fitted.history
    for name, p in fitted.module.named_parameters():
        arrays[f"param.{name}"] = p.detach().numpy().copy()
    streamed = torch_fit(params, ParquetBatches(
        os.path.join(outdir, "data.parquet"),
        batch_rows=STREAM["batch_rows"]), streaming=True)
    arrays["stream.preds"] = streamed.predict(cols)
    info["stream.history"] = streamed.history
    for name, p in streamed.module.named_parameters():
        arrays[f"stream.param.{name}"] = p.detach().numpy().copy()
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh
    for axis in MESH_AXES:
        meshed = torch_fit(params, cols, mesh=build_mesh(
            MeshConfig(**{axis: hvd.size()})))
        arrays[f"{axis}.preds"] = meshed.predict(cols)
        info[f"{axis}.history"] = meshed.history


def run_keras(hvd, me: int, arrays: dict, info: dict, outdir: str) -> None:
    from horovod_tpu_torch.estimator import KerasEstimator, LocalStore
    cols = regression_cols(128)
    est = KerasEstimator(model=keras_model(), feature_cols=["features"],
                         label_cols=["label"],
                         store=LocalStore(os.path.join(outdir, "store")),
                         run_id="k", **KERAS_FIT)
    fitted = est.fit(cols)
    info["history"] = {k: [float(v) for v in vs]
                       for k, vs in fitted.history.items()}
    info["optimizer"] = type(fitted.model.optimizer).__name__
    for i, w in enumerate(fitted.model.get_weights()):
        arrays[f"weight.{i}"] = np.asarray(w)
    arrays["preds"] = fitted.predict(cols)


BATTERIES = {"torch": run_torch, "keras": run_keras}


def main(mode: str, outdir: str) -> int:
    sys.path.insert(0, W.REPO)
    import horovod_tpu_torch as hvd
    hvd.init()
    me = hvd.rank()
    arrays: dict = {}
    info: dict = {}
    BATTERIES[mode](hvd, me, arrays, info, outdir)
    # Keras 3 imports jax where it is installed, so the keras battery is
    # held to the absence of the JAX package alone.
    mods = list(sys.modules)
    info["ref_loaded"] = any(m.split(".")[0] == "horovod_tpu" for m in mods)
    info["jax_loaded"] = info["ref_loaded"] or any(
        m == "jax" or m.startswith(("jax.", "jaxlib", "flax")) for m in mods)
    np.savez(os.path.join(outdir, f"{mode}.rank{me}.npz"), **arrays)
    with open(os.path.join(outdir, f"{mode}.rank{me}.json"), "w") as f:
        json.dump(info, f)
    hvd.shutdown()
    print(f"rank {me}: {mode} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))

"""Multi-process worker of the port's TensorFlow binding tests
(``tests/test_torch_tensorflow.py``).

``launch(outdir, np_)`` runs ``np_`` copies of this script, one rank each,
through the port's launcher on the CPU over Gloo.  Every rank runs the
binding on rank-distinct data and writes ``outdir/tf.rank<r>.npz`` and
``.json``:

- the verbs: Sum and Average of :func:`rank_value`, a broadcast from rank
  1, an allgather, a variable broadcast from rank 0;
- one SGD step of :func:`make_model` on the rank's own data
  (:func:`rank_data`) three ways: ``DistributedGradientTape`` with a plain
  optimizer (``tape``), a plain tape with ``DistributedOptimizer``
  (``optimizer``), and ``model.fit`` with ``DistributedOptimizer``
  (``fit``); the weights after each.

The helpers below build the same models and data for the test, which
holds each rank's weights against one plain step on the mean of the two
ranks' gradients (:func:`expected_weights`).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

import mp_torch_port_worker as W

ENV = {"OMP_NUM_THREADS": "1", "TF_CPP_MIN_LOG_LEVEL": "2"}
LR = 0.1
N_RANK = 8          # examples a rank


def launch(outdir: str, np_: int, timeout: float = 180) -> list:
    return W.launch("tf", outdir, np_=np_, timeout=timeout, extra_env=ENV,
                    script=__file__)


# ---------------------------------------------------------------------------
# models and data (shared with the test)
# ---------------------------------------------------------------------------

def data(n: int, seed: int = 0) -> tuple:
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 4).astype(np.float32),
            rng.randn(n, 1).astype(np.float32))


def rank_data(r: int) -> tuple:
    return data(N_RANK, seed=10 + r)


def rank_value(r: int) -> np.ndarray:
    return np.arange(6, dtype=np.float32).reshape(2, 3) * (r + 1) + r


def make_model():
    """Dense(3, relu) → Dense(1) on 4 inputs, its weights drawn with
    numpy (the same in every process)."""
    import keras
    model = keras.Sequential([keras.layers.Input((4,)),
                              keras.layers.Dense(3, activation="relu"),
                              keras.layers.Dense(1)])
    rng = np.random.RandomState(7)
    model.set_weights([rng.randn(*w.shape).astype(np.float32) * 0.5
                       for w in model.get_weights()])
    return model


def grads(model, x, y) -> list:
    import tensorflow as tf
    with tf.GradientTape() as tape:
        loss = tf.reduce_mean(tf.square(model(x) - y))
    return tape.gradient(loss, model.trainable_variables)


def sgd_step(model, opt, x, y) -> None:
    opt.apply_gradients(zip(grads(model, x, y), model.trainable_variables))


def expected_weights(path: str) -> list:
    """One plain SGD step on the mean of the two ranks' gradients (the
    same for every path: each averages the same gradients)."""
    import keras
    model = make_model()
    g = [(a + b) / 2 for a, b in zip(grads(model, *rank_data(0)),
                                     grads(model, *rank_data(1)))]
    keras.optimizers.SGD(learning_rate=LR).apply_gradients(
        zip(g, model.trainable_variables))
    return model.get_weights()


# ---------------------------------------------------------------------------
# the battery (run in the worker processes)
# ---------------------------------------------------------------------------

def run(outdir: str) -> int:
    sys.path.insert(0, W.REPO)
    import keras
    import tensorflow as tf
    import horovod_tpu_torch.tensorflow as hvd
    hvd.init()
    me, n = hvd.rank(), hvd.size()
    arrays: dict = {}
    t = tf.constant(rank_value(me))
    arrays["sum"] = hvd.allreduce(t, hvd.Sum, name="sum").numpy()
    arrays["average"] = hvd.allreduce(t, hvd.Average, name="avg").numpy()
    arrays["broadcast"] = hvd.broadcast(t, root_rank=1, name="bc").numpy()
    arrays["allgather"] = hvd.allgather(t, name="ag").numpy()
    var = tf.Variable(rank_value(me))
    hvd.broadcast_variables([var], root_rank=0)
    arrays["variable"] = var.numpy()

    x, y = rank_data(me)
    model = make_model()
    with hvd.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = tf.reduce_mean(tf.square(model(x) - y))
    g = tape.gradient(loss, model.trainable_variables)
    keras.optimizers.SGD(learning_rate=LR).apply_gradients(
        zip(g, model.trainable_variables))
    results = {"tape": model.get_weights()}

    model = make_model()
    sgd_step(model, hvd.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=LR)), x, y)
    results["optimizer"] = model.get_weights()

    model = make_model()
    model.compile(optimizer=hvd.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=LR)), loss="mse")
    model.fit(x, y, batch_size=N_RANK, epochs=1, verbose=0, shuffle=False)
    results["fit"] = model.get_weights()
    for path, weights in results.items():
        for i, w in enumerate(weights):
            arrays[f"{path}.{i}"] = np.asarray(w)

    # Keras 3 imports jax itself where it is installed; the JAX package
    # must not be loaded.
    info = {"rank": me, "size": n, "jax_package_loaded": any(
        m.split(".")[0] == "horovod_tpu" for m in list(sys.modules))}
    np.savez(os.path.join(outdir, f"tf.rank{me}.npz"), **arrays)
    with open(os.path.join(outdir, f"tf.rank{me}.json"), "w") as f:
        json.dump(info, f)
    hvd.shutdown()
    print(f"rank {me}: tf OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[2]))

"""The port's TensorFlow and Keras bindings (``horovod_tpu_torch.
tensorflow``, ``.tensorflow.keras``, ``.tensorflow.elastic``, ``.keras``)
against the JAX package's, on the CPU.

The JAX package's tests run ``N = 8`` local devices in one process; the
port has one rank a process.  So the in-process cases compare the two as
functions of ``size()`` (8 there, 1 here): an allreduce's Sum is
``x * size`` and its Average ``x``; a broadcast returns the root's
tensor; an allgather has shape ``(size, ...)``; a tape, an optimizer and
``model.fit`` under replicas that hold the same data equal the plain
ones, in both packages, from the same initial weights and data within
1e-6.  Rank-distinct data is the job of ``tests/mp_torch_tf_worker.py``
at np=2 over Gloo: each rank's gradients are the mean of the two ranks'
plain gradients.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
keras = pytest.importorskip("keras")

import horovod_tpu as ref_hvd  # noqa: E402
import horovod_tpu.keras as ref_keras  # noqa: E402
import horovod_tpu.tensorflow as ref_tf  # noqa: E402
import horovod_tpu.tensorflow.elastic as ref_tfe  # noqa: E402

import mp_torch_dataplane_worker as DW  # noqa: E402
import mp_torch_tf_worker as TW  # noqa: E402

TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port():
    """The port's runtime at one rank on the CPU, with its TF binding."""
    import horovod_tpu_torch as hvd
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith(("HVDTPU_", "HOROVOD_"))}
    hvd.init(config=hvd.Config(platform="cpu"))
    import horovod_tpu_torch.tensorflow as hvd_tf
    yield hvd_tf
    hvd.shutdown()
    os.environ.update(saved)


BOTH = pytest.mark.parametrize("which", ["port", "ref"])


def _binding(which, port):
    return port if which == "port" else ref_tf


# ---------------------------------------------------------------------------
# verbs
# ---------------------------------------------------------------------------

@BOTH
def test_allreduce_sum_is_x_times_size(which, port):
    b = _binding(which, port)
    t = tf.constant([1.0, 2.0, 3.0])
    out = b.allreduce(t, b.Sum)
    assert out.dtype == t.dtype
    np.testing.assert_allclose(out.numpy(), t.numpy() * b.size(), rtol=0,
                               atol=TOL)


@BOTH
def test_allreduce_average_is_x(which, port):
    b = _binding(which, port)
    t = tf.constant(np.random.RandomState(0).randn(3, 4).astype(np.float32))
    np.testing.assert_allclose(b.allreduce(t, b.Average).numpy(), t.numpy(),
                               rtol=0, atol=TOL)


@BOTH
def test_allreduce_inside_tf_function(which, port):
    b = _binding(which, port)

    @tf.function
    def fn(x):
        return b.allreduce(x, b.Sum)

    out = fn(tf.constant([2.0, 4.0]))
    np.testing.assert_allclose(out.numpy(), [2.0 * b.size(), 4.0 * b.size()])


@BOTH
def test_broadcast_and_allgather(which, port):
    b = _binding(which, port)
    t = tf.constant([[5, 6]], dtype=tf.int32)
    root = b.size() - 1
    out = b.broadcast(t, root_rank=root)
    assert out.dtype == tf.int32
    np.testing.assert_array_equal(out.numpy(), [[5, 6]])
    gathered = b.allgather(t)
    assert gathered.shape == (b.size(), 2)
    np.testing.assert_array_equal(gathered.numpy(),
                                  np.tile([[5, 6]], (b.size(), 1)))


def test_alltoall_and_reducescatter_at_one_rank(port):
    t = tf.constant(np.arange(6, dtype=np.float32).reshape(3, 2))
    np.testing.assert_array_equal(port.alltoall(t).numpy(), t.numpy())
    np.testing.assert_array_equal(port.reducescatter(t).numpy(), t.numpy())


@BOTH
def test_async_roundtrip(which, port):
    b = _binding(which, port)
    h = b.allreduce_async(tf.ones((4,)), b.Sum, name=f"tf.async.{which}")
    out = b.synchronize(h)
    assert b.poll(h)
    np.testing.assert_allclose(out.numpy(), np.full((4,), float(b.size())))


@BOTH
def test_broadcast_variables_in_place(which, port):
    b = _binding(which, port)
    v1 = tf.Variable([1.0, 2.0])
    v2 = tf.Variable([[3.0]])
    b.broadcast_variables([v1, v2], root_rank=0)
    np.testing.assert_array_equal(v1.numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(v2.numpy(), [[3.0]])


# ---------------------------------------------------------------------------
# DistributedGradientTape
# ---------------------------------------------------------------------------

def _plain_grad(x, w):
    with tf.GradientTape() as tape:
        loss = tf.reduce_mean(tf.square(x @ w))
    return tape.gradient(loss, [w])[0].numpy()


@BOTH
def test_distributed_gradient_tape_matches_plain(which, port):
    b = _binding(which, port)
    x = tf.constant(np.random.RandomState(1).randn(8, 4).astype(np.float32))
    w = tf.Variable(np.random.RandomState(2).randn(4, 1).astype(np.float32))
    with b.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = tf.reduce_mean(tf.square(x @ w))
    got = tape.gradient(loss, [w])[0].numpy()
    np.testing.assert_allclose(got, _plain_grad(x, w), rtol=0, atol=TOL)


@pytest.mark.parametrize("compression", ["none", "fp16", "int8"])
def test_tape_compression_at_one_rank(compression, port):
    """A cast compressor round-trips through bf16, a quantized one is the
    engine's wire mode (inert at one rank)."""
    x = tf.constant(np.random.RandomState(3).randn(8, 4).astype(np.float32))
    w = tf.Variable(np.random.RandomState(4).randn(4, 3).astype(np.float32))
    with port.DistributedGradientTape(
            tf.GradientTape(),
            compression=getattr(port.Compression, compression)) as tape:
        loss = tf.reduce_mean(tf.square(x @ w))
    got = tape.gradient(loss, [w])[0].numpy()
    plain = _plain_grad(x, w)
    tol = 2.0 ** -8 * np.abs(plain).max() if compression == "fp16" else TOL
    np.testing.assert_allclose(got, plain, rtol=0, atol=tol)


def test_tape_densifies_indexed_slices(port):
    table = tf.Variable(np.random.RandomState(5).randn(6, 3)
                        .astype(np.float32))
    idx = tf.constant([0, 2, 2, 5])
    with port.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = tf.reduce_sum(tf.gather(table, idx) ** 2)
    got = tape.gradient(loss, [table])[0]
    with tf.GradientTape() as plain:
        loss = tf.reduce_sum(tf.gather(table, idx) ** 2)
    ref = plain.gradient(loss, [table])[0]
    assert isinstance(ref, tf.IndexedSlices)
    assert not isinstance(got, tf.IndexedSlices)
    np.testing.assert_allclose(got.numpy(), tf.convert_to_tensor(ref).numpy(),
                               rtol=0, atol=TOL)


@BOTH
def test_gradient_tape_and_broadcast_inside_tf_function(which, port):
    # † the reference's documented TF2 pattern: DistributedGradientTape +
    # first-batch broadcast_variables, all inside one @tf.function.
    b = _binding(which, port)
    w = tf.Variable([[1.0], [2.0]])
    x = tf.constant([[3.0, 4.0]])

    @tf.function
    def step(first):
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(x @ w)
        grads = b.DistributedGradientTape(tape).gradient(loss, [w])
        if first:
            b.broadcast_variables([w], root_rank=0)
        return grads[0]

    g = step(tf.constant(True))
    np.testing.assert_allclose(g.numpy(), [[3.0], [4.0]])
    np.testing.assert_allclose(w.numpy(), [[1.0], [2.0]])


@BOTH
def test_gradient_tape_none_grads_pass_through(which, port):
    b = _binding(which, port)
    w = tf.Variable([1.0])
    unused = tf.Variable([2.0])
    with b.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = tf.reduce_sum(w * 3.0)
    grads = tape.gradient(loss, [w, unused])
    assert grads[1] is None
    np.testing.assert_allclose(grads[0].numpy(), [3.0])


# ---------------------------------------------------------------------------
# DistributedOptimizer
# ---------------------------------------------------------------------------

def _data(n=16, seed=0):
    return TW.data(n, seed)


@BOTH
def test_distributed_optimizer_eager_matches_plain(which, port):
    b = _binding(which, port)
    x, y = _data()
    ref = TW.make_model()
    TW.sgd_step(ref, keras.optimizers.SGD(learning_rate=0.1), x, y)
    dist = TW.make_model()
    opt = b.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.1))
    assert type(opt).__name__ == "DistributedSGD"
    TW.sgd_step(dist, opt, x, y)
    for a, c in zip(ref.get_weights(), dist.get_weights()):
        np.testing.assert_allclose(c, a, rtol=0, atol=TOL)


@BOTH
def test_distributed_optimizer_model_fit_matches_plain(which, port):
    b = _binding(which, port)
    x, y = _data(32)
    plain = TW.make_model()
    plain.compile(optimizer=keras.optimizers.SGD(learning_rate=0.05),
                  loss="mse")
    plain.fit(x, y, batch_size=16, epochs=1, verbose=0, shuffle=False)
    model = TW.make_model()
    model.compile(optimizer=b.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=0.05)), loss="mse")
    before = [w.copy() for w in model.get_weights()]
    hist = model.fit(x, y, batch_size=16, epochs=1, verbose=0, shuffle=False)
    assert np.isfinite(hist.history["loss"][0])
    after = model.get_weights()
    assert any(not np.allclose(a, c) for a, c in zip(before, after))
    for a, c in zip(plain.get_weights(), after):
        np.testing.assert_allclose(c, a, rtol=0, atol=TOL)


@BOTH
def test_distributed_optimizer_backward_passes_per_step(which, port):
    b = _binding(which, port)
    x, y = _data(8)
    # Plain: one step on the mean of two micro-batch gradients.
    ref = TW.make_model()
    grads_sum = None
    for sl in (slice(0, 4), slice(4, 8)):
        gs = TW.grads(ref, x[sl], y[sl])
        grads_sum = gs if grads_sum is None else [
            a + c for a, c in zip(grads_sum, gs)]
    keras.optimizers.SGD(learning_rate=0.1).apply_gradients(
        zip([g / 2 for g in grads_sum], ref.trainable_variables))
    dist = TW.make_model()
    opt = b.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.1),
                                 backward_passes_per_step=2)
    for sl in (slice(0, 4), slice(4, 8)):
        opt.apply_gradients(zip(TW.grads(dist, x[sl], y[sl]),
                                dist.trainable_variables))
    for a, c in zip(ref.get_weights(), dist.get_weights()):
        np.testing.assert_allclose(c, a, rtol=0, atol=TOL)


def test_tf_keras_module_surface(port):
    import horovod_tpu_torch.keras as hvd_keras
    import horovod_tpu_torch.tensorflow.keras as hvd_tfk
    import horovod_tpu.tensorflow.keras as ref_tfk
    assert hvd_tfk.size() == 1 and ref_tfk.size() == ref_hvd.size()
    assert callable(hvd_tfk.DistributedOptimizer)
    assert hvd_tfk.callbacks is hvd_keras
    assert hvd_tfk.callbacks.BroadcastGlobalVariablesCallback is \
        hvd_keras.BroadcastGlobalVariablesCallback
    assert port.elastic.TensorFlowKerasState is not None
    assert set(dir(ref_tfk)) - set(dir(hvd_tfk)) <= {"_k"}


# ---------------------------------------------------------------------------
# Keras callbacks (tests/test_bindings.py's Keras cases)
# ---------------------------------------------------------------------------

def _keras_binding(which):
    if which == "ref":
        return ref_keras
    import horovod_tpu_torch.keras as hvd_keras
    return hvd_keras


def _tiny_keras_model():
    model = keras.Sequential([keras.layers.Input((4,)),
                              keras.layers.Dense(2)])
    model.compile(optimizer=keras.optimizers.SGD(0.1), loss="mse")
    return model


@BOTH
def test_keras_broadcast_callback_preserves_weights(which, port):
    k = _keras_binding(which)
    model = _tiny_keras_model()
    before = [w.copy() for w in model.get_weights()]
    cb = k.BroadcastGlobalVariablesCallback(0)
    cb.set_model(model)
    cb.on_train_begin()
    for b, a in zip(before, model.get_weights()):
        np.testing.assert_array_equal(b, a)


@BOTH
def test_keras_metric_average_callback(which, port):
    k = _keras_binding(which)
    logs = {"loss": 2.0, "acc": 0.5, "name": "x"}
    k.MetricAverageCallback().on_epoch_end(0, logs)
    assert logs == {"loss": pytest.approx(2.0), "acc": pytest.approx(0.5),
                    "name": "x"}


@BOTH
def test_keras_warmup_callback_ramps_lr(which, port):
    k = _keras_binding(which)
    model = _tiny_keras_model()
    cb = k.LearningRateWarmupCallback(
        initial_lr=0.1, warmup_epochs=1, multiplier=8.0, steps_per_epoch=10)
    cb.set_model(model)
    cb.on_train_begin()
    lrs = []
    for step in range(10):
        cb.on_train_batch_begin(step)
        lrs.append(float(np.asarray(model.optimizer.learning_rate)))
    assert lrs[0] == pytest.approx(0.1)
    assert all(a < b for a, b in zip(lrs, lrs[1:-1]))
    cb.on_train_batch_begin(10)
    assert float(np.asarray(model.optimizer.learning_rate)) == \
        pytest.approx(0.8)
    # the default multiplier is the world size
    assert k.LearningRateWarmupCallback(0.1).multiplier == float(k.size())


@BOTH
def test_keras_schedule_callback(which, port):
    k = _keras_binding(which)
    model = _tiny_keras_model()
    cb = k.LearningRateScheduleCallback(
        initial_lr=0.1, multiplier=lambda e: 0.1 ** e, start_epoch=1,
        end_epoch=3)
    cb.set_model(model)
    cb.on_epoch_begin(0)   # before start: untouched
    lr0 = float(np.asarray(model.optimizer.learning_rate))
    cb.on_epoch_begin(2)
    lr2 = float(np.asarray(model.optimizer.learning_rate))
    cb.on_epoch_begin(3)   # past the end: untouched
    lr3 = float(np.asarray(model.optimizer.learning_rate))
    assert lr0 == pytest.approx(0.1)
    assert lr2 == pytest.approx(0.001) and lr3 == pytest.approx(0.001)


def test_keras_distributed_optimizer_routes_through_tf(port):
    import horovod_tpu_torch.keras as hvd_keras
    opt = hvd_keras.DistributedOptimizer(keras.optimizers.Adam(1e-3))
    assert type(opt).__name__ == "DistributedAdam"


# ---------------------------------------------------------------------------
# TensorFlowKerasState (tests/test_framework_states.py's TF cases)
# ---------------------------------------------------------------------------

def _tfe(which):
    if which == "ref":
        return ref_tfe
    import horovod_tpu_torch.tensorflow.elastic as tfe
    return tfe


@BOTH
def test_tf_keras_state_commit_restore(which, port):
    tfe = _tfe(which)
    keras.utils.set_random_seed(0)
    model = keras.Sequential([keras.layers.Input((4,)),
                              keras.layers.Dense(2)])
    opt = keras.optimizers.SGD(0.1, momentum=0.9)
    TW.sgd_step(model, opt, *_data(4))
    state = tfe.TensorFlowKerasState(model, optimizer=opt, epoch=2)
    before = [w.copy() for w in model.get_weights()]
    opt_before = [np.array(v) for v in opt.variables]
    state.commit()
    TW.sgd_step(model, opt, *_data(4, seed=1))
    state.epoch = 5
    state.restore()
    assert state.epoch == 2 and state.model is model
    for a, b in zip(model.get_weights(), before):
        np.testing.assert_array_equal(a, b)
    for v, b in zip(opt.variables, opt_before):
        np.testing.assert_array_equal(np.array(v), b)


@BOTH
def test_tf_keras_state_sync(which, port):
    tfe = _tfe(which)
    model = keras.Sequential([keras.layers.Input((3,)),
                              keras.layers.Dense(1)])
    state = tfe.TensorFlowKerasState(model, batch=1)
    before = [w.copy() for w in model.get_weights()]
    state.sync()
    for a, b in zip(model.get_weights(), before):
        np.testing.assert_array_equal(a, b)
    assert state.batch == 1
    assert tfe.KerasState is tfe.TensorFlowKerasState


# ---------------------------------------------------------------------------
# two ranks over Gloo, rank-distinct data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("tf2"))
    DW.check_ranks(TW.launch(outdir, 2))
    out = []
    for r in range(2):
        with np.load(os.path.join(outdir, f"tf.rank{r}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(outdir, f"tf.rank{r}.json")) as f:
            out.append((arrays, json.load(f)))
    return out


@pytest.mark.integration
def test_two_ranks_verbs(two_ranks):
    for r, (arrays, info) in enumerate(two_ranks):
        assert info["size"] == 2 and info["rank"] == r
        assert not info["jax_package_loaded"]
        np.testing.assert_array_equal(arrays["sum"], TW.rank_value(0)
                                      + TW.rank_value(1))
        np.testing.assert_allclose(arrays["average"], (TW.rank_value(0)
                                   + TW.rank_value(1)) / 2, rtol=0, atol=TOL)
        np.testing.assert_array_equal(arrays["broadcast"], TW.rank_value(1))
        np.testing.assert_array_equal(
            arrays["allgather"], np.concatenate([TW.rank_value(0),
                                                 TW.rank_value(1)]))
        np.testing.assert_array_equal(arrays["variable"], TW.rank_value(0))


@pytest.mark.integration
@pytest.mark.parametrize("path", ["tape", "optimizer", "fit"])
def test_two_ranks_average_the_ranks_plain_gradients(two_ranks, path):
    """Each rank's update is the mean of the two ranks' plain gradients,
    and both ranks end with the same weights."""
    want = TW.expected_weights(path)
    for arrays, _ in two_ranks:
        for i, w in enumerate(want):
            np.testing.assert_allclose(arrays[f"{path}.{i}"], w, rtol=0,
                                       atol=TOL)


def test_port_imports_without_tensorflow():
    """In a process where ``tensorflow`` and ``keras`` cannot be imported
    (the card's machine has neither): the port, its models and runner,
    and ``chip_smoke`` import; the TF binding raises a clear
    ``ImportError``."""
    code = (
        "import sys\n"
        "sys.modules['tensorflow'] = None\n"
        "sys.modules['keras'] = None\n"
        "import horovod_tpu_torch\n"
        "from horovod_tpu_torch.models import bert, dlrm, llama, mnist, "
        "resnet\n"
        "from horovod_tpu_torch.runner import cloud, launch\n"
        "import chip_smoke\n"
        "for mod in ('horovod_tpu_torch.tensorflow', "
        "'horovod_tpu_torch.keras'):\n"
        "    try:\n"
        "        __import__(mod)\n"
        "    except ImportError as e:\n"
        "        print('REFUSED', mod, e)\n"
        "    else:\n"
        "        print('IMPORTED', mod)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and m.split('.')[0] in "
        "('tensorflow', 'keras', 'jax', 'flax', 'horovod_tpu')]\n"
        "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "REFUSED horovod_tpu_torch.tensorflow horovod_tpu_torch." \
        "tensorflow needs TensorFlow" in out, out
    assert "REFUSED horovod_tpu_torch.keras horovod_tpu_torch.keras " \
        "needs Keras" in out, out
    assert "LOADED []" in out, out

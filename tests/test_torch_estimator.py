"""The port's estimator layer (``horovod_tpu_torch.estimator``: the store,
``TorchEstimator``, ``KerasEstimator``) against the JAX package's, on the
CPU.

- **Store cases**: ``tests/test_estimator.py``'s store, parquet,
  ``to_columns`` and ``train_val_split`` cases run through both packages
  on the same inputs, their outputs compared (arrays equal, the same
  objects and bytes in the fake object store, the same refusals).
- **Behaviour**: ``TorchEstimator`` learns, checkpoints to a store,
  refuses tiny data, streams from parquet, fits against an
  ``InMemoryObjectStore`` and ingests a Spark-like frame, as
  ``JaxEstimator`` does in ``tests/test_estimator.py``.
- **Numbers**: a linear model from the JAX tests' ``_Linear`` initial
  weights (drawn by JAX, carried across as numpy) under plain SGD, same
  seed and batch, fp32 inputs: ``TorchEstimator``'s predictions and
  history within rtol 1e-5 of ``JaxEstimator``'s, materialized (with a
  validation split) and streaming; and the same fits at np=2 over Gloo
  (``tests/mp_torch_estimator_worker.py``), also with ``mesh=`` (fsdp=2;
  tp=2, where each rank takes the whole batch), within rtol 1e-5 of the
  one-process fits, with bitwise equal parameters on both ranks.  The
  history's scalars are held elementwise; arrays normwise (``max |got -
  ref| <= 1e-5 max |ref|``), since a prediction near 0 carries the
  rounding of its neighbours' size (1.5e-7 against 4.6 at most here).
- **Keras**: the reference's fit/predict/transform/checkpoint case, and
  at np=2 equal weights on both ranks, the checkpoint on rank 0's store.
- **Streaming memory**: peak-RSS growth of a materialized fit of a
  410 MB parquet against a streaming fit of it, in child processes.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu.estimator as ref_est
import horovod_tpu.estimator.store as ref_store
import horovod_tpu_torch.estimator as est
import horovod_tpu_torch.estimator.store as store
import mp_torch_dataplane_worker as DW
import mp_torch_estimator_worker as EW
from test_estimator import (_FakeSparkDataFrame, _Linear,
                            _regression_frame,
                            _write_multi_rowgroup_parquet)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
BOTH = pytest.mark.parametrize("which", ["port", "ref"])


def _store_mod(which):
    return store if which == "port" else ref_store


def _assert_cols_equal(got: dict, ref: dict) -> None:
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# data ingestion and stores, both packages
# ---------------------------------------------------------------------------

def test_to_columns_from_dataframe_and_dict_match():
    df = _regression_frame(32)
    cols = store.to_columns(df)
    assert cols["features"].shape == (32, 4)
    assert cols["label"].shape == (32,)
    _assert_cols_equal(cols, ref_store.to_columns(df))
    d = {"a": [1, 2], "b": [3.0, 4.0]}
    _assert_cols_equal(store.to_columns(d), ref_store.to_columns(d))
    assert store.to_columns(d)["a"].tolist() == [1, 2]
    rec = np.zeros(3, dtype=[("x", np.float32), ("y", np.int64)])
    rec["x"] = [1, 2, 3]
    _assert_cols_equal(store.to_columns(rec, columns=["y"]),
                       ref_store.to_columns(rec, columns=["y"]))


def test_to_columns_parquet_roundtrip_matches(tmp_path):
    import pandas as pd
    df = pd.DataFrame({"x": np.arange(10.0), "y": np.arange(10) % 2})
    df.to_parquet(str(tmp_path / "part-0.parquet"))
    df.to_parquet(str(tmp_path / "part-1.parquet"))
    cols = store.to_columns(str(tmp_path))
    assert cols["x"].shape == (20,)
    np.testing.assert_allclose(cols["x"][:10], np.arange(10.0))
    _assert_cols_equal(cols, ref_store.to_columns(str(tmp_path)))
    _assert_cols_equal(store.to_columns(str(tmp_path), columns=["y"]),
                       ref_store.to_columns(str(tmp_path), columns=["y"]))


@BOTH
def test_to_columns_validation_errors(which):
    m = _store_mod(which)
    with pytest.raises(ValueError, match="ragged"):
        m.to_columns({"a": [1, 2], "b": [1, 2, 3]})
    with pytest.raises(KeyError, match="missing"):
        m.to_columns({"a": [1]}, columns=["missing"])
    with pytest.raises(TypeError, match="unsupported"):
        m.to_columns(42)
    with pytest.raises(FileNotFoundError):
        m.to_columns("/nonexistent-dir-for-the-test/")


def test_train_val_split_matches():
    cols = {"x": np.arange(100), "y": np.arange(100) * 2}
    tr, va = store.train_val_split(cols, 0.25, seed=0)
    assert len(va["x"]) == 25 and len(tr["x"]) == 75
    assert sorted(np.concatenate([tr["x"], va["x"]]).tolist()) == \
        list(range(100))
    rtr, rva = ref_store.train_val_split(cols, 0.25, seed=0)
    _assert_cols_equal(tr, rtr)
    _assert_cols_equal(va, rva)


def test_parquet_batches_stream_the_reference_s_chunks(tmp_path):
    path = str(tmp_path / "data.parquet")
    _write_multi_rowgroup_parquet(path, n_rows=1000, n_feat=8,
                                  rows_per_group=128)
    got = store.ParquetBatches(path, columns=["features", "label"],
                               batch_rows=128)
    ref = ref_store.ParquetBatches(path, columns=["features", "label"],
                                   batch_rows=128)
    assert len(got) == len(ref) == 1000
    chunks = list(got)
    assert len(chunks) >= 8
    for a, b in zip(chunks, ref, strict=True):
        assert set(a) == {"features", "label"}
        assert a["features"].shape[1] == 8 and len(a["features"]) <= 128
        _assert_cols_equal(a, b)
    # a second iteration re-opens the files
    assert sum(len(c["label"]) for c in got) == 1000
    _assert_cols_equal(got.first_rows(3), ref.first_rows(3))
    with pytest.raises(KeyError, match="nope"):
        store.ParquetBatches(path, columns=["nope"])
    with pytest.raises(FileNotFoundError):
        store.ParquetBatches(str(tmp_path / "empty-dir-missing"))


@BOTH
def test_store_create_flavors(which, tmp_path):
    m = _store_mod(which)
    st = m.Store.create(str(tmp_path / "artifacts"))
    assert isinstance(st, m.FilesystemStore)
    ck = st.checkpoint_path("run1")
    assert os.path.isdir(ck) and "runs/run1" in ck.replace(os.sep, "/")
    assert os.path.isdir(st.logs_path("run1"))
    assert isinstance(m.LocalStore(str(tmp_path)), m.FilesystemStore)
    with pytest.raises(ValueError, match="mount.*register|register"):
        m.Store.create("gs://bucket/prefix")


@BOTH
def test_store_register_resolves_scheme(which):
    m = _store_mod(which)
    scheme = f"fakegs{which}"
    m.Store.register(scheme)(m.InMemoryObjectStore)
    try:
        st = m.Store.create(f"{scheme}://bucket-{which}/some/prefix")
        assert isinstance(st, m.InMemoryObjectStore)
        st.obj_write("runs/r1/x.bin", b"payload")
        assert st.obj_exists("runs/r1/x.bin")
        st2 = m.Store.create(f"{scheme}://bucket-{which}/some/prefix")
        assert st2.obj_read("runs/r1/x.bin") == b"payload"
        assert st2.obj_list("runs/r1/") == ["runs/r1/x.bin"]
    finally:
        m.Store._registry.pop(scheme, None)


def _stage_run(m, uri: str, run: str):
    st = m.InMemoryObjectStore(uri)
    ck = st.checkpoint_path(run)
    with open(os.path.join(ck, "weights.bin"), "wb") as f:
        f.write(b"\x01\x02")
    with open(os.path.join(st.logs_path(run), "log.txt"), "w") as f:
        f.write("hello")
    st.sync(run)
    return st


def test_remote_store_stage_sync_fetch_roundtrip_matches():
    got = _stage_run(store, "fake://bkt-rt-port/pfx", "r7")
    ref = _stage_run(ref_store, "fake://bkt-rt-ref/pfx", "r7")
    assert got.obj_list("runs/r7/") == ref.obj_list("runs/r7/") == [
        "runs/r7/checkpoints/weights.bin", "runs/r7/logs/log.txt"]
    for key in got.obj_list("runs/r7/"):
        assert got.obj_read(key) == ref.obj_read(key)
    root = store.InMemoryObjectStore("fake://bkt-rt-port/pfx").fetch("r7")
    with open(os.path.join(root, "checkpoints", "weights.bin"), "rb") as f:
        assert f.read() == b"\x01\x02"
    with open(os.path.join(root, "logs", "log.txt")) as f:
        assert f.read() == "hello"


@BOTH
def test_remote_store_sync_catches_same_size_rewrite(which):
    m = _store_mod(which)
    st = m.InMemoryObjectStore(f"fake://bkt-rw-{which}/pfx")
    path = os.path.join(st.checkpoint_path("r8"), "weights.bin")
    with open(path, "wb") as f:
        f.write(b"aaaa")
    st.sync("r8")
    mt = os.stat(path)
    with open(path, "wb") as f:          # same size, new content
        f.write(b"bbbb")
    os.utime(path, ns=(mt.st_atime_ns, mt.st_mtime_ns))  # freeze mtime
    st.sync("r8")
    assert st.obj_read("runs/r8/checkpoints/weights.bin") == b"bbbb"


@BOTH
def test_remote_store_fetch_rejects_escaping_keys(which, tmp_path):
    m = _store_mod(which)
    st = m.InMemoryObjectStore(f"fake://bkt-esc-{which}/pfx")
    st.obj_write("runs/r9/../../evil.bin", b"x")
    st.obj_write("runs/r9/ok.bin", b"y")
    with pytest.raises(ValueError, match="escapes"):
        st.fetch("r9", str(tmp_path / "fetched"))
    assert not os.path.exists(str(tmp_path / "evil.bin"))


def test_layer_imports_without_pyarrow_pandas_or_jax():
    """The card's machine has no pyarrow or pandas: the estimator, Spark
    and Ray modules import without them, and load no jax and nothing of
    the JAX package."""
    code = ("import sys; sys.modules['pyarrow'] = None; "
            "sys.modules['pandas'] = None; "
            "import horovod_tpu_torch.estimator as e, "
            "horovod_tpu_torch.spark.torch, horovod_tpu_torch.ray, "
            "horovod_tpu_torch.runner.cluster; "
            "print(e.to_columns({'a': [1, 2]})['a'].tolist()); "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or "
            "m.split('.')[0] == 'horovod_tpu'))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split() == ["[1,", "2]", "[]"], res.stdout


# ---------------------------------------------------------------------------
# TorchEstimator behaviour
# ---------------------------------------------------------------------------

def _torch_linear(n_feat: int = 4, seed: int = 0):
    rng = np.random.RandomState(seed)
    return EW.linear_cls()({"w": (rng.randn(n_feat) * 0.1).astype(
        np.float32), "b": np.zeros((), np.float32)})


def _estimator(model, **kw):
    base = dict(feature_cols=["features"], label_cols=["label"],
                loss="mse", seed=0, device="cpu")
    base.update(kw)
    return est.TorchEstimator(model=model, **base)


def test_torch_estimator_learns_regression():
    df = _regression_frame()
    m = _torch_linear()
    fitted = _estimator(m, batch_size=64, epochs=30,
                        optimizer=torch.optim.Adam(m.parameters(),
                                                   lr=0.1)).fit(df)
    assert fitted.history[-1]["loss"] < fitted.history[0]["loss"]
    preds = fitted.predict(df)
    target = store.to_columns(df)["label"]
    assert float(np.mean((preds - target) ** 2)) < 0.5
    out = fitted.transform(df)
    assert "prediction" in out.columns and len(out) == len(df)


def test_torch_estimator_default_optimizer_is_adam_1e3():
    m = _torch_linear()
    e = _estimator(m, batch_size=64)
    e.fit(_regression_frame(64))
    assert isinstance(e._opt, torch.optim.Adam)
    assert e._opt.param_groups[0]["lr"] == 1e-3


def test_torch_estimator_mlp_classification_with_validation():
    rng = np.random.RandomState(1)
    x = rng.randn(240, 5).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64) + (x[:, 1] > 0)
    torch.manual_seed(1)
    mlp = torch.nn.Sequential(torch.nn.Linear(5, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 3))
    fitted = _estimator(mlp, loss="xent", batch_size=48, epochs=25,
                        validation=0.2, seed=1,
                        optimizer=torch.optim.Adam(mlp.parameters(),
                                                   lr=0.01)).fit(
        {"features": x, "label": y})
    assert "val_loss" in fitted.history[-1]
    assert fitted.history[-1]["val_loss"] < fitted.history[0]["val_loss"]
    acc = float(np.mean(fitted.predict({"features": x}).argmax(-1) == y))
    assert acc > 0.7, acc


def test_torch_estimator_checkpoints_to_store(tmp_path):
    st = est.LocalStore(str(tmp_path))
    fitted = _estimator(_torch_linear(), batch_size=32, epochs=2,
                        store=st, run_id="run1").fit(_regression_frame(64))
    from horovod_tpu_torch.utils.checkpoint import Checkpointer
    ckpt = Checkpointer(st.checkpoint_path("run1"), read_only=True)
    assert ckpt.all_steps() == [0, 1]
    restored = ckpt.restore()
    for name, p in fitted.module.state_dict().items():
        assert torch.equal(restored["params"][name], p)


def test_torch_estimator_rejects_tiny_data():
    with pytest.raises(ValueError, match="rows"):
        _estimator(_torch_linear(), batch_size=64).fit(_regression_frame(4))


def test_torch_estimator_streaming_fit_learns(tmp_path):
    path = str(tmp_path / "data.parquet")
    _write_multi_rowgroup_parquet(path, n_rows=2048, n_feat=8,
                                  rows_per_group=256)
    m = _torch_linear(8)
    e = _estimator(m, batch_size=64, epochs=8,
                   optimizer=torch.optim.Adam(m.parameters(), lr=0.1))
    fitted = e.fit(est.ParquetBatches(path, batch_rows=256))
    assert fitted.history[-1]["loss"] < fitted.history[0]["loss"]
    assert fitted.history[0]["steps"] == 2048 // 64
    assert fitted.predict(path).shape[0] == 2048
    e.validation = 0.2
    with pytest.raises(ValueError, match="validation"):
        e.fit(est.ParquetBatches(path, batch_rows=256))


def test_torch_estimator_fit_against_remote_store():
    st = est.InMemoryObjectStore("fake://bkt-fit-port/artifacts")
    df = _regression_frame()
    m = _torch_linear()
    fitted = _estimator(m, batch_size=64, epochs=3, store=st,
                        run_id="remote-run",
                        optimizer=torch.optim.Adam(m.parameters(),
                                                   lr=0.1)).fit(df)
    objs = st.obj_list("runs/remote-run/")
    assert [k for k in objs if "checkpoints" in k], objs
    assert "prediction" in fitted.transform(df).columns


def test_torch_estimator_spark_dataframe_ingestion_end_to_end():
    pdf = _regression_frame(128)
    pdf["unrelated"] = [object()] * len(pdf)  # must be pruned, not crash
    sdf = _FakeSparkDataFrame(pdf)
    m = _torch_linear()
    fitted = _estimator(m, batch_size=64, epochs=20,
                        optimizer=torch.optim.Adam(m.parameters(),
                                                   lr=0.1)).fit(sdf)
    assert fitted.history[-1]["loss"] < fitted.history[0]["loss"]
    assert sdf.select_calls == [["features", "label"]]
    out = fitted.transform(_FakeSparkDataFrame(pdf[["features"]]))
    assert "prediction" in out.columns


def test_torch_estimator_needs_a_device_it_can_reach():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    e = est.TorchEstimator(model=_torch_linear(), feature_cols=["features"],
                           label_cols=["label"], batch_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        e.fit(_regression_frame(16))


# ---------------------------------------------------------------------------
# numbers: the JAX package's fit, and the port's at np=2
# ---------------------------------------------------------------------------

def _linear_init(n_feat: int = 4, seed: int = 0) -> dict:
    """``_Linear``'s parameters as ``JaxEstimator`` draws them."""
    x0 = jnp.zeros((1, n_feat), jnp.float32)
    p = jax.jit(lambda r: _Linear().init(r, x0))(jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in p.items()}


def _jax_fit(data, streaming: bool = False):
    kw = dict(EW.FIT)
    if streaming:
        kw.pop("validation")
    return ref_est.JaxEstimator(
        model=_Linear(), feature_cols=["features"], label_cols=["label"],
        loss="mse", optimizer=optax.sgd(EW.LR), **kw).fit(data)


def _assert_close(got, ref) -> None:
    """Normwise rtol: ``max |got - ref| <= RTOL max |ref|``."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= RTOL * scale, f"max abs err {err} > {RTOL} x {scale}"


def _assert_history_close(got: list, ref: list) -> None:
    assert [sorted(e) for e in got] == [sorted(e) for e in ref]
    for g, r in zip(got, ref):
        for k, v in r.items():
            np.testing.assert_allclose(g[k], v, rtol=RTOL, err_msg=k)


def _stream_parquet(path: str) -> None:
    s = EW.STREAM
    _write_multi_rowgroup_parquet(path, n_rows=s["n_rows"],
                                  n_feat=s["n_feat"],
                                  rows_per_group=s["rows_per_group"], seed=2)


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["materialized", "streaming"])
def test_torch_estimator_sgd_matches_jax_estimator(streaming, tmp_path):
    params = _linear_init()
    if streaming:
        path = str(tmp_path / "data.parquet")
        _stream_parquet(path)
        data = lambda m: m.ParquetBatches(
            path, batch_rows=EW.STREAM["batch_rows"])
        predict_on = path
    else:
        data = lambda m: EW.regression_cols()
        predict_on = EW.regression_cols()
    ref = _jax_fit(data(ref_est), streaming)
    got = EW.torch_fit(params, data(est), streaming=streaming,
                       device="cpu")
    _assert_history_close(got.history, ref.history)
    _assert_close(got.predict(predict_on), ref.predict(predict_on))
    _assert_close(got.module.w.detach().numpy(), ref.params["w"])


@pytest.mark.integration
def test_torch_estimator_np2_matches_one_process(tmp_path):
    outdir = str(tmp_path)
    params = _linear_init()
    np.savez(os.path.join(outdir, "init.npz"), **params)
    _stream_parquet(os.path.join(outdir, "data.parquet"))
    DW.check_ranks(EW.launch("torch", outdir, 2))
    ranks = EW.load("torch", outdir, 2)
    assert not any(info["jax_loaded"] for _, info in ranks)
    cols = EW.regression_cols()
    one = EW.torch_fit(params, cols, device="cpu")
    streamed = EW.torch_fit(params, est.ParquetBatches(
        os.path.join(outdir, "data.parquet"),
        batch_rows=EW.STREAM["batch_rows"]), streaming=True, device="cpu")
    for arrays, info in ranks:
        _assert_history_close(info["history"], one.history)
        _assert_close(arrays["preds"], one.predict(cols))
        _assert_history_close(info["stream.history"], streamed.history)
        _assert_close(arrays["stream.preds"], streamed.predict(cols))
        for name, p in one.module.named_parameters():
            _assert_close(arrays[f"param.{name}"], p.detach().numpy())
        for name, p in streamed.module.named_parameters():
            _assert_close(arrays[f"stream.param.{name}"],
                          p.detach().numpy())
        for axis in EW.MESH_AXES:        # mesh=: its data axes split rows
            _assert_history_close(info[f"{axis}.history"], one.history)
            _assert_close(arrays[f"{axis}.preds"], one.predict(cols))
    (a0, _), (a1, _) = ranks
    for k in a0:
        if "param." in k:
            np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
    # rank 0 alone wrote one checkpoint an epoch
    from horovod_tpu_torch.utils.checkpoint import Checkpointer
    ck = Checkpointer(os.path.join(outdir, "store", "runs", "np",
                                   "checkpoints"), read_only=True)
    assert ck.all_steps() == [2, 3, 4]     # max_to_keep=3
    np.testing.assert_array_equal(ck.restore()["params"]["w"].numpy(),
                                  a0["param.w"])


# ---------------------------------------------------------------------------
# KerasEstimator
# ---------------------------------------------------------------------------

def test_keras_estimator_fit_predict(tmp_path):
    keras = pytest.importorskip("keras")
    model = keras.Sequential([keras.layers.Input(shape=(4,)),
                              keras.layers.Dense(1)])
    model.compile(optimizer=keras.optimizers.Adam(0.05), loss="mse")
    df = _regression_frame(128)
    fitted = est.KerasEstimator(
        model=model, feature_cols=["features"], label_cols=["label"],
        batch_size=32, epochs=8, validation=0.25,
        store=est.LocalStore(str(tmp_path)), run_id="k1").fit(df)
    assert fitted.history and "val_loss" in fitted.history
    assert fitted.history["loss"][-1] < fitted.history["loss"][0]
    assert fitted.predict(df).shape[0] == 128
    assert "prediction" in fitted.transform(df).columns
    assert os.path.exists(os.path.join(str(tmp_path), "runs", "k1",
                                       "checkpoints", "model.keras"))


@pytest.mark.integration
def test_keras_estimator_np2_keeps_ranks_equal(tmp_path):
    pytest.importorskip("keras")
    outdir = str(tmp_path)
    DW.check_ranks(EW.launch("keras", outdir, 2))
    ranks = EW.load("keras", outdir, 2)
    assert not any(info["ref_loaded"] for _, info in ranks)
    (a0, i0), (a1, i1) = ranks
    for k in a0:
        if k.startswith("weight."):
            np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
    np.testing.assert_array_equal(a0["preds"], a1["preds"])
    # MetricAverageCallback: both ranks log the averaged metrics
    assert i0["history"] == i1["history"]
    assert "val_loss" in i0["history"]
    assert i0["history"]["loss"][-1] < i0["history"]["loss"][0]
    assert i0["optimizer"].startswith("Distributed")
    assert os.path.exists(os.path.join(outdir, "store", "runs", "k",
                                       "checkpoints", "model.keras"))


# ---------------------------------------------------------------------------
# streaming memory
# ---------------------------------------------------------------------------

RSS_ROWS, RSS_FEAT = 400_000, 256       # 409.6 MB of float32 features


@pytest.mark.integration
def test_streaming_fit_peak_rss_below_materialized(tmp_path):
    """A materialized fit of a 410 MB parquet grows the process by
    several times the dataset (the arrow table, its numpy columns, the
    float32 feature matrix: 1.44 and 1.68 GB in two runs here); a
    streaming fit by about one decoded 16.8 MB row group and the arrow
    pool (60 MB).  Measured as each child's high-water mark after the
    fit less its mark after an identical fit of a small file (the
    imports and allocator warm-up in the baseline), read from ``VmHWM``,
    which belongs to the child's own address space: ``ru_maxrss``
    carries the parent's peak across ``exec``, so under a large test
    worker it hid the fit (a delta of 0).  Torch has no compile peak to
    dwarf, so 410 MB is enough.  The materialized growth must pass the
    dataset's size, the streaming one stay under a quarter of it, and
    the first be over eight times the second."""
    path = str(tmp_path / "big.parquet")
    _write_multi_rowgroup_parquet(path, n_rows=RSS_ROWS, n_feat=RSS_FEAT,
                                  rows_per_group=16384)
    warm = str(tmp_path / "warm.parquet")
    _write_multi_rowgroup_parquet(warm, n_rows=8192, n_feat=RSS_FEAT,
                                  rows_per_group=8192)

    def fit_rss_delta(streaming: bool) -> int:
        code = f"""
import sys
sys.path.insert(0, {REPO!r})
sys.path.insert(0, {os.path.join(REPO, "tests")!r})
import numpy as np, torch
from horovod_tpu_torch.estimator import TorchEstimator, ParquetBatches
import mp_torch_estimator_worker as EW
def fit(data):
    m = EW.linear_cls()({{"w": np.zeros({RSS_FEAT}, np.float32),
                         "b": np.zeros((), np.float32)}})
    TorchEstimator(model=m, feature_cols=["features"], label_cols=["label"],
                   loss="mse", batch_size=512, epochs=1, device="cpu",
                   optimizer=torch.optim.SGD(m.parameters(), lr=1e-3)
                   ).fit(data)
src = (lambda p: ParquetBatches(p, batch_rows=4096)) if {streaming} \\
    else (lambda p: p)
def hwm_kib():
    with open("/proc/self/status") as f:
        return int(next(ln for ln in f if ln.startswith("VmHWM")).split()[1])
fit(src({warm!r}))
base = hwm_kib()
fit(src({path!r}))
print("DELTA", hwm_kib() - base)
"""
        keep = ("PATH", "PYTHONPATH", "HOME", "TMPDIR",
                "LD_LIBRARY_PATH", "LANG")
        env = {k: os.environ[k] for k in keep if k in os.environ}
        env["OMP_NUM_THREADS"] = "1"
        res = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=300,
                             cwd=REPO, env=env)
        assert res.returncode == 0, res.stdout + res.stderr
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("DELTA")][-1]
        return int(line.split()[1])  # KiB on linux

    stream_kib = fit_rss_delta(True)
    full_kib = fit_rss_delta(False)
    data_kib = RSS_ROWS * RSS_FEAT * 4 // 1024
    assert full_kib > data_kib, (
        f"materialized fit grew only {full_kib} KiB for a {data_kib} KiB "
        "dataset: the dataset no longer dominates; rescale the test")
    assert stream_kib < data_kib // 4, (
        f"streaming fit grew {stream_kib} KiB, a quarter of the dataset "
        "or more: something materialized")
    assert full_kib > 8 * stream_kib, (stream_kib, full_kib)

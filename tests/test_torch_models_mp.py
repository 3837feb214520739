"""The model zoo across ranks: the port's jobs
(``tests/mp_torch_models_worker.py``, under the port's launcher over Gloo)
against the JAX package on the same inputs.

- ``dp`` (np=2): ``resnet18_thin`` and BERT tiny trained data-parallel
  with SGD, each rank on its half of the batch (SGD, because Adam turns
  the rounding noise of a gradient that is zero in exact arithmetic,
  such as BERT's key bias, into steps of ``lr``; Adam's parity is
  ``tests/test_torch_models.py``'s).  The reference is
  computed here as ``tests/test_models.py`` trains them: flax ``apply``
  on each half, gradients and losses averaged over the halves, the
  running statistics averaged too.  Losses within 1e-4, parameters and
  statistics within 2e-4 (rtol and atol).
- ``syncbn`` (np=2): ``resnet18_thin`` with its batch norm synchronized
  over a ``dist.new_group`` of both ranks equals the flax model on the
  full batch: logits
  and statistics within 2e-4, gradients averaged over the ranks within
  relative L2 1e-5 of the full batch's.
- ``lookup`` (np=2, np=4): ``sharded_embedding_lookup`` bitwise equal to
  the dense gather and to the JAX package's ``sharded_embedding_lookup``
  over a mesh of as many devices; the tables' gradient, summed over the
  ranks, within 1e-6 of the dense gather's.
- ``guard`` (np=2): the world group (``None`` or ``dist.group.WORLD``)
  handed to ``parallel.comm``'s ``all_to_all_group`` and
  ``mean_across_group``, to DLRM's lookups and to a synchronized
  ``BatchNorm`` raises ``ValueError`` naming ``new_group`` on both ranks
  within the job's 60 s: a raise, not a hang.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import mp_torch_dataplane_worker as DW
import mp_torch_models_worker as MW
from horovod_tpu.models import bert as jbert
from horovod_tpu.models import dlrm as jdlrm
from horovod_tpu.models import resnet as jresnet

pytestmark = pytest.mark.integration

LOSS_TOL = 1e-4
BN_TOL = 2e-4
GRAD_REL_L2 = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run(mode: str, np_: int, outdir: str) -> list:
    return _run_within(mode, np_, outdir)


def _run_within(mode: str, np_: int, outdir: str, timeout=180) -> list:
    DW.check_ranks(MW.launch(mode, outdir, np_, timeout=timeout))
    ranks = MW.load(mode, outdir, np_)
    assert not any(info["jax_loaded"] for _, info in ranks)
    return ranks


def _resnet_variables():
    model = jresnet.resnet18_thin(num_classes=10, dtype=jnp.float32)
    v = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, MW.RESNET_SIZE, MW.RESNET_SIZE, 3)),
        train=False))(jax.random.PRNGKey(5))
    return model, _np(v)


def _bert_variables():
    cfg = jbert.BertConfig.tiny()
    model = jbert.Bert(cfg)
    v = jax.jit(model.init)(jax.random.PRNGKey(6),
                            jnp.zeros((1, 16), jnp.int32))
    return cfg, model, _np(v)


def _halves(a, n=2):
    b = a.shape[0] // n
    return [a[i * b:(i + 1) * b] for i in range(n)]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("models_dp"))
    rmodel, rv = _resnet_variables()
    cfg, bmodel, bv = _bert_variables()
    MW.save_variables(outdir, "resnet", rv)
    MW.save_variables(outdir, "bert", bv)
    box = {}
    job = threading.Thread(
        target=lambda: box.setdefault("res", _run("dp", 2, outdir)))
    job.start()
    ref = {"resnet": _resnet_dp(rmodel, rv), "bert": _bert_dp(cfg, bmodel,
                                                              bv)}
    job.join()
    return box["res"], ref


def _resnet_dp(model, v):
    x, y = MW.resnet_batch()
    tx = optax.sgd(MW.RESNET_LR)
    params, bs = v["params"], v["batch_stats"]
    opt_state = tx.init(params)

    @jax.jit
    def step(params, bs, opt_state):
        grads, losses, stats = [], [], []
        for xb, yb in zip(_halves(x), _halves(y)):
            def loss_fn(p):
                logits, new = model.apply(
                    {"params": p, "batch_stats": bs}, xb, train=True,
                    mutable=["batch_stats"])
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, yb).mean(), new["batch_stats"]
            (loss, new_bs), g = jax.value_and_grad(loss_fn,
                                                   has_aux=True)(params)
            grads.append(g)
            losses.append(loss)
            stats.append(new_bs)
        g = jax.tree.map(lambda a, b: (a + b) / 2, *grads)
        new_bs = jax.tree.map(lambda a, b: (a + b) / 2, *stats)
        updates, opt_state = tx.update(g, opt_state, params)
        return (optax.apply_updates(params, updates), new_bs, opt_state,
                (losses[0] + losses[1]) / 2)

    losses = []
    for _ in range(MW.STEPS):
        params, bs, opt_state, loss = step(params, bs, opt_state)
        losses.append(float(loss))
    return losses, {"params": _np(params), "batch_stats": _np(bs)}


def _bert_dp(cfg, model, v):
    batch = jbert.synthetic_mlm_batch(cfg, MW.BERT_BATCH, MW.BERT_SEQ,
                                      seed=13)
    halves = [{k: h for k, h in zip(batch, hs)}
              for hs in zip(*(_halves(batch[k]) for k in batch))]
    tx = optax.sgd(MW.BERT_LR)
    params, opt_state = v, tx.init(v)

    @jax.jit
    def step(params, opt_state):
        outs = [jax.value_and_grad(
            lambda p: jbert.mlm_loss(p, hb, model))(params) for hb in halves]
        g = jax.tree.map(lambda a, b: (a + b) / 2, outs[0][1], outs[1][1])
        updates, opt_state = tx.update(g, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state,
                (outs[0][0] + outs[1][0]) / 2)

    losses = []
    for _ in range(MW.STEPS):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    return losses, _np(params)


def test_resnet_dp_matches_flax_on_halves(dp):
    ranks, ref = dp
    losses, variables = ref["resnet"]
    from horovod_tpu_torch.models import resnet as tresnet
    want = {k: v.numpy() for k, v in tresnet.params_from_jax(
        variables, "cpu").items()}
    for arrays, info in ranks:
        np.testing.assert_allclose(info["resnet_losses"], losses,
                                   atol=LOSS_TOL, rtol=0)
        for name, value in want.items():
            np.testing.assert_allclose(arrays[f"resnet.{name}"], value,
                                       rtol=BN_TOL, atol=BN_TOL,
                                       err_msg=name)
    assert losses[-1] < losses[0]


def test_bert_dp_matches_flax_on_halves(dp):
    ranks, ref = dp
    losses, params = ref["bert"]
    from horovod_tpu_torch.models import bert as tbert
    want = {k: v.numpy() for k, v in tbert.params_from_jax(
        params, "cpu").items()}
    for arrays, info in ranks:
        np.testing.assert_allclose(info["bert_losses"], losses,
                                   atol=LOSS_TOL, rtol=0)
        for name, value in want.items():
            np.testing.assert_allclose(arrays[f"bert.{name}"], value,
                                       rtol=BN_TOL, atol=BN_TOL,
                                       err_msg=name)
    assert losses[-1] < losses[0]


def test_resnet_sync_batch_norm_equals_the_full_batch(tmp_path):
    outdir = str(tmp_path)
    model, v = _resnet_variables()
    MW.save_variables(outdir, "resnet", v)
    ranks = _run("syncbn", 2, outdir)
    x, y = MW.resnet_batch()

    def loss_fn(p):
        logits, new = model.apply({"params": p, "batch_stats":
                                   v["batch_stats"]}, x, train=True,
                                  mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), (logits, new["batch_stats"])

    (_, (logits, bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    from horovod_tpu_torch.models import resnet as tresnet
    want = tresnet.params_from_jax({"params": _np(grads),
                                    "batch_stats": _np(bs)}, "cpu")
    got_logits = np.concatenate([a["logits"] for a, _ in ranks])
    np.testing.assert_allclose(got_logits, np.asarray(logits), rtol=BN_TOL,
                               atol=BN_TOL)
    for arrays, _ in ranks:
        for name, value in want.items():
            ref = value.numpy()
            if f"buffer.{name}" in arrays:
                np.testing.assert_allclose(arrays[f"buffer.{name}"], ref,
                                           rtol=BN_TOL, atol=BN_TOL)
                continue
            got = arrays[f"grad.{name}"]
            if not ref.any():
                np.testing.assert_array_equal(got, ref, err_msg=name)
                continue
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= GRAD_REL_L2, (name, rel)


@pytest.mark.parametrize("np_", [2, 4])
def test_sharded_embedding_lookup_is_the_dense_gather(np_, tmp_path):
    ranks = _run("lookup", np_, str(tmp_path))
    tables, idx, cot = MW.lookup_inputs()
    T = tables.shape[0]
    dense = tables[np.arange(T)[None, :], idx]
    got = np.concatenate([a["out"] for a, _ in ranks])
    np.testing.assert_array_equal(got, dense)
    mesh = Mesh(np.array(jax.devices()[:np_]), ("hvd",))
    ref = jdlrm.sharded_embedding_lookup(
        jax.device_put(tables, NamedSharding(mesh, P("hvd"))),
        jax.device_put(idx, NamedSharding(mesh, P("hvd"))), mesh)
    np.testing.assert_array_equal(got, np.asarray(ref))
    grad = np.zeros_like(tables)
    np.add.at(grad, (np.arange(T)[None, :], idx), cot)
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["grad"], grad, rtol=0, atol=1e-6)
    if np_ == 2:
        refusals = ranks[0][1]["refusals"]
        assert "equal" in refusals["batch"], refusals
        assert "do not split" in refusals["tables"], refusals


def test_world_group_beside_the_engine_raises_not_hangs(tmp_path):
    ranks = _run_within("guard", 2, str(tmp_path), timeout=60)
    for arrays, info in ranks:
        assert set(info["raised"]) == {
            "all_to_all_group.None", "all_to_all_group.WORLD",
            "mean_across_group.WORLD", "mean_across_group.None",
            "sharded_embedding_lookup", "sharded_embedding_lookup_local",
            "BatchNorm"}, info
        for name, err in info["raised"].items():
            assert err is not None and err.startswith("ValueError"), \
                (name, err)
            assert "torch.distributed.new_group" in err, (name, err)
        np.testing.assert_array_equal(arrays["after"], [1.0, 1.0])

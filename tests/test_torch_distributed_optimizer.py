"""Port parity: ``DistributedOptimizer``, the broadcasts and ``SyncBatchNorm``.

Two processes, one rank each, on the CPU over Gloo
(``tests/mp_torch_port_worker.py``, mode ``optimizer``):

- two data-parallel Adam steps of a 2-layer tiny Llama (the config of
  ``tests/test_torch_train.py``: d_model 256, 4 heads, 2 kv heads, d_ff
  256, vocab 128, fp32, S = 256), one sequence a rank, through
  ``broadcast_parameters``, ``DistributedOptimizer`` and
  ``make_train_step``; against the JAX package's ``make_train_step`` on a
  ``dp=2`` mesh of two CPU devices with ``optax.adam`` over the
  two-sequence batch.  The mean of the two ranks' losses within rtol
  1e-5 of the JAX loss; parameters as ``test_three_adam_steps_match_optax``
  holds them (each within 2·lr per step, all but 1e-4 of them within
  1e-4), and equal on both ranks;
- ``backward_passes_per_step=2`` (two local passes, one average), against
  the same SGD step on the gradients summed in numpy; a step after one
  pass of two, and a step with no gradient reduced, both raise;
- ``broadcast_parameters`` and ``broadcast_optimizer_state`` from rank 1;
- ``Compression.fp16`` (a bfloat16 wire) and ``fp16_ieee``, against the
  JAX package's allreduce of the same cast values;
- ``op=hvd.Adasum``, ``Compression.int8`` and ``Compression.fp8`` through
  the optimizer's hooks, against the JAX package's Adasum and quantized
  build functions on the same gradients (int8 bitwise, fp8 within the
  bound of ``tests/test_reduction.py``, Adasum rtol 1e-5);
- ``SyncBatchNorm`` on half a batch a rank against ``BatchNorm2d`` on the
  joined batch (output, input gradient, summed weight and bias gradients,
  running statistics; atol 1e-5 / 1e-4 as ``tests/test_bindings.py``).

And at one rank in this process: ``SyncBatchNorm``'s stock-BatchNorm
semantics (eval, ``momentum=None``, no running statistics, a bad input
dim), and ``DistributedOptimizer`` taking Adasum and the quantized wires
(at one rank they leave the gradient as it is) and refusing parameters
``named_parameters`` leaves unnamed.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd
import mp_torch_port_worker as W
from horovod_tpu.models import llama as jllama
from horovod_tpu.parallel import MeshConfig, build_mesh

LR = W.LLAMA_LR


def _flat(tree) -> dict:
    out = {k: np.asarray(v) for k, v in tree.items() if k != "layers"}
    out.update({f"layers.{k}": np.asarray(v)
                for k, v in tree["layers"].items()})
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("optimizer")
    jcfg = jllama.LlamaConfig.tiny(**W.LLAMA_DIMS)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    np.savez(out / "llama_params.npz", **_flat(jax.device_get(params)))
    tokens = np.random.RandomState(0).randint(
        0, W.LLAMA_DIMS["vocab_size"], size=(W.NP, 257)).astype(np.int32)
    np.save(out / "llama_tokens.npy", tokens)
    res = W.launch("optimizer", str(out), timeout=150)
    for rc, text in res:
        assert rc == 0, text
    ranks = []
    for r in range(W.NP):
        with np.load(out / f"optimizer.rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        ranks.append((arrays, json.loads(
            (out / f"optimizer.rank{r}.json").read_text())))

    mesh = build_mesh(MeshConfig(dp=2), devices=jax.devices()[:2])
    tx = optax.adam(LR)
    step = jllama.make_train_step(jcfg, mesh, tx)
    state = tx.init(params)
    losses = []
    for _ in range(W.LLAMA_STEPS):
        params, state, loss = step(params, state,
                                   {"tokens": jnp.asarray(tokens)})
        losses.append(float(loss))
    return ranks, losses, _flat(jax.device_get(params))


@pytest.fixture(scope="module")
def ps():
    two = hvd.add_process_set([0, 1])
    yield two
    hvd.remove_process_set(two)


def test_dp_losses_match_jax(run):
    ranks, jlosses, _ = run
    mean = np.mean([a["llama.losses"] for a, _ in ranks], axis=0)
    np.testing.assert_allclose(mean, jlosses, rtol=1e-5)
    assert ranks[0][0]["llama.losses"][1] < ranks[0][0]["llama.losses"][0]


def _port_leaf(arrays, key, cfg_layers):
    if key.startswith("layers."):
        return np.stack([arrays[f"llama.{key}.{i}"]
                         for i in range(cfg_layers)])
    return arrays[f"llama.{key}"]


def test_dp_params_match_jax(run):
    ranks, _, jparams = run
    n_far = n_all = 0
    for key, want in jparams.items():
        got = [_port_leaf(a, key, W.LLAMA_DIMS["n_layers"]) for a, _ in ranks]
        np.testing.assert_array_equal(got[0], got[1], err_msg=key)
        diff = np.abs(got[0] - want)
        assert diff.max() <= W.LLAMA_STEPS * 2 * LR, (key, diff.max())
        n_far += int((diff > 1e-4).sum())
        n_all += want.size
    assert n_far <= 1e-4 * n_all, (n_far, n_all)


def test_backward_passes_per_step(run):
    ranks, _, _ = run
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    for k in range(2):
        for r in range(W.NP):
            x = torch.from_numpy(W.engine_input("bpps", r, k, 8)).reshape(2, 4)
            model(x).square().sum().backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= 0.5 * p.grad / (2 * W.NP)
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["bpps.weight"],
                                   model.weight.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(arrays["bpps.bias"],
                                   model.bias.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_bucket_cap_bytes_gives_the_same_average(run):
    """The reference's host-bucket cap is accepted; the averaged
    gradients are those of the same optimizer without it, and the
    average over both ranks' inputs."""
    ranks, _, _ = run
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3)
    for r in range(W.NP):
        x = torch.from_numpy(W.engine_input("bucket", r, 0, 8)).reshape(2, 4)
        lin(x).square().sum().backward()
    want = (lin.weight.grad / W.NP).numpy()
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays["bucket_cap.64.grad"],
                                      arrays["bucket_cap.None.grad"])
        np.testing.assert_allclose(arrays["bucket_cap.64.grad"], want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("key,match", [
    ("too_early", "requires exactly 2"),
    ("missing", "before every gradient was reduced")])
def test_step_raises(run, key, match):
    for _, info in run[0]:
        assert match in info[key], info[key]


def test_broadcasts_from_root_1(run):
    ranks, _, _ = run
    for key in ("bcast.weight", "bcast.exp_avg", "bcast.step"):
        np.testing.assert_array_equal(ranks[0][0][key], ranks[1][0][key])
    torch.manual_seed(101)            # rank 1's seed in the worker
    net = torch.nn.Linear(3, 2)
    adam = torch.optim.Adam(net.parameters(), lr=0.1)
    net(torch.randn(4, 3)).sum().backward()
    adam.step()
    np.testing.assert_array_equal(ranks[0][0]["bcast.weight"],
                                  net.weight.detach().numpy())
    np.testing.assert_array_equal(ranks[0][0]["bcast.exp_avg"],
                                  adam.state[net.weight]["exp_avg"].numpy())


@pytest.mark.parametrize("key,wire", [("fp16", jnp.bfloat16),
                                      ("fp16_ieee", np.float16)])
def test_compression_matches_jax(run, ps, key, wire):
    from horovod_tpu.ops.compression import Compression
    comp = {"fp16": Compression.fp16, "fp16_ieee": Compression.fp16_ieee}[key]
    assert comp.wire_dtype == wire
    parts = [comp.compress(jnp.asarray(W.engine_input("fp16", r, 0, 16)))[0]
             for r in range(W.NP)]
    out = hvd.allreduce(hvd.per_rank([np.asarray(p) for p in parts],
                                     process_set=ps), hvd.Average,
                        process_set=ps)
    want = np.asarray(hvd.to_numpy(out)).astype(np.float32)
    for arrays, _ in run[0]:
        np.testing.assert_array_equal(arrays[key], want)


@pytest.mark.parametrize("key", sorted(W.OPT_WIRES))
def test_optimizer_adasum_and_quantized_wires_match_jax(run, key):
    from jax.sharding import Mesh

    from horovod_tpu.ops import adasum as JA
    from horovod_tpu.ops import collectives as JC
    from horovod_tpu.ops import reduction as JR
    numel = int(np.prod(W.OPT_WIRE_SHAPE))
    rows = np.stack([W.engine_input(f"opt.{key}", r, 0, numel)
                     for r in range(W.NP)])
    mesh = Mesh(np.array(jax.devices()[:W.NP]), ("hvd",))
    if key == "adasum":
        fn = JA._build_adasum(mesh, "hvd", (numel,), jnp.float32)
    else:
        fn = JR.build_allreduce(mesh, "hvd", JC.ReduceOp.AVERAGE, key,
                                (numel,), jnp.float32, 1.0, 1.0, 512)
    want = np.asarray(fn(jnp.asarray(rows))).reshape(W.OPT_WIRE_SHAPE)
    gmax = float(np.abs(rows).max())
    for arrays, _ in run[0]:
        got = arrays[f"opt.{key}"]
        if key == "int8":
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
        elif key == "fp8":
            np.testing.assert_allclose(got, want,
                                       atol=1.5 * (W.NP + 1) * gmax / 16)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sync_batch_norm_matches_joined_batch(run):
    ranks, _, _ = run
    x = torch.from_numpy(np.random.RandomState(7).randn(
        2 * W.NP, 3, 5, 5).astype(np.float32)).requires_grad_(True)
    bn = torch.nn.BatchNorm2d(3)
    y = bn(x)
    y.square().sum().backward()
    y = y.detach().numpy()
    for r, (arrays, _) in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(arrays["sbn.y"], y[rows], atol=1e-5)
        np.testing.assert_allclose(arrays["sbn.dx"],
                                   x.grad[rows].numpy(), atol=1e-4)
        np.testing.assert_allclose(arrays["sbn.rm"],
                                   bn.running_mean.numpy(), atol=1e-5)
        np.testing.assert_allclose(arrays["sbn.rv"],
                                   bn.running_var.numpy(), atol=1e-5)
    # weight and bias gradients stay local; their sum is the joined one
    for k, want in (("dw", bn.weight.grad), ("db", bn.bias.grad)):
        total = sum(a[f"sbn.{k}"] for a, _ in ranks)
        np.testing.assert_allclose(total, want.numpy(), atol=1e-4)


def test_workers_load_no_jax(run):
    assert [info["jax_loaded"] for _, info in run[0]] == [False] * W.NP


# ---------------------------------------------------------------------------
# SyncBatchNorm's one-rank semantics, in this process (the cases of
# tests/test_bindings.py): stock BatchNorm's, bit for bit in the limits
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(monkeypatch):
    import os

    import horovod_tpu_torch as tdv
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    tdv.init(config=tdv.Config(platform="cpu"))
    yield tdv
    tdv.shutdown()


def test_sync_batch_norm_eval_and_bad_dim(one_rank):
    sbn = one_rank.SyncBatchNorm(4)
    with pytest.raises(ValueError):
        sbn(torch.randn(4))
    sbn.eval()
    x = torch.randn(2, 4)
    assert torch.allclose(sbn(x), x, atol=1e-5)


def test_sync_batch_norm_momentum_none(one_rank):
    torch.manual_seed(1)
    sbn = one_rank.SyncBatchNorm(3, momentum=None)
    bn = torch.nn.BatchNorm2d(3, momentum=None)
    for _ in range(3):
        x = torch.randn(4, 3, 5, 5)
        sbn(x), bn(x)
    assert torch.allclose(sbn.running_mean, bn.running_mean, atol=1e-5)
    assert sbn.num_batches_tracked == bn.num_batches_tracked == 3


def test_sync_batch_norm_no_running_stats(one_rank):
    sbn = one_rank.SyncBatchNorm(3, track_running_stats=False)
    bn = torch.nn.BatchNorm2d(3, track_running_stats=False)
    x = torch.randn(4, 3, 5, 5)
    assert torch.allclose(sbn(x), bn(x), atol=1e-5)
    sbn.eval(), bn.eval()
    assert torch.allclose(sbn(x), bn(x), atol=1e-5)


def test_optimizer_rejects_what_is_not_ported(one_rank):
    """Adasum and the quantized wires are ported now: at one rank they
    leave the gradient as it is.  Unnamed parameters are still refused."""
    for kw in ({"op": one_rank.Adasum},
               {"compression": one_rank.Compression.int8},
               {"compression": one_rank.Compression.fp8}):
        lin = torch.nn.Linear(2, 2)
        params = list(lin.parameters())
        opt = one_rank.DistributedOptimizer(
            torch.optim.SGD(params, lr=0.1),
            named_parameters=lin.named_parameters(), **kw)
        opt.zero_grad()
        lin(torch.arange(4.0).reshape(2, 2)).square().sum().backward()
        want = [p.grad.clone() for p in params]
        opt.synchronize()
        assert all(torch.equal(p.grad, w) for p, w in zip(params, want))
    with pytest.raises(ValueError, match="not the optimizer's parameters"):
        one_rank.DistributedOptimizer(
            torch.optim.SGD(params, lr=0.1),
            named_parameters=[("w", params[0])])


def test_dropped_model_and_optimizer_are_freed(one_rank):
    """Parameters, gradients and the optimizer's state go with the last
    reference to the model and its DistributedOptimizer: the gradient
    hooks must not keep the optimizer alive (a cycle through autograd's
    hooks, which the garbage collector does not see, once held a dropped
    7B model's 54 GB on the card)."""
    import gc
    import weakref
    model = torch.nn.Linear(4, 3)
    opt = one_rank.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    refs = [weakref.ref(model.weight), weakref.ref(opt),
            weakref.ref(opt.state[model.weight]["exp_avg"])]
    del model, opt
    gc.collect()
    assert [r() for r in refs] == [None, None, None]


@pytest.mark.parametrize("cap", [0, -1, 1.5, "64", True])
def test_bucket_cap_bytes_is_checked(one_rank, cap):
    params = list(torch.nn.Linear(2, 2).parameters())
    with pytest.raises(ValueError, match="bucket_cap_bytes"):
        one_rank.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                      bucket_cap_bytes=cap)
    opt = one_rank.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                        bucket_cap_bytes=1 << 20)
    assert opt.bucket_cap_bytes == 1 << 20

"""The port's model zoo (``horovod_tpu_torch.models``: ``mnist``,
``resnet``, ``bert``, ``dlrm``) against the JAX package's flax models.

Every case draws its inputs with numpy from a fixed seed, initializes the
flax model, carries its variables across with the port's
``params_from_jax`` and runs both packages on the CPU.  Tolerances, all
fp32 unless stated:

- forward: rtol/atol 1e-5, 2e-4 where batch norm is in the path (as
  ``tests/test_models.py`` holds sync BN);
- gradients: relative L2 <= 1e-5 per parameter against ``jax.grad``;
- training: six SGD or Adam steps, every loss within 1e-4;
- bf16 forward (``resnet18_thin``, BERT tiny): every logit within
  2**-5 of the largest (bf16 rounding compounded over the layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import bert as jbert
from horovod_tpu.models import dlrm as jdlrm
from horovod_tpu.models import mnist as jmnist
from horovod_tpu.models import resnet as jresnet
from horovod_tpu_torch.models import bert as tbert
from horovod_tpu_torch.models import dlrm as tdlrm
from horovod_tpu_torch.models import mnist as tmnist
from horovod_tpu_torch.models import resnet as tresnet

FWD_TOL = 1e-5
BN_TOL = 2e-4
GRAD_REL_L2 = 1e-5
LOSS_TOL = 1e-4
BF16_TOL = 2.0 ** -5
STEPS = 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel_l2(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                                 1e-30))


def _check_grads(module, ref_sd: dict) -> None:
    """Each parameter's ``.grad`` against the JAX gradient carried to the
    same name by ``params_from_jax``."""
    names = [n for n, _ in module.named_parameters()]
    assert names and set(names) <= set(ref_sd), set(names) - set(ref_sd)
    for name, p in module.named_parameters():
        ref = ref_sd[name].numpy()
        got = p.grad.numpy()
        if not ref.any():
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            assert _rel_l2(got, ref) <= GRAD_REL_L2, (name,
                                                      _rel_l2(got, ref))


def _close_bf16(got: np.ndarray, ref: np.ndarray) -> None:
    err = np.abs(got.astype(np.float32) - ref.astype(np.float32)).max()
    assert err <= BF16_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------------------
# MNIST ConvNet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def convnet():
    model = jmnist.ConvNet()
    v = _np(jax.jit(model.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 28, 28, 1))))
    rng = np.random.RandomState(0)
    x = rng.rand(8, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, size=(8,))
    port = tmnist.ConvNet(device="cpu")
    port.load_state_dict(tmnist.params_from_jax(v, "cpu"))
    return model, v, port, x, y


def test_convnet_forward_matches_flax(convnet):
    model, v, port, x, _ = convnet
    ref = np.asarray(model.apply(v, x))
    got = port(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=FWD_TOL, atol=FWD_TOL)


def test_convnet_gradients_match_jax(convnet):
    model, v, port, x, y = convnet

    def loss_fn(p):
        logits = model.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    grads = _np(jax.jit(jax.grad(loss_fn))(v["params"]))
    port.zero_grad()
    F.cross_entropy(port(_t(x)), _t(y)).backward()
    _check_grads(port, tmnist.params_from_jax({"params": grads}, "cpu"))


def test_convnet_dropout_draws_from_its_generator(convnet):
    _, _, port, x, _ = convnet

    def run(seed):
        return port(_t(x), deterministic=False,
                    generator=torch.Generator().manual_seed(seed))

    with torch.no_grad():
        a, b, c = run(1), run(1), run(2)
        plain = port(_t(x))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, plain)


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------

def _resnet_setup(dtype, seed=0, batch=8, size=32):
    jdt, tdt = dtype
    model = jresnet.resnet18_thin(num_classes=10, dtype=jdt)
    v = _np(jax.jit(lambda k: model.init(
        k, jnp.zeros((1, size, size, 3)), train=False))(
            jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, size, size, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(batch,))
    port = tresnet.resnet18_thin(num_classes=10, dtype=tdt, device="cpu")
    port.load_state_dict(tresnet.params_from_jax(v, "cpu"))
    return model, v, port, x, y


def _check_batch_stats(port, v, batch_stats) -> None:
    """The port's running statistics against flax's, carried to the same
    names by ``params_from_jax``."""
    want = tresnet.params_from_jax(
        {"params": v["params"], "batch_stats": _np(batch_stats)}, "cpu")
    buffers = dict(port.named_buffers())
    assert buffers and set(buffers) <= set(want)
    for name, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                   rtol=BN_TOL, atol=BN_TOL, err_msg=name)


FP32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_forward_matches_flax(train):
    model, v, port, x, _ = _resnet_setup(FP32)
    port.train(train)
    got = port(_t(x)).detach().numpy()
    if train:
        ref, new = jax.jit(lambda v: model.apply(
            v, x, train=True, mutable=["batch_stats"]))(v)
        # the running statistics flax's mutable output carries
        _check_batch_stats(port, v, new["batch_stats"])
    else:
        ref = jax.jit(lambda v: model.apply(v, x, train=False))(v)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=BN_TOL,
                               atol=BN_TOL)


def test_resnet_same_padding_is_xla_s():
    # the stem on 224, a 3x3/2 on an even size, a 1x1/2, stride 1
    assert tresnet.same_pads(224, 7, 2) == (2, 3)
    assert tresnet.same_pads(56, 3, 2) == (0, 1)
    assert tresnet.same_pads(112, 3, 2) == (0, 1)
    assert tresnet.same_pads(56, 1, 2) == (0, 0)
    assert tresnet.same_pads(57, 3, 2) == (1, 1)
    assert tresnet.same_pads(28, 3, 1) == (1, 1)


@pytest.mark.parametrize("size", [32, 33], ids=["even", "odd"])
def test_resnet_gradients_match_jax(size):
    model, v, port, x, y = _resnet_setup(FP32, batch=4, size=size)

    def loss_fn(p):
        logits, _ = model.apply({"params": p, "batch_stats":
                                 v["batch_stats"]}, x, train=True,
                                mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    grads = _np(jax.jit(jax.grad(loss_fn))(v["params"]))
    port.train()
    port.zero_grad()
    F.cross_entropy(port(_t(x)), _t(y)).backward()
    _check_grads(port, tresnet.params_from_jax(
        {"params": grads, "batch_stats": v["batch_stats"]}, "cpu"))


def test_resnet_sgd_steps_match_jax():
    model, v, port, x, y = _resnet_setup(FP32, seed=1)
    tx = optax.sgd(0.05)
    params, bs = v["params"], v["batch_stats"]
    opt_state = tx.init(params)

    @jax.jit
    def step(params, bs, opt_state):
        def loss_fn(p):
            logits, new = model.apply({"params": p, "batch_stats": bs}, x,
                                      train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), new["batch_stats"]
        (loss, bs2), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), bs2, opt_state, loss

    ref = []
    for _ in range(STEPS):
        params, bs, opt_state, loss = step(params, bs, opt_state)
        ref.append(float(loss))
    port.train()
    opt = torch.optim.SGD(port.parameters(), lr=0.05)
    got = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = F.cross_entropy(port(_t(x)), _t(y))
        loss.backward()
        opt.step()
        got.append(loss.item())
    np.testing.assert_allclose(got, ref, atol=LOSS_TOL, rtol=0)
    assert ref[-1] < ref[0]
    _check_batch_stats(port, v, bs)


def test_resnet_bf16_forward_within_bf16_bound():
    model, v, port, x, _ = _resnet_setup(BF16)
    ref, _ = jax.jit(lambda v: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(v)
    port.train()
    got = port(_t(x)).detach()
    assert got.dtype == torch.float32          # the head is fp32
    _close_bf16(got.numpy(), np.asarray(ref))


def test_resnet50_card_check_reaches_every_convolution(monkeypatch):
    """``chip_smoke.py`` holds ResNet-50's first logits on the card
    against the CPU's with every block's last norm at ``check_scale``.
    At the initial scale 0 no 3x3 convolution reaches the logits:
    symmetric pads in all of them (a wrong port of XLA's stride-2 "SAME")
    leave the logits bitwise as they were.  At ``check_scale`` the same
    fault moves them by more than four times the check's bar (fp32, 64
    px, 4 images, batch statistics)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    c = smoke.RESNET
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 64, 64, 3)
                         .astype(np.float32))
    model = tresnet.resnet50(dtype=torch.float32, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    model.train()
    right = tresnet._pad_same

    def symmetric_3x3(t, k, s, value=0.0):
        if k != 3 or value != 0.0:          # the stem and the pool stay
            return right(t, k, s, value)
        return F.pad(t, (1, 1, 1, 1))

    def rel(scale):
        with torch.no_grad():
            for block in model.blocks:
                block.bn2.scale.fill_(scale)
            ref = model(x)
            monkeypatch.setattr(tresnet, "_pad_same", symmetric_3x3)
            bad = model(x)
            monkeypatch.setattr(tresnet, "_pad_same", right)
        return ((bad - ref).abs().max() / ref.abs().max()).item()

    assert rel(0.0) == 0.0
    moved = rel(c["check_scale"])
    print(f"symmetric 3x3 pads move the logits by {moved}")
    assert moved > 4 * c["check_tol"]


def _n_flax(variables) -> int:
    return int(sum(np.prod(a.shape) for a in
                   jax.tree.leaves(variables["params"])))


def test_resnet50_parameter_count_is_the_reference_s():
    ref = jax.eval_shape(lambda: jresnet.resnet50(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    port = tresnet.resnet50(device="meta")
    assert sum(p.numel() for p in port.parameters()) == _n_flax(ref)
    # ResNet-50's forward: 4.1 GMACs an image at 224 (He et al. 2016:
    # "3.8 x 10^9 FLOPs", their multiply-adds, before v1.5's stride move)
    assert 4.0e9 < tresnet.forward_macs(port, 224) < 4.2e9


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

def _bert_setup(jdt=jnp.float32, tdt=torch.float32, batch=4, seq=32):
    jcfg = jbert.BertConfig.tiny(dtype=jdt)
    tcfg = tbert.BertConfig.tiny(dtype=tdt)
    model = jbert.Bert(jcfg)
    v = _np(jax.jit(model.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 16), jnp.int32)))
    jb = jbert.synthetic_mlm_batch(jcfg, batch, seq, seed=3)
    tb = tbert.synthetic_mlm_batch(tcfg, batch, seq, seed=3, device="cpu")
    mask = np.ones((batch, seq), np.int32)
    mask[1, seq * 2 // 3:] = 0
    port = tbert.Bert(tcfg, device="cpu")
    port.load_state_dict(tbert.params_from_jax(v, "cpu"))
    return model, v, port, jb, tb, mask


def test_bert_synthetic_batch_is_the_reference_s():
    _, _, _, jb, tb, _ = _bert_setup()
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_bert_forward_matches_flax():
    model, v, port, jb, tb, mask = _bert_setup()
    ref = np.asarray(jax.jit(model.apply)(v, jb["tokens"], attn_mask=mask))
    got = port(tb["tokens"], attn_mask=_t(mask)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=FWD_TOL, atol=FWD_TOL)


def test_bert_type_embedding_matches_flax():
    cfg = jbert.BertConfig.tiny()
    model = jbert.Bert(cfg)
    tokens = np.random.RandomState(4).randint(0, 256, size=(2, 16))
    types = np.random.RandomState(5).randint(0, 2, size=(2, 16))
    v = _np(model.init(jax.random.PRNGKey(1), tokens, types))
    port = tbert.Bert(tbert.BertConfig.tiny(), token_types=True,
                      device="cpu")
    port.load_state_dict(tbert.params_from_jax(v, "cpu"))
    ref = np.asarray(model.apply(v, tokens, types))
    got = port(_t(tokens), _t(types)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=FWD_TOL, atol=FWD_TOL)


def test_bert_gradients_match_jax():
    model, v, port, jb, tb, mask = _bert_setup()
    jbatch = dict(jb, attn_mask=jnp.asarray(mask))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jbert.mlm_loss(p, jbatch, model)))(v)
    port.zero_grad()
    got = tbert.mlm_loss(port, dict(tb, attn_mask=_t(mask)))
    got.backward()
    assert abs(float(got) - float(loss)) <= FWD_TOL
    _check_grads(port, tbert.params_from_jax(_np(grads), "cpu"))


def test_bert_adam_steps_match_jax():
    model, v, port, jb, tb, _ = _bert_setup()
    tx = optax.adam(1e-3)
    params, opt_state = v, tx.init(v)

    @jax.jit
    def step(params, opt_state):
        loss, g = jax.value_and_grad(
            lambda p: jbert.mlm_loss(p, jb, model))(params)
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    ref = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state)
        ref.append(float(loss))
    opt = torch.optim.Adam(port.parameters(), lr=1e-3)
    got = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = tbert.mlm_loss(port, tb)
        loss.backward()
        opt.step()
        got.append(loss.item())
    np.testing.assert_allclose(got, ref, atol=LOSS_TOL, rtol=0)
    assert ref[-1] < ref[0]


def test_bert_bf16_forward_within_bf16_bound():
    model, v, port, jb, tb, mask = _bert_setup(jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(jax.jit(model.apply)(v, jb["tokens"], attn_mask=mask))
    got = port(tb["tokens"], attn_mask=_t(mask)).detach()
    assert got.dtype == torch.float32
    _close_bf16(got.numpy(), ref)


def test_bert_large_parameter_count_is_the_reference_s():
    cfg = jbert.BertConfig.bert_large()
    ref = jax.eval_shape(lambda: jbert.Bert(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    port = tbert.Bert(tbert.BertConfig.bert_large(), device="meta")
    assert sum(p.numel() for p in port.parameters()) == _n_flax(ref)


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    """The port's runtime at one rank on the CPU (Gloo): the lookup's two
    exchanges are ``all_to_all_single`` calls even there."""
    import os
    import horovod_tpu_torch as hvd
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith(("HVDTPU_", "HOROVOD_"))}
    hvd.init(config=hvd.Config(platform="cpu"))
    yield hvd
    hvd.shutdown()
    os.environ.update(saved)


def _dlrm_setup(seed=0, batch=16):
    cfg = jdlrm.DlrmConfig.tiny()
    model = jdlrm.DlrmDense(cfg)
    v = _np(jax.jit(model.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, cfg.n_dense)),
                                jnp.zeros((1, cfg.n_sparse, cfg.embed_dim))))
    tables = np.asarray(jdlrm.init_embedding_tables(
        cfg, jax.random.PRNGKey(seed + 1)))
    jb = _np(jdlrm.synthetic_batch(cfg, batch, seed=seed))
    tcfg = tdlrm.DlrmConfig.tiny()
    tb = tdlrm.synthetic_batch(tcfg, batch, seed=seed, device="cpu")
    port = tdlrm.DlrmDense(tcfg, device="cpu")
    port.load_state_dict(tdlrm.params_from_jax(v, "cpu"))
    return cfg, model, v, tables, jb, port, tb


def _jax_dlrm_loss(model, cfg):
    def loss_fn(pt, batch):
        p, tb = pt
        emb = tb[jnp.arange(cfg.n_sparse)[None, :], batch["sparse"]]
        logit = model.apply(p, batch["dense"], emb)
        return optax.sigmoid_binary_cross_entropy(
            logit, batch["label"]).mean()
    return loss_fn


def _port_dlrm_loss(port, tables, tb):
    emb = tdlrm.sharded_embedding_lookup_local(tables, tb["sparse"])
    logit = port(tb["dense"], emb)
    return F.binary_cross_entropy_with_logits(logit, tb["label"])


def test_dlrm_synthetic_batch_is_the_reference_s():
    *_, jb, _, tb = _dlrm_setup()
    for k in ("dense", "sparse", "label"):
        np.testing.assert_array_equal(tb[k].numpy(), jb[k])


def test_dlrm_interaction_keeps_triu_order():
    rng = np.random.RandomState(2)
    dense = rng.randn(3, 8).astype(np.float32)
    sparse = rng.randn(3, 8, 8).astype(np.float32)
    ref = np.asarray(jdlrm.interact_features(dense, sparse))
    got = tdlrm.interact_features(_t(dense), _t(sparse)).numpy()
    assert got.shape == (3, 8 + 9 * 8 // 2)
    np.testing.assert_allclose(got, ref, rtol=FWD_TOL, atol=FWD_TOL)


def test_dlrm_forward_and_gradients_match_jax(one_rank):
    cfg, model, v, tables, jb, port, tb = _dlrm_setup()
    loss_fn = _jax_dlrm_loss(model, cfg)
    loss, (gp, gt) = jax.jit(jax.value_and_grad(loss_fn))((v, tables), jb)
    t_tables = _t(tables).requires_grad_()
    emb = tdlrm.sharded_embedding_lookup_local(t_tables, tb["sparse"])
    ref_emb = tables[np.arange(cfg.n_sparse)[None, :], jb["sparse"]]
    np.testing.assert_array_equal(emb.detach().numpy(), ref_emb)
    got = _port_dlrm_loss(port, t_tables, tb)
    got.backward()
    assert abs(float(got) - float(loss)) <= FWD_TOL
    _check_grads(port, tdlrm.params_from_jax(_np(gp), "cpu"))
    gt = np.asarray(gt)
    assert t_tables.grad.shape == gt.shape      # dense, table-shaped
    assert _rel_l2(t_tables.grad.numpy(), gt) <= GRAD_REL_L2


def test_dlrm_adam_steps_match_jax(one_rank):
    cfg, model, v, tables, jb, port, tb = _dlrm_setup(seed=1)
    loss_fn = _jax_dlrm_loss(model, cfg)
    tx = optax.adam(1e-2)
    pt = (v, tables)
    opt_state = tx.init(pt)

    @jax.jit
    def step(pt, opt_state):
        loss, g = jax.value_and_grad(loss_fn)(pt, jb)
        updates, opt_state = tx.update(g, opt_state, pt)
        return optax.apply_updates(pt, updates), opt_state, loss

    ref = []
    for _ in range(STEPS):
        pt, opt_state, loss = step(pt, opt_state)
        ref.append(float(loss))
    t_tables = torch.nn.Parameter(_t(tables))
    opt = torch.optim.Adam([*port.parameters(), t_tables], lr=1e-2)
    got = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = _port_dlrm_loss(port, t_tables, tb)
        loss.backward()
        opt.step()
        got.append(loss.item())
    np.testing.assert_allclose(got, ref, atol=LOSS_TOL, rtol=0)
    assert ref[-1] < ref[0]
    np.testing.assert_allclose(t_tables.detach().numpy(), np.asarray(pt[1]),
                               atol=LOSS_TOL, rtol=0)


"""Port parity: the training path of ``horovod_tpu_torch.models.llama``,
with per-layer recompute, ``remat="dots"`` and none.

Parameters come from the JAX package's ``init_params`` and move across
with ``params_from_jax``; tokens are drawn with numpy.  The JAX side runs
on a one-device mesh on the CPU, with its flash hook
``_FORCE_FLASH_INTERPRET`` on (the Pallas kernels in interpret mode) or
off (dense XLA attention); the port runs on CPU tensors, where attention
takes the flash kernels' plain versions.  The config is the JAX package's
own flash-gradient test config (``tests/test_llama.py``) with GQA: 2
layers, d_model 256, 4 heads, 2 kv heads (head dim 64), d_ff 256, vocab
128, fp32, S = 256.
"""

from __future__ import annotations

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu.models import llama as jllama
from horovod_tpu.parallel import MeshConfig, build_mesh
from horovod_tpu_torch.models import llama as tllama
from mp_torch_mesh_worker import PipelineMesh

DIMS = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=256,
            vocab_size=128)
LR = 1e-2


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    tcfg = tllama.LlamaConfig.tiny(**DIMS)
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    np_params = jax.tree.map(np.asarray,
                             jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.RandomState(0).randint(
        0, DIMS["vocab_size"], size=(2, 257)).astype(np.int32)
    return jcfg, tcfg, mesh, np_params, tokens


def _torch_params(np_params):
    return tllama.params_from_jax(np_params, device="cpu")


def _grads(params) -> dict:
    """The gradient of every leaf, stacked layer leaves restacked into the
    JAX layout, as numpy."""
    out = {k: params[k].grad.numpy() for k in ("embed", "final_norm",
                                                "lm_head")}
    out["layers"] = {k: torch.stack([l.grad for l in v._layer_leaves]).numpy()
                     for k, v in params["layers"].items()}
    return out


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _torch_loss_and_grads(tcfg, np_params, tokens):
    params = _torch_params(np_params)
    tllama.trainable(params)
    loss = tllama.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, tcfg)
    loss.backward()
    return loss.item(), _grads(params)


def test_rmsnorm_vjp_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 16).astype(np.float32)
    w = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    dy = rng.randn(2, 5, 16).astype(np.float32)
    jy, vjp = jax.vjp(lambda x, w: jllama._rmsnorm(x, w), jnp.asarray(x),
                      jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    ty = tllama._rmsnorm(tx, tw)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(dy))
    for t, j in ((ty, jy), (tdx, jdx), (tdw, jdw)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("jax_flash", [True, False])
def test_loss_and_grads_match_jax(setup, jax_flash):
    """Loss within rtol 1e-5; every gradient leaf within rtol 2e-3 / atol
    2e-4, the tolerance of the JAX package's own flash-vs-dense gradient
    test (fp32 sums in another order through two layers)."""
    jcfg, tcfg, mesh, np_params, tokens = setup
    batch = {"tokens": jnp.asarray(tokens)}
    old = jllama._FORCE_FLASH_INTERPRET
    jllama._FORCE_FLASH_INTERPRET = jax_flash
    try:
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jllama.loss_fn(p, batch, jcfg, mesh=mesh)))(
                jax.tree.map(jnp.asarray, np_params))
        jloss, jgrads = float(jloss), jax.device_get(jgrads)
    finally:
        jllama._FORCE_FLASH_INTERPRET = old
    tloss, tgrads = _torch_loss_and_grads(tcfg, np_params, tokens)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    jf, tf = _flat(jgrads), _flat(tgrads)
    assert jf.keys() == tf.keys()
    for key in jf:
        np.testing.assert_allclose(tf[key], jf[key], rtol=2e-3, atol=2e-4,
                                   err_msg=key)


def test_three_adam_steps_match_optax(setup):
    """Three steps of ``make_train_step`` with ``torch.optim.Adam`` against
    the JAX step with ``optax.adam``, same batch.

    Losses within rtol 1e-5.  Parameters: Adam's first steps move each
    weight by about lr * sign(g), so a gradient within rounding of 0 can
    step one way in one framework and the other way in the other: a weight
    may then differ by up to 2 * lr per step.  So every weight is held
    within 3 * 2 * lr, and all but a few in 1e-4 (1e-2 of one step)."""
    jcfg, tcfg, mesh, np_params, tokens = setup
    jparams = jax.tree.map(jnp.asarray, np_params)
    tx = optax.adam(LR)
    jstep = jllama.make_train_step(jcfg, mesh, tx)
    jstate = tx.init(jparams)
    jbatch = {"tokens": jnp.asarray(tokens)}
    jlosses = []
    for _ in range(3):
        jparams, jstate, loss = jstep(jparams, jstate, jbatch)
        jlosses.append(float(loss))

    params = _torch_params(np_params)
    wq0 = params["layers"]["wq"].clone()
    opt = torch.optim.Adam(tllama.trainable(params), lr=LR, eps=1e-8)
    step = tllama.make_train_step(tcfg, opt)
    tbatch = {"tokens": torch.from_numpy(tokens)}
    tlosses = []
    for _ in range(3):
        loss = step(params, tbatch)
        assert loss.dim() == 0 and not loss.requires_grad
        tlosses.append(loss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[2] < tlosses[0]
    # The optimizer stepped the per-layer leaves; the stacks moved with them.
    assert not torch.equal(params["layers"]["wq"], wq0)

    jf = _flat(jax.device_get(jparams))
    tf = _flat(jax.tree.map(lambda t: t.detach().numpy(), params))
    assert jf.keys() == tf.keys()
    n_far = 0
    for key in jf:
        diff = np.abs(tf[key] - jf[key])
        assert diff.max() <= 3 * 2 * LR, (key, diff.max())
        n_far += int((diff > 1e-4).sum())
    n_all = sum(v.size for v in jf.values())
    assert n_far <= 1e-4 * n_all, (n_far, n_all)


def test_remat_matches_no_remat(setup):
    """Per-layer recompute changes what is kept, not what is computed: the
    loss and every gradient equal those without it."""
    _, tcfg, _, np_params, tokens = setup
    off = _torch_loss_and_grads(tcfg, np_params, tokens)
    on = _torch_loss_and_grads(dataclasses.replace(tcfg, remat=True),
                               np_params, tokens)
    assert on[0] == off[0]
    for key, a in _flat(off[1]).items():
        np.testing.assert_array_equal(_flat(on[1])[key], a, err_msg=key)


def test_trainable_leaves_share_the_stacks(setup):
    _, tcfg, _, np_params, _ = setup
    params = _torch_params(np_params)
    leaves = tllama.trainable(params)
    L = tcfg.n_layers
    assert len(leaves) == 9 * L + 3
    assert all(a is b for a, b in zip(tllama.trainable(params), leaves))
    for stack in params["layers"].values():
        assert not stack.requires_grad
        for i, leaf in enumerate(stack._layer_leaves):
            assert leaf.is_leaf and leaf.requires_grad
            assert leaf.data_ptr() == stack[i].data_ptr()
    before = params["layers"]["w_up"][1].clone()
    with torch.no_grad():
        params["layers"]["w_up"]._layer_leaves[1].add_(1.0)
    assert torch.equal(params["layers"]["w_up"][1], before + 1.0)


def test_attention_hook_is_off_and_routes_through_flash(setup, monkeypatch):
    assert tllama._FORCE_ATTENTION_REFERENCE is False
    seen = []
    real = tllama.FA.flash_attention

    def spy(*args, **kw):
        seen.append(kw.get("plain"))
        return real(*args, **kw)

    monkeypatch.setattr(tllama.FA, "flash_attention", spy)
    _, tcfg, _, np_params, tokens = setup
    tllama.forward(_torch_params(np_params),
                   torch.from_numpy(tokens[:, :64]), tcfg)
    assert seen == [False] * tcfg.n_layers
    monkeypatch.setattr(tllama, "_FORCE_ATTENTION_REFERENCE", True)
    seen.clear()
    tllama.forward(_torch_params(np_params),
                   torch.from_numpy(tokens[:, :64]), tcfg)
    assert seen == [True] * tcfg.n_layers


@pytest.mark.parametrize("edit,kw", [
    ({}, {"mesh": PipelineMesh()}),
    ({"use_moe": True}, {"mesh": PipelineMesh()}),
])
def test_unported_training_options_raise(setup, edit, kw):
    """The name is kept from when a pipelined mesh (``pp > 1``) was
    refused: it trains now (``tests/test_torch_llama_pp.py``).  What the
    JAX package refuses on it stays refused with its message, for dense
    and MoE configs alike: the blockwise loss in the 1F1B step and as a
    hidden-state forward; an unknown schedule is a ValueError."""
    _, tcfg, _, np_params, tokens = setup
    cfg = dataclasses.replace(tcfg, blockwise_ce=True, **edit)
    params = _torch_params(np_params)
    match = "blockwise CE requires a pp=1 mesh"
    with pytest.raises(NotImplementedError, match=match):
        tllama.make_train_step(cfg, torch.optim.Adam(
            tllama.trainable(params)), **kw)
    with pytest.raises(NotImplementedError, match=match):
        tllama.forward(params, torch.from_numpy(tokens[:, :9]), cfg,
                       return_hidden=True, **kw)
    with pytest.raises(ValueError, match="pipeline_schedule"):
        tllama.make_train_step(cfg, torch.optim.Adam(
            tllama.trainable(params)), pipeline_schedule="zero-bubble", **kw)


# ---------------------------------------------------------------------------
# remat="dots": keep the weight products, recompute the rest
# ---------------------------------------------------------------------------

def test_dots_matches_jax_dots_and_no_remat(setup):
    """remat="dots" against the JAX package's "dots" step (dense
    attention) within the tolerances of test_loss_and_grads_match_jax,
    and against the port's remat=False bitwise: a saved product is the
    same tensor the forward computed, a recomputed op the same op on the
    same inputs."""
    jcfg, tcfg, mesh, np_params, tokens = setup
    jcfg_d = dataclasses.replace(jcfg, remat="dots")
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg_d,
                                 mesh=mesh)))(
            jax.tree.map(jnp.asarray, np_params))
    dots = _torch_loss_and_grads(dataclasses.replace(tcfg, remat="dots"),
                                 np_params, tokens)
    off = _torch_loss_and_grads(tcfg, np_params, tokens)
    np.testing.assert_allclose(dots[0], float(jloss), rtol=1e-5)
    jf, tf, of = _flat(jax.device_get(jgrads)), _flat(dots[1]), _flat(off[1])
    assert jf.keys() == tf.keys() == of.keys()
    for key in jf:
        np.testing.assert_allclose(tf[key], jf[key], rtol=2e-3, atol=2e-4,
                                   err_msg=key)
        np.testing.assert_array_equal(tf[key], of[key], err_msg=key)
    assert dots[0] == off[0]


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(tcfg, np_params, tokens, remat, early_stop=True):
    from torch.utils.checkpoint import set_checkpoint_early_stop
    cfg = dataclasses.replace(tcfg, remat=remat)
    params = _torch_params(np_params)
    tllama.trainable(params)
    with set_checkpoint_early_stop(early_stop):
        loss = tllama.loss_fn(params, {"tokens": torch.from_numpy(tokens)},
                              cfg)
        mode = _CountOps()
        with mode:
            loss.backward()
    return mode.counts


@pytest.mark.parametrize("remat,early_stop,mm_per_layer", [
    (False, True, 14), ("dots", True, 14), ("dots", False, 14),
    (True, False, 21), (True, True, 20)])
def test_dots_policy_saves_the_weight_products(setup, remat, early_stop,
                                               mm_per_layer):
    """The backward's aten.mm count, besides the two of lm_head: each of
    a layer's seven weight products takes two in the backward (14).
    remat=True recomputes the products too (21 with the recompute run to
    the end; PyTorch's default stops it once the last tensor the backward
    needs is back, which leaves out w_down's product: 20).  "dots" keeps
    their outputs and recomputes none (14 either way), while the
    attention's batched products (bmm) are recomputed as under True."""
    _, tcfg, _, np_params, tokens = setup
    L = tcfg.n_layers
    counts = _backward_ops(tcfg, np_params, tokens[:, :65], remat,
                           early_stop)
    assert counts.get("mm", 0) == mm_per_layer * L + 2, counts
    assert counts.get("addmm", 0) == 0
    base = _backward_ops(tcfg, np_params, tokens[:, :65], False)
    if remat:
        assert counts["bmm"] > base["bmm"], (counts, base)
    else:
        assert counts["bmm"] == base["bmm"]


def test_dots_on_a_torch_without_selective_checkpointing(setup, monkeypatch):
    """make_train_step names the version when selective activation
    checkpointing is missing, and does not fall back to remat=True."""
    import torch.utils.checkpoint as ckpt
    _, tcfg, _, np_params, _ = setup
    monkeypatch.delattr(ckpt, "create_selective_checkpoint_contexts")
    params = _torch_params(np_params)
    with pytest.raises(NotImplementedError,
                       match=re.escape(torch.__version__)):
        tllama.make_train_step(dataclasses.replace(tcfg, remat="dots"),
                               torch.optim.Adam(tllama.trainable(params)))
    with pytest.raises(ValueError, match="remat"):
        tllama.make_train_step(dataclasses.replace(tcfg, remat="all"),
                               torch.optim.Adam(tllama.trainable(params)))


# ---------------------------------------------------------------------------
# the MoE Llama: loss (weighted aux), one Adam step, recompute variants
# ---------------------------------------------------------------------------

MOE = dict(use_moe=True, n_experts=4, moe_aux_weight=0.5)


@pytest.fixture(scope="module")
def moe_setup():
    jcfg = jllama.LlamaConfig.tiny(**MOE)
    tcfg = tllama.LlamaConfig.tiny(**MOE)
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    np_params = jax.tree.map(np.asarray,
                             jllama.init_params(jcfg, jax.random.PRNGKey(1)))
    tokens = np.random.RandomState(1).randint(
        0, 256, size=(2, 49)).astype(np.int32)
    return jcfg, tcfg, mesh, np_params, tokens


@pytest.mark.parametrize("blockwise", [False, True])
def test_moe_loss_and_grads_match_jax(moe_setup, blockwise):
    """The loss with its aux term weighted by ``moe_aux_weight=0.5`` within
    1e-5 relative of the JAX package's (an unweighted or a missing aux
    term moves it by far more), dense and blockwise; every gradient leaf,
    the router's included, within the dense test's tolerance."""
    jcfg, tcfg, mesh, np_params, tokens = moe_setup
    jcfg = dataclasses.replace(jcfg, blockwise_ce=blockwise)
    tcfg = dataclasses.replace(tcfg, blockwise_ce=blockwise)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg,
                                 mesh=mesh)))(
            jax.tree.map(jnp.asarray, np_params))
    _, jaux = jllama.forward(jax.tree.map(jnp.asarray, np_params),
                             jnp.asarray(tokens[:, :-1]), jcfg)
    tloss, tgrads = _torch_loss_and_grads(tcfg, np_params, tokens)
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5)
    assert abs(0.5 * float(jaux)) > 1e3 * 1e-5 * abs(float(jloss))
    jf, tf = _flat(jax.device_get(jgrads)), _flat(tgrads)
    assert jf.keys() == tf.keys()
    assert "['layers']['router']" in jf
    for key in jf:
        np.testing.assert_allclose(tf[key], jf[key], rtol=2e-3, atol=2e-4,
                                   err_msg=key)


def test_moe_adam_step_matches_optax(moe_setup):
    """One ``make_train_step`` step with ``torch.optim.Adam`` against the
    JAX step with ``optax.adam``: the loss within 1e-5 relative and every
    parameter within 1e-5 of its own largest magnitude, apart from
    weights whose gradient is within rounding of 0 (Adam's first step
    moves a weight by about lr * sign(g)): at most 1e-4 of them, each
    within 2 * lr."""
    jcfg, tcfg, mesh, np_params, tokens = moe_setup
    jparams = jax.tree.map(jnp.asarray, np_params)
    tx = optax.adam(LR)
    jparams, _, jloss = jllama.make_train_step(jcfg, mesh, tx)(
        jparams, tx.init(jparams), {"tokens": jnp.asarray(tokens)})
    params = _torch_params(np_params)
    opt = torch.optim.Adam(tllama.trainable(params), lr=LR, eps=1e-8)
    tloss = tllama.make_train_step(tcfg, opt)(
        params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jf = _flat(jax.device_get(jparams))
    tf = _flat(jax.tree.map(lambda t: t.detach().numpy(), params))
    assert jf.keys() == tf.keys()
    n_far = 0
    for key in jf:
        diff = np.abs(tf[key] - jf[key])
        assert diff.max() <= 2 * LR, (key, diff.max())
        n_far += int((diff > 1e-5 * np.abs(jf[key]).max()).sum())
    assert n_far <= 1e-4 * sum(v.size for v in jf.values()), n_far


def test_moe_recompute_variants_give_the_same_loss(moe_setup):
    """remat True, False and "dots" compute the same loss and gradients:
    the layer's (h, aux) pair goes through torch.utils.checkpoint."""
    _, tcfg, _, np_params, tokens = moe_setup
    off = _torch_loss_and_grads(dataclasses.replace(tcfg, remat=False),
                                np_params, tokens)
    for remat in (True, "dots"):
        on = _torch_loss_and_grads(dataclasses.replace(tcfg, remat=remat),
                                   np_params, tokens)
        assert on[0] == off[0], remat
        for key, a in _flat(off[1]).items():
            np.testing.assert_array_equal(_flat(on[1])[key], a,
                                          err_msg=f"{remat} {key}")


def test_moe_trainable_takes_router_and_experts(moe_setup):
    _, tcfg, _, np_params, _ = moe_setup
    params = _torch_params(np_params)
    named = tllama.named_trainable(params)
    assert len(named) == 10 * tcfg.n_layers + 3
    names = dict(named)
    assert names["layers.router.1"].shape == (64, 4)
    assert names["layers.w_gate.0"].shape == (4, 64, 128)

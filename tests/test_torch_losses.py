"""Port parity: ``horovod_tpu_torch.ops.losses.blockwise_cross_entropy``
against the JAX package's, and the port's Llama loss with
``blockwise_ce`` on.

Inputs are drawn with numpy from a seed and go through both functions on
the CPU; the cases mirror ``tests/test_losses.py`` (explicit and default
blocks, fp32 and bf16, a vocabulary above 8192 that is padded).
Tolerances: fp32 1e-5 (sums in another order); bf16 2e-2 on the nll and
3e-2 on the gradients, the JAX package's own bf16 tolerances against its
dense oracle (both sides round the same bf16 products, but the softmax
block is rounded to bf16 before the gradient products, where one ulp is
2^-8 of the value).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jllama
from horovod_tpu.ops import losses as jlosses
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.ops import losses as tlosses

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 3e-2)}


def _inputs(seed, T, D, V, dtype):
    """x, w, targets and an upstream gradient, the floats rounded to
    ``dtype`` once in numpy so both packages see the same values."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T, D).astype(np.float32)
    w = (0.1 * rng.randn(D, V)).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        w = w.astype(ml_dtypes.bfloat16).astype(np.float32)
    t = rng.randint(0, V, size=(T,)).astype(np.int32)
    g = rng.randn(T).astype(np.float32)
    return x, w, t, g


def _jax(x, w, t, g, dtype, block):
    jx, jw = (jnp.asarray(a, _JAX[dtype]) for a in (x, w))
    jt = jnp.asarray(t)
    nll, vjp = jax.vjp(
        lambda a, b: jlosses.blockwise_cross_entropy(a, b, jt, block), jx, jw)
    dx, dw = vjp(jnp.asarray(g))
    return [np.asarray(a, np.float32) for a in (nll, dx, dw)]


def _torch(x, w, t, g, dtype, block):
    tx = torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_()
    tw = torch.from_numpy(w).to(_TORCH[dtype]).requires_grad_()
    nll = tlosses.blockwise_cross_entropy(tx, tw, torch.from_numpy(t), block)
    assert nll.dtype == torch.float32 and nll.shape == (x.shape[0],)
    nll.backward(torch.from_numpy(g))
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == tw.dtype
    return [a.detach().float().numpy() for a in (nll, tx.grad, tw.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [128, 256, None])
def test_blockwise_matches_jax(dtype, block):
    x, w, t, g = _inputs(0, 48, 32, 512, dtype)
    rtol, gtol = _TOL[dtype]
    want = _jax(x, w, t, g, dtype, block)
    got = _torch(x, w, t, g, dtype, block)
    for name, a, b, tol in zip(("nll", "dx", "dw"), got, want,
                               (rtol, gtol, gtol)):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


def test_pick_block_matches_jax():
    for v in (32000, 50257, 1031, 50026, 512, 320, 9000):
        assert tlosses._pick_block(v, None) == jlosses._pick_block(v, None)
    assert tlosses._pick_block(512, 128) == 128
    with pytest.raises(ValueError, match="divide"):
        tlosses._pick_block(512, 300)


def test_blocks_pad_only_the_last():
    w = torch.arange(2 * 10, dtype=torch.float32).reshape(2, 10)
    blocks = tlosses._blocks(w, 4)
    assert [b.shape for b in blocks] == [(2, 4)] * 3
    assert torch.equal(blocks[2][:, :2], w[:, 8:])
    assert torch.equal(blocks[2][:, 2:], torch.zeros(2, 2))
    assert blocks[0].data_ptr() == w.data_ptr()      # a view, no copy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_vocab_matches_jax(dtype):
    """V = 8201 > 8192 is prime, so it has no divisor in [512, 8192]:
    both pad to 4096 blocks (three, the last holding 9 real columns) and
    mask the padding out of the softmax and of dw."""
    assert tlosses._pick_block(8201, None) == 4096
    x, w, t, g = _inputs(1, 16, 8, 8201, dtype)
    t[:4] = [8200, 8192, 4095, 0]                    # edges of the blocks
    rtol, gtol = _TOL[dtype]
    want = _jax(x, w, t, g, dtype, None)
    got = _torch(x, w, t, g, dtype, None)
    assert got[2].shape == (8, 8201)
    for name, a, b, tol in zip(("nll", "dx", "dw"), got, want,
                               (rtol, gtol, gtol)):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


def test_blockwise_matches_dense_torch_nll():
    """Against the plain dense form in the port itself (fp32)."""
    x, w, t, _ = _inputs(2, 24, 16, 300, "float32")
    got = tlosses.blockwise_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t))
    logits = torch.from_numpy(x) @ torch.from_numpy(w)
    want = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(t).long(), reduction="none")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the Llama loss with blockwise_ce on
# ---------------------------------------------------------------------------

DIMS = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=256)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    np_params = jax.tree.map(np.asarray,
                             jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.RandomState(0).randint(
        0, DIMS["vocab_size"], size=(2, 33)).astype(np.int32)
    return jcfg, np_params, tokens


def _torch_loss(np_params, tokens, **edit):
    cfg = tllama.LlamaConfig.tiny(**DIMS, **edit)
    params = tllama.params_from_jax(np_params, device="cpu")
    leaves = tllama.trainable(params)
    loss = tllama.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    loss.backward()
    return loss.item(), [t.grad.float().numpy() for t in leaves]


def test_llama_blockwise_loss_matches_dense_and_jax(model):
    """fp32: the blockwise loss and every gradient equal the port's dense
    ones within 1e-5 (the same products, summed in another order), and
    the loss equals the JAX package's blockwise loss within 1e-5."""
    jcfg, np_params, tokens = model
    dense = _torch_loss(np_params, tokens)
    blockwise = _torch_loss(np_params, tokens, blockwise_ce=True)
    np.testing.assert_allclose(blockwise[0], dense[0], rtol=1e-5)
    for a, b in zip(blockwise[1], dense[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    jcfg_b = dataclasses.replace(jcfg, blockwise_ce=True)
    jloss = float(jllama.loss_fn(jax.tree.map(jnp.asarray, np_params),
                                 {"tokens": jnp.asarray(tokens)}, jcfg_b))
    np.testing.assert_allclose(blockwise[0], jloss, rtol=1e-5)


def test_llama_blockwise_loss_in_bf16(model):
    """bf16 weights: the blockwise logits stay fp32 where the dense path
    rounds them to bf16, so the two losses agree within 1e-2 relative
    (a bf16 ulp is 2^-8 of a logit), not bitwise."""
    _, np_params, tokens = model
    p16 = jax.tree.map(
        lambda a: a.astype(ml_dtypes.bfloat16) if a.ndim > 1 else a,
        np_params)
    dense = _torch_loss(p16, tokens, dtype=torch.bfloat16)
    blockwise = _torch_loss(p16, tokens, dtype=torch.bfloat16,
                            blockwise_ce=True)
    np.testing.assert_allclose(blockwise[0], dense[0], rtol=1e-2)
    assert all(np.isfinite(g).all() for g in blockwise[1])

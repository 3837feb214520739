"""Port parity: the flash kernels' whole domain (fp32 and bf16, any head
dim up to 256, any sequence length, GQA) against the JAX package.

The same inputs, drawn with numpy from a seed, go through the JAX
package's flash attention and through the port's wrappers on CPU tensors,
which run the kernels' plain versions.  Inside the JAX package's
``supported`` the JAX side is its Pallas kernels in interpret mode (as its
own tests run them on the CPU); outside it (an S that no block divides)
its ``dense_attention``, which its Llama runs there.  The CUDA kernels run
only on the card, where ``chip_smoke.py`` holds them against the plain
versions; here the wrappers' padding, slicing and routing are driven
through a stand-in launch that runs the plain versions on what a kernel
would be handed.

Tolerances: fp32 as ``tests/test_torch_flash_attention.py`` (2e-5 for
the forward, 2e-4 for gradients: fp32 sums in another order).  bf16: the
Pallas kernels round p (and ds) to bf16 before each product, the plain
versions keep fp32, and both round the output to bf16: within 2^-5 of the
output's largest value (a few bf16 ulps), as the card's check holds the
kernels.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jllama
from horovod_tpu.ops import flash_attention as JFA
from horovod_tpu.parallel import MeshConfig, build_mesh
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.ops import flash_attention as FA

B, H = 2, 4
BF16_TOL = 2.0 ** -5


def _inputs(seed, S, D, kv):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, S, heads, D).astype(np.float32)
                 for heads in (H, kv, kv, H))


def _jax(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                 else jnp.float32)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _close(got, want, dtype, tol32, name):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=tol32, atol=tol32,
                                   err_msg=name)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_TOL * np.abs(want).max(), (name, err)


# Inside the JAX package's `supported`: S = 128 (its block), D <= 256.
INSIDE = [
    pytest.param(dtype, D, kv, causal,
                 id=f"{str(dtype)[6:]}-D{D}-kv{kv}-{'causal' if causal else 'full'}")
    for dtype in (torch.float32, torch.bfloat16)
    for D in (8, 16, 32, 96, 256)
    for kv, causal in ((2, True), (4, False))
]


@pytest.mark.parametrize("dtype,D,kv,causal", INSIDE)
def test_plain_versions_match_pallas_in_its_domain(dtype, D, kv, causal):
    """Forward (o and lse) and both backward kernels against the Pallas
    kernels in interpret mode, on the same (q, k, v, o, lse, dO)."""
    S = 128
    assert JFA.supported((B, S, H, D), 2 if dtype == torch.bfloat16 else 4)
    assert FA.supported((B, S, H, D), dtype, kv)
    q, k, v, do = _inputs(D + kv, S, D, kv)
    sc = 1.0 / math.sqrt(D)
    jq, jk, jv, jdo = (_jax(x, dtype) for x in (q, k, v, do))
    jo, jlse = JFA._flash_forward(jq, jk, jv, scale=sc, causal=causal,
                                  block_q=128, block_k=128, interpret=True)
    tq, tk, tv, tdo = (_torch(x, dtype) for x in (q, k, v, do))
    to, tlse = FA.flash_forward(tq, tk, tv, sc, causal)
    assert to.dtype == dtype and tuple(tlse.shape) == (B, H, S)
    _close(to, jo.astype(jnp.float32), dtype, 2e-5, "o")
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse).reshape(B, H, S),
                               rtol=1e-5, atol=1e-4 if dtype == torch.bfloat16
                               else 1e-5)

    # The backward on the JAX forward's o and lse, delta outside the
    # kernels on both sides.
    jdq, jdk, jdv = JFA._flash_backward(
        jq, jk, jv, jo, jlse, jdo, scale=sc, causal=causal, block_q=128,
        block_k=128, interpret=True)
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(dtype)
    tlse = torch.from_numpy(np.asarray(jlse).reshape(B, H, S))
    delta = FA.flash_delta(to, tdo)
    dq = FA.flash_backward_dq(tq, tk, tv, tdo, tlse, delta, sc, causal)
    dk, dv = FA.flash_backward_dkv(tq, tk, tv, tdo, tlse, delta, sc, causal)
    for name, t, j in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        _close(t, j.astype(jnp.float32), dtype, 2e-4, name)


@pytest.mark.parametrize("S", [32, 100, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_match_dense_outside_its_domain(S, causal):
    """An S that none of the JAX package's blocks divide: its Llama runs
    ``dense_attention`` there.  The port's flash attention (forward and
    gradients, fp32, GQA, head dim 16) against it."""
    D, kv = 16, 2
    assert not JFA.supported((B, S, H, D), 4)
    assert FA.supported((B, S, H, D), torch.float32, kv)
    q, k, v, do = _inputs(S, S, D, kv)
    sc = 1.0 / math.sqrt(D)
    jo, vjp = jax.vjp(lambda q, k, v: JFA.dense_attention(q, k, v, sc, causal),
                      *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to = FA.flash_attention(tq, tk, tv, sc, causal)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=2e-5, atol=2e-5)
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("D", [16, 96, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_padding_the_head_dim_is_exact(D, causal):
    """The wrappers' pad-and-slice (:func:`FA.call_padded`, to the head dim
    :func:`FA.flash_plan` gives fp32) around the plain versions gives the
    unpadded results bitwise: zero columns add 0 to every score and give
    zero columns of o, dq, dk and dv; lse and delta are unchanged."""
    lib, dp = FA.flash_plan(torch.float32, D)
    assert lib == "flash_simple" and dp > D
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(7, 100, D, 2))
    sc = 1.0 / math.sqrt(D)
    o, lse = FA.flash_forward_reference(q, k, v, sc, causal)
    po, plse = FA.call_padded(FA.flash_forward_reference, dp, (q, k, v), sc,
                              causal)
    delta = FA.flash_delta(o, do)
    assert torch.equal(FA.flash_delta(FA._pad_head_dim(o, dp),
                                      FA._pad_head_dim(do, dp)), delta)
    bwd = (q, k, v, do)
    dq = FA.flash_backward_dq_reference(*bwd, lse, delta, sc, causal)
    pdq = FA.call_padded(FA.flash_backward_dq_reference, dp, bwd, lse, delta,
                         sc, causal)
    dk, dv = FA.flash_backward_dkv_reference(*bwd, lse, delta, sc, causal)
    pdk, pdv = FA.call_padded(FA.flash_backward_dkv_reference, dp, bwd, lse,
                              delta, sc, causal)
    for name, a, b in (("o", o, po), ("lse", lse, plse), ("dq", dq, pdq),
                       ("dk", dk, pdk), ("dv", dv, pdv)):
        assert a.shape == b.shape and torch.equal(a, b), name


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 1, ("flash", 64)),
    (torch.bfloat16, 64, ("flash", 64)),
    (torch.bfloat16, 96, ("flash", 128)),
    (torch.bfloat16, 128, ("flash", 128)),
    (torch.bfloat16, 200, ("flash_simple", 256)),
    (torch.bfloat16, 256, ("flash_simple", 256)),
    (torch.float32, 1, ("flash_simple", 32)),
    (torch.float32, 16, ("flash_simple", 32)),
    (torch.float32, 33, ("flash_simple", 64)),
    (torch.float32, 128, ("flash_simple", 128)),
    (torch.float32, 256, ("flash_simple", 256)),
])
def test_flash_plan_routes_each_dtype_and_head_dim(dtype, D, want):
    assert FA.flash_plan(dtype, D) == want
    assert FA.supported((1, 5, 4, D), dtype, 2)


class _StandIn:
    """A stand-in for ``FA._flash_launch``: runs the plain version on the
    tensors a kernel would be handed (padded head dim, lse and delta in
    rows of the library's stride), writes the kernel's outputs in place and
    records what was launched."""

    def __init__(self):
        self.calls = []

    def __call__(self, lib, kernel, tensors, scale, causal):
        q = tensors[0]
        S = q.shape[1]
        self.calls.append((lib, kernel, q.shape[-1],
                           tuple(t.shape for t in tensors)))
        if kernel == "fwd":
            q, k, v, o, lse = tensors
            ro, rlse = FA.flash_forward_reference(q, k, v, scale, causal)
            o.copy_(ro)
            lse.copy_(rlse)
            return
        q, k, v, do, lse, delta = tensors[:6]
        args = (q, k, v, do, lse[..., :S].contiguous(),
                delta[..., :S].contiguous(), scale, causal)
        if kernel == "dq":
            tensors[6].copy_(FA.flash_backward_dq_reference(*args))
        else:
            dk, dv = FA.flash_backward_dkv_reference(*args)
            tensors[6].copy_(dk)
            tensors[7].copy_(dv)


@pytest.mark.parametrize("dtype,D,S,lib,dp", [
    (torch.float32, 16, 100, "flash_simple", 32),
    (torch.bfloat16, 96, 100, "flash", 128),
    (torch.bfloat16, 200, 64, "flash_simple", 256),
    (torch.bfloat16, 64, 130, "flash", 64),
])
def test_wrappers_hand_the_kernels_padded_tensors(monkeypatch, dtype, D, S,
                                                  lib, dp):
    """The card's path of each wrapper, with the launch replaced by
    :class:`_StandIn`: the library :func:`FA.flash_plan` names gets q, k,
    v (and dO) padded to its head dim, the wgmma library lse and delta in
    rows of S rounded up to 64 (zeros past S), and the wrappers return the
    plain versions' results, bitwise, at the caller's head dim."""
    stand_in = _StandIn()
    monkeypatch.setattr(FA, "_on_card", lambda name, q: True)
    monkeypatch.setattr(FA, "_flash_launch", stand_in)
    q, k, v, do = (_torch(x, dtype) for x in _inputs(3, S, D, 2))
    sc = 1.0 / math.sqrt(D)
    o, lse = FA.flash_forward(q, k, v, sc, True)
    ro, rlse = FA.flash_forward_reference(q, k, v, sc, True)
    assert o.shape == q.shape and o.is_contiguous()
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    delta = FA.flash_delta(o, do)
    dq = FA.flash_backward_dq(q, k, v, do, lse, delta, sc, True)
    dk, dv = FA.flash_backward_dkv(q, k, v, do, lse, delta, sc, True)
    args = (q, k, v, do, lse, delta, sc, True)
    assert torch.equal(dq, FA.flash_backward_dq_reference(*args))
    rdk, rdv = FA.flash_backward_dkv_reference(*args)
    assert torch.equal(dk, rdk) and torch.equal(dv, rdv)
    ld = -(-S // 64) * 64 if lib == "flash" else S
    assert [c[:3] for c in stand_in.calls] == [
        (lib, "fwd", dp), (lib, "dq", dp), (lib, "dkv", dp)]
    for _, kernel, _, shapes in stand_in.calls[1:]:
        assert shapes[4] == shapes[5] == (B, H, ld), (kernel, shapes)


# A Llama whose head dim (320) is past every flash kernel: both packages
# run dense attention there, decided from the shape alone.
WIDE = dict(n_layers=2, d_model=640, n_heads=2, n_kv_heads=2, d_ff=256,
            vocab_size=128)


def test_llama_attention_past_head_dim_256_is_dense(monkeypatch):
    """``_attention`` hands a head dim above 256 to ``dense_attention`` and
    any other to the flash ``autograd.Function``."""
    seen = []
    real_dense, real_flash = FA.dense_attention, FA.flash_attention
    monkeypatch.setattr(FA, "dense_attention", lambda *a, **kw: (
        seen.append("dense"), real_dense(*a, **kw))[1])
    monkeypatch.setattr(FA, "flash_attention", lambda *a, **kw: (
        seen.append("flash"), real_flash(*a, **kw))[1])
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, 128, size=(1, 16)))
    for dims, want in ((WIDE, "dense"), (dict(WIDE, n_heads=4, n_kv_heads=2),
                                          "flash")):
        cfg = tllama.LlamaConfig.tiny(**dims)
        params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        seen.clear()
        tllama.forward(params, tokens, cfg)
        assert seen == [want] * cfg.n_layers, (cfg.head_dim, seen)


def test_llama_head_dim_320_trains_as_the_jax_package():
    """Two Adam steps of the port's ``make_train_step`` at head dim 320
    against the JAX package's step with ``optax.adam``: losses within rtol
    1e-5 (the JAX Llama also runs dense attention past 256)."""
    jcfg = jllama.LlamaConfig.tiny(**WIDE)
    tcfg = tllama.LlamaConfig.tiny(**WIDE)
    assert tcfg.head_dim == 320
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    np_params = jax.tree.map(np.asarray,
                             jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.RandomState(0).randint(
        0, WIDE["vocab_size"], size=(2, 65)).astype(np.int32)
    lr = 1e-3
    import optax
    tx = optax.adam(lr)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = tx.init(jparams)
    jstep = jllama.make_train_step(jcfg, mesh, tx)
    jlosses = []
    for _ in range(2):
        jparams, jstate, loss = jstep(jparams, jstate,
                                      {"tokens": jnp.asarray(tokens)})
        jlosses.append(float(loss))
    params = tllama.params_from_jax(np_params, device="cpu")
    opt = torch.optim.Adam(tllama.trainable(params), lr=lr, eps=1e-8)
    step = tllama.make_train_step(tcfg, opt)
    tlosses = [step(params, {"tokens": torch.from_numpy(tokens)}).item()
               for _ in range(2)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[1] < tlosses[0]

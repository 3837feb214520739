"""Port parity: the serving entry points of ``horovod_tpu_torch.models.llama``.

Parameters and inputs are drawn with numpy from a seed and go through the
JAX package (``LlamaConfig.tiny()``, fp32, on the CPU) and the port
(``device="cpu"``).  Tolerances are fp32: the two frameworks sum matrix
products in different orders.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jllama
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.serving import EngineConfig, ServingEngine
from horovod_tpu_torch.serving.engine import _paged_kernel_path


def np_params(jcfg, seed=0):
    """A parameter tree in the JAX layout, drawn with numpy: matrices
    N(0, 1/fan_in), norm weights near 1 (not exactly 1, so a dropped or
    misapplied norm weight shows)."""
    rng = np.random.RandomState(seed)
    L, D, H, KV, Dh, F = (jcfg.n_layers, jcfg.d_model, jcfg.n_heads,
                          jcfg.n_kv_heads, jcfg.head_dim, jcfg.d_ff)
    norm =lambda *s: (1 + 0.1 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    return {
        "embed": (rng.randn(jcfg.vocab_size, D) / np.sqrt(D)
                  ).astype(np.float32),
        "layers": {
            "attn_norm": norm(L, D),
            "wq": (rng.randn(L, D, H, Dh) / np.sqrt(D)).astype(np.float32),
            "wk": (rng.randn(L, D, KV, Dh) / np.sqrt(D)).astype(np.float32),
            "wv": (rng.randn(L, D, KV, Dh) / np.sqrt(D)).astype(np.float32),
            "wo": (rng.randn(L, H, Dh, D) / np.sqrt(H * Dh)
                   ).astype(np.float32),
            "mlp_norm": norm(L, D),
            "w_gate": (rng.randn(L, D, F) / np.sqrt(D)).astype(np.float32),
            "w_up": (rng.randn(L, D, F) / np.sqrt(D)).astype(np.float32),
            "w_down": (rng.randn(L, F, D) / np.sqrt(F)).astype(np.float32),
        },
        "final_norm": norm(D),
        "lm_head": (rng.randn(D, jcfg.vocab_size) / np.sqrt(D)
                    ).astype(np.float32),
    }


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()          # v256 d64 L2 H4 KV2 fp32
    tcfg = tllama.LlamaConfig.tiny()
    p = np_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, p)
    tparams = tllama.params_from_jax(p, device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_configs_match_jax():
    for name in ("tiny", "llama2_7b"):
        j = getattr(jllama.LlamaConfig, name)()
        t = getattr(tllama.LlamaConfig, name)()
        for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "rope_theta", "head_dim"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_jax_round_trips_every_leaf(dtype):
    jcfg = jllama.LlamaConfig.tiny(dtype=dtype)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tllama.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = jax.tree_util.tree_leaves_with_path(tp)
    assert [k for k, _ in jleaves] == [k for k, _ in tleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == j.dtype.name, path
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(j.astype(jnp.float32)),
            err_msg=str(path))


def test_init_params_layout_matches_jax():
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.bfloat16)
    g = torch.Generator()
    g.manual_seed(0)
    tp = tllama.init_params(tcfg, g, device="cpu")
    jp = jax.eval_shape(lambda: jllama.init_params(
        jllama.LlamaConfig.tiny(dtype=jnp.bfloat16), jax.random.PRNGKey(0)))
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = jax.tree_util.tree_leaves_with_path(tp)
    assert [k for k, _ in jleaves] == [k for k, _ in tleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == j.dtype.name, path
    w = tp["layers"]["w_down"].float()
    assert abs(w.std().item() * np.sqrt(tcfg.d_ff) - 1) < 0.1


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    pos = rng.randint(0, 100, size=(2, 5)).astype(np.int32)
    jt = jllama._rope_tables(jnp.asarray(pos), 10000.0, 16)
    tt = tllama._rope_tables(torch.from_numpy(pos), 10000.0, 16)
    for a, b in zip(jt, tt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    np.testing.assert_allclose(
        tllama._rope(torch.from_numpy(x), tt).numpy(),
        np.asarray(jllama._rope(jnp.asarray(x), jt)), atol=1e-5)
    w = (1 + rng.randn(16)).astype(np.float32)
    np.testing.assert_allclose(
        tllama._rmsnorm_impl(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jllama._rmsnorm_impl(jnp.asarray(x), jnp.asarray(w),
                                        1e-5)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("last_pos", [None, [3, 6]])
def test_prefill_step_matches_jax(models, last_pos):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(2)
    toks = rng.randint(0, jcfg.vocab_size, size=(2, 7)).astype(np.int32)
    jl = None if last_pos is None else jnp.asarray(last_pos, jnp.int32)
    tl = None if last_pos is None else torch.tensor(last_pos)
    jlog, jks, jvs = jllama.prefill_step(jparams, jnp.asarray(toks), jcfg,
                                         last_pos=jl)
    tlog, tks, tvs = tllama.prefill_step(tparams, torch.from_numpy(toks),
                                         tcfg, last_pos=tl)
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
    assert tuple(tks.shape) == jks.shape == (2, 2, 7, 2, 16)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    for li in range(jcfg.n_layers):
        np.testing.assert_allclose(tks[li].numpy(), np.asarray(jks[li]),
                                   atol=1e-4, err_msg=f"K layer {li}")
        np.testing.assert_allclose(tvs[li].numpy(), np.asarray(jvs[li]),
                                   atol=1e-4, err_msg=f"V layer {li}")


@pytest.mark.parametrize("use_flash", [True, False])
def test_decode_step_paged_matches_jax_over_three_ticks(models, use_flash):
    """Three decode ticks over a shared random pool: 3 live slots at
    ragged positions crossing page boundaries, one inactive slot (token 0,
    position 0, all-scratch table).  use_flash=True runs the Pallas
    kernel in interpret mode on the JAX side and the kernel's plain
    version on the port's CPU tensors."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(3)
    L, NB, BS, KV, Dh = jcfg.n_layers, 24, 8, jcfg.n_kv_heads, jcfg.head_dim
    kp = rng.randn(L, NB, BS, KV, Dh).astype(np.float32)
    vp = rng.randn(L, NB, BS, KV, Dh).astype(np.float32)
    tables = np.zeros((4, 4), np.int32)
    tables[0, :1] = [5]
    tables[1, :3] = [3, 9, 7]           # positions 14..16 cross a page
    tables[2, :4] = [1, 2, 6, 11]
    pos = np.array([5, 14, 29, 0], np.int32)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    for tick in range(3):
        tok = rng.randint(0, jcfg.vocab_size, size=(4,)).astype(np.int32)
        tok[3] = 0
        jlog, jk, jv = jllama.decode_step_paged(
            jparams, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
            jnp.asarray(tables), jcfg, use_flash=use_flash,
            interpret=use_flash)
        tlog, tk2, tv2 = tllama.decode_step_paged(
            tparams, torch.from_numpy(tok), torch.from_numpy(pos), tk, tv,
            torch.from_numpy(tables), tcfg, use_flash=use_flash)
        assert tk2 is tk and tv2 is tv, "the pools are written in place"
        np.testing.assert_allclose(tlog[:3].numpy(), np.asarray(jlog)[:3],
                                   atol=1e-4, err_msg=f"tick {tick}")
        pos[:3] += 1
    # Block 0 takes the inactive slot's scratch writes; compare the rest.
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:],
                               atol=1e-4)
    np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:],
                               atol=1e-4)
    changed = np.abs(tk.numpy() - kp).max(axis=(0, 2, 3, 4)) > 0
    assert set(np.nonzero(changed)[0]) == {0, 5, 7, 9, 11}


@pytest.mark.parametrize("use_flash,block_size,expect", [
    ("auto", 8, True), ("never", 8, False), ("auto", 4, False)])
def test_engine_maps_use_flash_like_jax(models, use_flash, block_size,
                                        expect):
    _, _, tcfg, tparams = models
    eng = ServingEngine(tparams, tcfg, device="cpu", engine_cfg=EngineConfig(
        block_size=block_size, num_blocks=8, use_flash=use_flash))
    assert eng._use_flash is expect


@pytest.mark.parametrize("use_flash,block_size,head_dim,expect", [
    ("auto", 8, 16, True), ("never", 4, 16, False),
    ("auto", 4, 16, ValueError), ("auto", 16, 512, ValueError)])
def test_engine_on_cuda_takes_the_kernel_or_raises(use_flash, block_size,
                                                   head_dim, expect):
    """On a CUDA device "auto" means the kernel: a pool geometry it does
    not take raises instead of quietly taking the gather path, which only
    "never" selects there."""
    dev = torch.device("cuda", 0)
    if expect is ValueError:
        with pytest.raises(ValueError, match="block_size % 8"):
            _paged_kernel_path(dev, use_flash, block_size, head_dim)
    else:
        assert _paged_kernel_path(dev, use_flash, block_size,
                                  head_dim) is expect


def test_engine_rejects_interpret_mode(models):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="interpret"):
        ServingEngine(tparams, tcfg, device="cpu",
                      engine_cfg=EngineConfig(use_flash="interpret"))


def test_moe_and_mesh_wait_for_later_slices(models):
    _, _, tcfg, tparams = models
    g = torch.Generator()
    with pytest.raises(NotImplementedError, match="MoE"):
        tllama.init_params(tllama.LlamaConfig.tiny(use_moe=True), g, "cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        tllama.prefill_step(tparams, torch.zeros(1, 3, dtype=torch.int32),
                            tcfg, mesh=object())

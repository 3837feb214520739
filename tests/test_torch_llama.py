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


@pytest.mark.parametrize("dtype,moe", [(jnp.float32, False),
                                       (jnp.bfloat16, False),
                                       (jnp.float32, True),
                                       (jnp.bfloat16, True)])
def test_params_from_jax_round_trips_every_leaf(dtype, moe):
    """Every leaf moves across with its shape, dtype and values; the MoE
    tree (fp32 router, ``[L, E, ...]`` expert stacks) needs nothing
    more."""
    jcfg = jllama.LlamaConfig.tiny(dtype=dtype, use_moe=moe, n_experts=4)
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


@pytest.mark.parametrize("moe", [False, True])
def test_init_params_layout_matches_jax(moe):
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.bfloat16, use_moe=moe,
                                   n_experts=4)
    g = torch.Generator()
    g.manual_seed(0)
    tp = tllama.init_params(tcfg, g, device="cpu")
    jp = jax.eval_shape(lambda: jllama.init_params(
        jllama.LlamaConfig.tiny(dtype=jnp.bfloat16, use_moe=moe,
                                n_experts=4), jax.random.PRNGKey(0)))
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = jax.tree_util.tree_leaves_with_path(tp)
    assert [k for k, _ in jleaves] == [k for k, _ in tleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == j.dtype.name, path
    w = tp["layers"]["w_down"].float()
    assert abs(w.std().item() * np.sqrt(tcfg.d_ff) - 1) < 0.1
    if moe:         # the router: a bf16-rounded draw kept in fp32
        r = tp["layers"]["router"]
        assert torch.equal(r, r.to(torch.bfloat16).float())


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


def _extend_case(name):
    """(tok, positions, valid, tables) of one extend_step_paged call, and
    the random pools it runs over.

    tail: one prefix-hit tail prefill, the way the engine builds it: a
    20-token cached head in blocks 4, 9, 2 (block size 8) and a 7-token
    tail at positions 20..26, padded to 8 slots with position 26 repeated
    and valid False.  verify: a k + 1 = 3 speculative verify over four
    rows at contexts 5, 15 (its window crosses a page), 29 and an inactive
    row (token 0, positions 0..2, valid False, all-scratch table)."""
    rng = np.random.RandomState(4)
    L, NB, BS, KV, Dh = 2, 24, 8, 2, 16
    kp = rng.randn(L, NB, BS, KV, Dh).astype(np.float32)
    vp = rng.randn(L, NB, BS, KV, Dh).astype(np.float32)
    if name == "tail":
        tables = np.array([[4, 9, 2, 13]], np.int32)
        tok = np.zeros((1, 8), np.int32)
        tok[0, :7] = rng.randint(0, 256, 7)
        pos = np.full((1, 8), 26, np.int32)
        pos[0, :7] = np.arange(20, 27)
        valid = np.zeros((1, 8), bool)
        valid[0, :7] = True
    else:
        tables = np.zeros((4, 4), np.int32)
        tables[0, :1] = [5]
        tables[1, :3] = [3, 9, 7]
        tables[2, :4] = [1, 6, 11, 12]
        ctx = np.array([5, 15, 29, 0], np.int32)
        tok = rng.randint(0, 256, (4, 3)).astype(np.int32)
        tok[3] = 0
        pos = ctx[:, None] + np.arange(3, dtype=np.int32)[None, :]
        valid = np.ones((4, 3), bool)
        valid[3] = False
    return (tok, pos, valid, tables), kp, vp


@pytest.mark.parametrize("name", ["tail", "verify"])
def test_extend_step_paged_matches_jax(models, name):
    """Logits of every valid slot within 1e-4 of the JAX package's, and
    both pools within 1e-4 outside scratch block 0 (the invalid slots'
    writes land there, duplicate indices in either package); exactly the
    blocks the valid slots reach were written."""
    jcfg, jparams, tcfg, tparams = models
    args, kp, vp = _extend_case(name)
    jlog, jk, jv = jllama.extend_step_paged(
        jparams, *(jnp.asarray(a) for a in args[:3]), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(args[3]), jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tlog, tk2, tv2 = tllama.extend_step_paged(
        tparams, *(torch.from_numpy(a) for a in args[:3]), tk, tv,
        torch.from_numpy(args[3]), tcfg)
    assert tk2 is tk and tv2 is tv, "the pools are written in place"
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
    valid = args[2]
    np.testing.assert_allclose(tlog.numpy()[valid], np.asarray(jlog)[valid],
                               atol=1e-4)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(t[:, 1:].numpy(), np.asarray(j)[:, 1:],
                                   atol=1e-4)
    changed = set(np.nonzero(
        np.abs(tk.numpy() - kp).max(axis=(0, 2, 3, 4)) > 0)[0])
    want = {2, 13} if name == "tail" else {5, 9, 7, 12}
    assert changed - {0} == want


def test_extend_step_paged_equals_prefill_then_decode(models):
    """A tail prefilled by extend_step_paged over a head the prefill
    wrote gives the tokens a whole-prompt prefill gives: the last real
    slot's logits equal prefill_step's on the full prompt (fp32, 1e-4)."""
    _, _, tcfg, tparams = models
    rng = np.random.RandomState(6)
    prompt = torch.from_numpy(rng.randint(0, 256, (1, 21)).astype(np.int32))
    L, KV, Dh, BS = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim, 8
    kp = torch.zeros(L, 8, BS, KV, Dh)
    vp = torch.zeros_like(kp)
    _, ks, vs = tllama.prefill_step(tparams, prompt[:, :16], tcfg)
    for blk, sl in ((3, slice(0, 8)), (5, slice(8, 16))):
        kp[:, blk] = ks[:, 0, sl]
        vp[:, blk] = vs[:, 0, sl]
    tables = torch.tensor([[3, 5, 6, 0]], dtype=torch.int32)
    tok = torch.zeros(1, 8, dtype=torch.int32)
    tok[0, :5] = prompt[0, 16:]
    pos = torch.full((1, 8), 20, dtype=torch.int32)
    pos[0, :5] = torch.arange(16, 21)
    valid = torch.zeros(1, 8, dtype=torch.bool)
    valid[0, :5] = True
    logits, _, _ = tllama.extend_step_paged(tparams, tok, pos, valid, kp, vp,
                                            tables, tcfg)
    full, _, _ = tllama.prefill_step(tparams, prompt, tcfg)
    np.testing.assert_allclose(logits[0, 4].numpy(), full[0].numpy(),
                               atol=1e-4)


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
    """The name is kept from when MoE configs were refused everywhere and
    ``mesh=`` waited: MoE configs train now, and the serving steps refuse
    them with the JAX package's serving message; the serving steps run on
    dp/fsdp/tp meshes (a mesh of one rank gives the plain step's values
    bitwise) and refuse sp, ep and pp with the JAX package's engine's
    message."""
    _, _, tcfg, tparams = models
    g = torch.Generator()
    mcfg = tllama.LlamaConfig.tiny(use_moe=True, n_experts=4)
    mparams = tllama.init_params(mcfg, g, "cpu")
    assert mparams["layers"]["router"].dtype == torch.float32
    tok = torch.zeros(1, 3, dtype=torch.int32)
    with pytest.raises(NotImplementedError,
                       match="serving does not support MoE configs"):
        tllama.prefill_step(mparams, tok, mcfg)
    tok = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    for axis in ("sp", "ep", "pp"):
        with pytest.raises(NotImplementedError,
                           match=f"serving supports dp/fsdp/tp meshes; "
                                 f"{axis} is a training-path axis here"):
            tllama.prefill_step(tparams, tok, tcfg, mesh={axis: 2})
    one = tllama.prefill_step(tparams, tok, tcfg, mesh={"dp": 1, "tp": 1})
    for a, b in zip(one, tllama.prefill_step(tparams, tok, tcfg)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the MoE Llama (one expert group)
# ---------------------------------------------------------------------------

MOE = dict(use_moe=True, n_experts=4)


@pytest.fixture(scope="module")
def moe_models():
    jcfg = jllama.LlamaConfig.tiny(**MOE)
    tcfg = tllama.LlamaConfig.tiny(**MOE)
    p = jax.tree.map(np.asarray, jllama.init_params(jcfg,
                                                    jax.random.PRNGKey(3)))
    return jcfg, jax.tree.map(jnp.asarray, p), tcfg, \
        tllama.params_from_jax(p, device="cpu")


def _normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


def test_moe_config_defaults_match_jax():
    j, t = jllama.LlamaConfig(), tllama.LlamaConfig()
    assert (t.capacity_factor, t.moe_aux_weight, t.n_experts) == \
        (j.capacity_factor, j.moe_aux_weight, j.n_experts)


def test_moe_forward_logits_and_aux_match_jax(moe_models):
    """fp32 logits within 1e-5 of the largest (normwise) and the aux loss
    (summed over layers) within 1e-5 relative."""
    jcfg, jparams, tcfg, tparams = moe_models
    tokens = np.random.RandomState(4).randint(0, 256, (2, 40)).astype(
        np.int32)
    jl, ja = jllama.forward(jparams, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        tl, ta = tllama.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert _normwise(tl.numpy(), jl) <= 1e-5
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-5)
    assert ta.item() > 0


def test_moe_mlp_matches_jax_and_drops(moe_models):
    """One layer's ``_moe_mlp`` on the same normed tokens: outputs within
    1e-5 normwise, aux within 1e-5, and a capacity factor small enough to
    drop tokens zeroes exactly the JAX package's dropped rows."""
    import dataclasses
    jcfg, jparams, tcfg, tparams = moe_models
    x = np.random.RandomState(5).randn(2, 24, 64).astype(np.float32)
    for cf in (1.25, 0.5):
        jc = dataclasses.replace(jcfg, capacity_factor=cf)
        tc = dataclasses.replace(tcfg, capacity_factor=cf)
        jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
        jo, ja = jllama._moe_mlp(jnp.asarray(x), jlp, jc, None)
        with torch.no_grad():
            to, ta = tllama._moe_mlp(torch.from_numpy(x),
                                     tllama._layer(tparams["layers"], 0), tc)
        assert _normwise(to.numpy(), jo) <= 1e-5
        np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-5)
        jz = np.all(np.asarray(jo) == 0, axis=-1)
        np.testing.assert_array_equal(np.all(to.numpy() == 0, axis=-1), jz)
        if cf < 1:
            assert jz.sum() > 0


def test_moe_refusals_keep_the_reference_messages(moe_models):
    from horovod_tpu_torch.serving import ServingEngine
    _, _, tcfg, tparams = moe_models
    tok = torch.zeros(2, dtype=torch.int32)
    pool = torch.zeros(2, 4, 4, 2, 16)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    msg = "serving does not support MoE configs"
    with pytest.raises(NotImplementedError,
                       match="generate does not support MoE configs"):
        tllama.generate(tparams, tok[:, None], tcfg, max_new_tokens=2)
    with pytest.raises(NotImplementedError, match=msg):
        tllama.decode_step_paged(tparams, tok, tok, pool, pool.clone(),
                                 tables, tcfg)
    with pytest.raises(NotImplementedError, match=msg):
        tllama.extend_step_paged(tparams, tok[:, None], tok[:, None],
                                 tok[:, None] == 0, pool, pool.clone(),
                                 tables, tcfg)
    with pytest.raises(NotImplementedError, match=msg):
        ServingEngine(tparams, tcfg, device="cpu")
    from mp_torch_mesh_worker import PipelineMesh
    with pytest.raises(NotImplementedError,
                       match="generate does not support MoE configs"):
        tllama.generate(tparams, tok[:, None], tcfg, max_new_tokens=2,
                        mesh=PipelineMesh())
    with pytest.raises(NotImplementedError, match=msg):
        ServingEngine(tparams, tcfg, device="cpu", mesh={"tp": 2})


def test_serving_steps_run_the_configs_layers(models):
    """The steps run ``cfg.n_layers`` layers of the stacks they are given
    (a cut config over whole weights: the card's kernel-against-gather
    parity runs one layer of the 7B weights so), the same values as the
    stacks cut to those layers."""
    import dataclasses
    _, _, tcfg, tparams = models
    one = dataclasses.replace(tcfg, n_layers=1)
    cut = dict(tparams, layers={k: v[:1] for k, v in
                                tparams["layers"].items()})
    tok = torch.tensor([3, 7], dtype=torch.int32)
    pos = torch.tensor([2, 5], dtype=torch.int32)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pool = torch.randn(2, 6, 4, tcfg.n_kv_heads, tcfg.head_dim,
                       generator=torch.Generator().manual_seed(1))
    outs = [tllama.decode_step_paged(p, tok, pos, pool.clone(), pool.clone(),
                                     tables, one)[0] for p in (tparams, cut)]
    assert torch.equal(*outs)
    pre = [tllama.prefill_step(p, tok[None], one)[0] for p in (tparams, cut)]
    assert torch.equal(*pre)

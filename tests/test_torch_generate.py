"""Port parity: ``horovod_tpu_torch.models.llama.generate``.

Greedy decoding must equal the JAX package's ``generate`` token for token
on the same parameters (the JAX package's tiny fp32 model and a GQA
variant, moved across with ``params_from_jax``; prompts drawn with numpy),
and equal greedy decoding by repeated full ``forward`` calls of the port
(the KV-cache oracle of ``tests/test_llama.py``).  Tokens are compared
exactly: fp32 logits whose top two differ by far more than the two
frameworks' rounding.  Sampling cannot equal ``jax.random``'s draws; it
is held to reproducibility under one generator seed and to the
vocabulary.

On rank meshes (``generate(mesh=)``: tp2, dp2 and pp2 at np=2, pp2 x tp2
and pp2 x dp2 at np=4, one job a world size of
``tests/mp_torch_mesh_worker.py``'s ``generate`` mode over Gloo) every
rank's greedy tokens equal the JAX package's ``generate`` on a mesh of
the same shape (its GSPMD path, its stage-resident ``_generate_pp`` on
pp) and the unsharded ``generate``'s; sampling is reproducible and the
same on every rank; ``decode_tp_overlap`` changes no token at tp=2.
"""

from __future__ import annotations

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mp_torch_mesh_worker as MW
from horovod_tpu.models import llama as jllama
from horovod_tpu.parallel import MeshConfig as JMeshConfig
from horovod_tpu.parallel import build_mesh as jbuild_mesh
from horovod_tpu_torch.models import llama as tllama

CONFIGS = {"tiny": {}, "gqa": dict(n_heads=8, n_kv_heads=2, d_model=64)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    kw = CONFIGS[request.param]
    jcfg = jllama.LlamaConfig.tiny(**kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tllama.LlamaConfig.tiny(**kw), tparams


def _prompt(B=2, P=8, seed=5):
    return np.random.RandomState(seed).randint(0, 256, (B, P)).astype(
        np.int32)


@pytest.mark.parametrize("B,P,new", [(2, 8, 6), (3, 5, 1), (1, 13, 9)])
def test_greedy_generate_matches_jax(models, B, P, new):
    jcfg, jparams, tcfg, tparams = models
    prompt = _prompt(B, P)
    want = np.asarray(jllama.generate(jparams, jnp.asarray(prompt), jcfg,
                                      max_new_tokens=new))
    got = tllama.generate(tparams, torch.from_numpy(prompt), tcfg,
                          max_new_tokens=new)
    assert got.shape == (B, P + new) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_matches_repeated_full_forward(models):
    """Prefill plus cached single-token ticks equal recomputing the whole
    sequence each step (the port's own forward, its flash Function's
    plain version on CPU tensors)."""
    _, _, tcfg, tparams = models
    prompt = torch.from_numpy(_prompt())
    out = tllama.generate(tparams, prompt, tcfg, max_new_tokens=6)
    assert torch.equal(out[:, :8], prompt)
    seq = prompt
    with torch.no_grad():
        for _ in range(6):
            logits, _ = tllama.forward(tparams, seq, tcfg)
            nxt = logits[:, -1].argmax(-1).to(seq.dtype)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert torch.equal(out, seq)


def test_sampling_is_reproducible_and_in_vocab(models):
    _, _, tcfg, tparams = models
    prompt = torch.from_numpy(_prompt())

    def sample(seed):
        g = torch.Generator().manual_seed(seed)
        return tllama.generate(tparams, prompt, tcfg, max_new_tokens=8,
                               temperature=1.0, generator=g)

    a, b = sample(11), sample(11)
    assert torch.equal(a, b)
    new = a[:, 8:]
    assert bool(((new >= 0) & (new < tcfg.vocab_size)).all())
    assert torch.equal(a[:, :8], prompt)
    greedy = tllama.generate(tparams, prompt, tcfg, max_new_tokens=8)
    draws = [sample(s)[:, 8:] for s in range(4)]
    assert any(not torch.equal(d, greedy[:, 8:]) for d in draws), \
        "temperature 1.0 sampled the greedy tokens four times running"


def test_generate_argument_errors(models):
    _, _, tcfg, tparams = models
    prompt = torch.from_numpy(_prompt())
    with pytest.raises(ValueError, match="Generator"):
        tllama.generate(tparams, prompt, tcfg, max_new_tokens=2,
                        temperature=0.7)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="max_new_tokens"):
            tllama.generate(tparams, prompt, tcfg, max_new_tokens=bad)
    for sizes in ({"sp": 2}, {"ep": 2}, {"dp": 2, "sp": 2}):
        with pytest.raises(NotImplementedError,
                           match="generate supports dp/fsdp/tp/pp meshes; "
                                 "sp/ep are training-path axes"):
            tllama.generate(tparams, prompt, tcfg, max_new_tokens=2,
                            mesh=sizes)
    with pytest.raises(NotImplementedError, match="MoE"):
        tllama.generate(tparams, prompt, tllama.LlamaConfig.tiny(
            use_moe=True), max_new_tokens=2)


# ---------------------------------------------------------------------------
# generate(mesh=) over Gloo
# ---------------------------------------------------------------------------

def _full_params():
    return jax.tree.map(np.asarray, jllama.init_params(
        jllama.LlamaConfig.tiny(), jax.random.PRNGKey(0),
        jbuild_mesh(JMeshConfig(), devices=jax.devices()[:1])))


def _jax_generate(full, sizes, n):
    cfg = jllama.LlamaConfig.tiny()
    mesh = jbuild_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])
    params = jax.device_put(jax.tree.map(jnp.asarray, full),
                            jllama.param_shardings(cfg, mesh))
    return np.asarray(jllama.generate(
        params, jnp.asarray(MW.gen_prompt()), cfg,
        max_new_tokens=MW.GEN["new"], mesh=mesh))


def _gen_run(n, tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp(f"gen{n}"))
    full = _full_params()
    np.savez(os.path.join(outdir, "params.dense.npz"),
             **MW.flat_params(full))
    box = {}
    job = threading.Thread(target=lambda: box.setdefault(
        "res", MW.launch("generate", outdir, n, timeout=240)))
    job.start()
    ref = {name: _jax_generate(full, sizes, n)
           for name, sizes in MW.GEN_MESHES[n].items()}
    job.join()
    import mp_torch_dataplane_worker as DW
    DW.check_ranks(box["res"])
    plain = tllama.generate(
        tllama.params_from_jax(full, "cpu"),
        torch.from_numpy(MW.gen_prompt()), tllama.LlamaConfig.tiny(),
        max_new_tokens=MW.GEN["new"]).numpy()
    return MW.load("generate", outdir, n), ref, plain


@pytest.fixture(scope="module")
def gen2(tmp_path_factory):
    return _gen_run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def gen4(tmp_path_factory):
    return _gen_run(4, tmp_path_factory)


GEN_CASES = {name: n for n, meshes in MW.GEN_MESHES.items()
             for name in meshes}


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_mesh_generate_matches_jax_and_unsharded(request, name):
    """Greedy tokens on the mesh, on every rank, equal the JAX package's
    on a mesh of the same shape and the unsharded ``generate``'s."""
    ranks, ref, plain = request.getfixturevalue(f"gen{GEN_CASES[name]}")
    np.testing.assert_array_equal(ref[name], plain)
    for arrays, info in ranks:
        assert not info["jax_loaded"]
        np.testing.assert_array_equal(arrays[f"{name}.greedy"], ref[name])


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_mesh_sampling_is_reproducible_and_the_same_on_every_rank(request,
                                                                  name):
    ranks, _, plain = request.getfixturevalue(f"gen{GEN_CASES[name]}")
    first = ranks[0][0][f"{name}.sampled0"]
    P = MW.GEN["P"]
    np.testing.assert_array_equal(first[:, :P], plain[:, :P])
    assert ((first >= 0) & (first < 256)).all()
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays[f"{name}.sampled0"], first)
        np.testing.assert_array_equal(arrays[f"{name}.sampled1"], first)


@pytest.mark.parametrize("name", [n for n, c in GEN_CASES.items()
                                  if MW.GEN_MESHES[c][n].get("tp", 1) > 1])
def test_decode_tp_overlap_changes_no_token(request, name):
    """The fused chunked matmul + reduce-scatter row-parallel projections
    (``decode_tp_overlap=True``) give the plain all-reduce's tokens at
    tp=2 (the reference's ``test_llama_decode_tp_overlap_token_parity``)."""
    ranks, _, _ = request.getfixturevalue(f"gen{GEN_CASES[name]}")
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays[f"{name}.overlap"],
                                      arrays[f"{name}.greedy"])


def test_decode_tp_overlap_chunks_follow_the_knob(monkeypatch):
    """``decode_tp_overlap=None`` follows the runtime's sched_mode (on when
    "decomposed", ``sched_chunks`` chunks, at least 2), as the JAX
    package's ``_decode_tp_overlap_chunks``; True and False force it; tp 1
    never fuses."""
    import dataclasses

    from horovod_tpu_torch import context
    cfg = tllama.LlamaConfig.tiny()
    assert tllama._decode_tp_overlap_chunks(cfg, 1) == 0
    assert tllama._decode_tp_overlap_chunks(cfg, 2) == 0
    on = dataclasses.replace(cfg, decode_tp_overlap=True)
    assert tllama._decode_tp_overlap_chunks(on, 2) == 2
    state = context.global_state()
    monkeypatch.setattr(state, "initialized", True)
    monkeypatch.setattr(state.config, "sched_mode", "decomposed")
    monkeypatch.setattr(state.config, "sched_chunks", 4)
    assert tllama._decode_tp_overlap_chunks(cfg, 2) == 4
    off = dataclasses.replace(cfg, decode_tp_overlap=False)
    assert tllama._decode_tp_overlap_chunks(off, 2) == 0

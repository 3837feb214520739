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
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jllama
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
    with pytest.raises(NotImplementedError, match="mesh"):
        tllama.generate(tparams, prompt, tcfg, max_new_tokens=2,
                        mesh=object())
    with pytest.raises(NotImplementedError, match="MoE"):
        tllama.generate(tparams, prompt, tllama.LlamaConfig.tiny(
            use_moe=True), max_new_tokens=2)

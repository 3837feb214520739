"""Port parity: ``horovod_tpu_torch/parallel/pipeline.py``, the GPipe and
1F1B schedules, against the JAX package's ``pipeline_apply_local`` and
``pipeline_train_local`` on the same inputs.

The port runs at np=2 and np=4 on the CPU over Gloo under the port's
launcher (``tests/mp_torch_mesh_worker.py``, mode ``pipeline``: one job a
world size), each rank one stage ``x -> tanh(x @ W_s)`` (with an aux
``mean(y ** 2)`` weighted 0.5 in the aux cases) and the loss head
``mean((y + b - target_m) ** 2)`` over M = 8 microbatches of 2 rows of 4
(``tests/test_parallel.py``'s 1F1B oracle).  The JAX package runs the
same stages in ``shard_map`` over the first n of the conftest's 8 CPU
devices, its GPipe under ``jax.grad``.  Bars: losses, aux and every
gradient within rtol 1e-5 (atol 1e-7) of the JAX package's and of plain
autograd through the sequential composition (``pipeline_apply``: within
rtol 1e-5, atol 1e-6 of the numpy composition); the one-process driver
bitwise the np=2 job; a 1F1B stage holds at most 2(n - 1) inputs.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import mp_torch_mesh_worker as MW
from horovod_tpu.jaxcompat import shard_map
from horovod_tpu.parallel import pipeline as jpipe
from horovod_tpu_torch.parallel import pipeline as tpipe

TAGS = ("plain", "aux")
TOL = dict(rtol=1e-5, atol=1e-7)


def _jax_stage(with_aux):
    def fn(w, x):
        y = jnp.tanh(x @ w)
        return (y, jnp.mean(y * y)) if with_aux else (y, jnp.float32(0.0))
    return fn


@functools.lru_cache(maxsize=None)
def _jax(n: int, tag: str) -> dict:
    """The JAX package's 1F1B results and its GPipe loss, outputs and
    gradients on n stages."""
    ws, bias, mbs, tgts = MW.pipe_inputs(n)
    aux = tag == "aux"
    mesh = Mesh(np.array(jax.devices()[:n]), ("pp",))
    tg = jnp.asarray(tgts)

    def head(hp, y, m):
        return jnp.mean((y + hp - tg[m]) ** 2)

    def local(wl, hp, mb_in):
        loss, a, dmbs, dw, dh = jpipe.pipeline_train_local(
            _jax_stage(aux), wl[0], mb_in, head, hp, axis_name="pp",
            aux_weight=MW.AUX_W if aux else 0.0)
        return loss, a, dmbs, dw[None], dh

    f1b = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("pp"), P(), P()),
                            out_specs=(P(), P(), P(), P("pp"), P()),
                            check_vma=False))
    loss, a, dmbs, dw, dh = f1b(jnp.asarray(ws), jnp.asarray(bias),
                                jnp.asarray(mbs))

    def gpipe_loss(w, hp, xs):
        def loc(wl, x_in):
            fn = _jax_stage(aux)
            if aux:
                return jpipe.pipeline_apply_local(
                    lambda p, x: fn(p, x), wl[0], x_in, axis_name="pp",
                    with_aux=True)
            out = jpipe.pipeline_apply_local(lambda p, x: fn(p, x)[0], wl[0],
                                             x_in, axis_name="pp")
            return out, jnp.zeros((1,), jnp.float32)

        out, ax = shard_map(loc, mesh=mesh, in_specs=(P("pp"), P()),
                            out_specs=(P(), P()), check_vma=False)(w, xs)
        loss = jnp.mean(jnp.mean((out + hp - tg) ** 2, axis=(1, 2)))
        return loss + (MW.AUX_W * ax[0] if aux else 0.0), out

    (gl, gout), grads = jax.jit(jax.value_and_grad(
        gpipe_loss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(ws), jnp.asarray(bias), jnp.asarray(mbs))
    return {"1f1b": (float(loss), float(a), np.asarray(dmbs), np.asarray(dw),
                     np.asarray(dh)),
            "gpipe": (float(gl), np.asarray(gout),
                      *(np.asarray(g) for g in grads))}


def _oracle(n: int, tag: str) -> dict:
    """Plain autograd through the sequential composition of the stages:
    the loss (with the aux summed over stages and averaged over
    microbatches) and its gradients."""
    ws, bias, mbs, tgts = (torch.from_numpy(a) for a in MW.pipe_inputs(n))
    ws, bias, mbs = (t.clone().requires_grad_() for t in (ws, bias, mbs))
    M = mbs.shape[0]
    total, aux = 0.0, 0.0
    for m in range(M):
        x = mbs[m]
        for s in range(n):
            x = torch.tanh(x @ ws[s])
            aux = aux + (x * x).mean()
        total = total + ((x + bias - tgts[m]) ** 2).mean()
    loss = total / M + (MW.AUX_W * aux / M if tag == "aux" else 0.0)
    loss.backward()
    return {"loss": loss.item(), "dw": ws.grad.numpy(),
            "dh": bias.grad.numpy(), "dmbs": mbs.grad.numpy()}


def _run(n, tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp(f"pipe{n}"))
    box = {}
    job = threading.Thread(target=lambda: box.setdefault(
        "res", MW.launch("pipeline", outdir, n, timeout=240)))
    job.start()
    for tag in TAGS:
        _jax(n, tag)
    job.join()
    import mp_torch_dataplane_worker as DW
    DW.check_ranks(box["res"])
    return MW.load("pipeline", outdir, n)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _run(4, tmp_path_factory)


@pytest.mark.parametrize("n", (2, 4))
def test_pipeline_apply_matches_jax_and_sequential(request, n):
    """The standalone entry, ``pipeline_apply`` over a mesh's pp group
    with the stages stacked stage-major: the JAX package's
    ``pipeline_apply`` outputs on every rank (``tests/test_parallel.py::
    test_pipeline_matches_sequential``) and the sequential composition."""
    ranks = request.getfixturevalue(f"ranks{n}")
    ws, _, mbs, _ = MW.pipe_inputs(n)
    mesh = Mesh(np.array(jax.devices()[:n]), ("pp",))
    want = np.asarray(jpipe.pipeline_apply(
        lambda w, x: jnp.tanh(x @ w), jnp.asarray(ws), jnp.asarray(mbs),
        mesh))
    seq = mbs.copy()
    for s in range(n):
        seq = np.tanh(seq @ ws[s])
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["apply"], want, **TOL)
        np.testing.assert_allclose(arrays["apply"], seq, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("n", (2, 4))
def test_1f1b_matches_jax_and_autograd(request, n, tag):
    """Every stage: the loss and aux (summed over the pipeline, over M),
    stage 0's input cotangents (on every stage), its own weight's
    gradient and the head's (summed over the stages) within rtol 1e-5 of
    the JAX package's ``pipeline_train_local`` and of plain autograd."""
    ranks = request.getfixturevalue(f"ranks{n}")
    jl, ja, jdm, jdw, jdh = _jax(n, tag)["1f1b"]
    orc = _oracle(n, tag)
    for r, (arrays, info) in enumerate(ranks):
        np.testing.assert_allclose(info[f"1f1b.{tag}.loss"] + MW.AUX_W *
                                   info[f"1f1b.{tag}.aux"] * (tag == "aux"),
                                   orc["loss"], **TOL)
        np.testing.assert_allclose(info[f"1f1b.{tag}.loss"], jl, **TOL)
        np.testing.assert_allclose(info[f"1f1b.{tag}.aux"], ja, **TOL)
        for key, want, oracle in (("dw", jdw[r], orc["dw"][r]),
                                  ("dh", jdh, orc["dh"]),
                                  ("dmbs", jdm, orc["dmbs"])):
            got = arrays[f"1f1b.{tag}.{key}"]
            np.testing.assert_allclose(got, want, err_msg=key, **TOL)
            np.testing.assert_allclose(got, oracle, err_msg=key, **TOL)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("n", (2, 4))
def test_gpipe_matches_jax_and_autograd(request, n, tag):
    """GPipe under autograd: the last stage's outputs on every stage, the
    loss of one copy of them and, through the handoffs' backward, each
    stage's weight gradient, the head's and stage 0's input cotangents
    within rtol 1e-5 of the JAX package's ``jax.grad`` through
    ``pipeline_apply_local`` and of plain autograd: one loss's gradient
    on every stage, not n copies of it."""
    ranks = request.getfixturevalue(f"ranks{n}")
    jl, jout, jdw, jdh, jdm = _jax(n, tag)["gpipe"]
    orc = _oracle(n, tag)
    for r, (arrays, info) in enumerate(ranks):
        np.testing.assert_allclose(info[f"gpipe.{tag}.loss"], jl, **TOL)
        np.testing.assert_allclose(info[f"gpipe.{tag}.loss"], orc["loss"],
                                   **TOL)
        np.testing.assert_allclose(arrays[f"gpipe.{tag}.out"], jout, **TOL)
        for key, want, oracle in (("dw", jdw[r], orc["dw"][r]),
                                  ("dh", jdh, orc["dh"])):
            got = arrays[f"gpipe.{tag}.{key}"]
            np.testing.assert_allclose(got, want, err_msg=key, **TOL)
            np.testing.assert_allclose(got, oracle, err_msg=key, **TOL)
        if r == 0:      # only stage 0 reads the microbatches
            np.testing.assert_allclose(arrays[f"gpipe.{tag}.dmbs"], jdm,
                                       **TOL)
        else:
            assert arrays[f"gpipe.{tag}.dmbs"].size == 0


@pytest.mark.parametrize("n", (2, 4))
def test_1f1b_holds_at_most_2_n_minus_1_inputs(request, n):
    ranks = request.getfixturevalue(f"ranks{n}")
    for r, (_, info) in enumerate(ranks):
        held = info["1f1b.plain.max_saved"]
        assert held == 0 if r == n - 1 else 1 <= held <= 2 * (n - 1)


@pytest.mark.parametrize("tag", TAGS)
def test_one_process_drivers_are_bitwise_the_np2_job(ranks2, tag):
    """Both stages in this process, the handoffs in memory: the 1F1B
    results and the GPipe outputs and gradients are bitwise each rank's
    of the np=2 job."""
    aux = tag == "aux"
    ws, bias, mbs, tgts = (torch.from_numpy(a) for a in MW.pipe_inputs(2))
    w = [ws[s].clone().requires_grad_() for s in range(2)]
    hp = bias.clone().requires_grad_()
    stages = [{"stage_fn": MW.toy_stage(torch, w[s], True) if aux else
               (lambda x, ww=w[s]: (torch.tanh(x @ ww), torch.zeros(()))),
               "params": [w[s]]} for s in range(2)]
    stages[-1].update(loss_head=lambda y, m: ((y + hp - tgts[m]) ** 2).mean(),
                      head_params=[hp])
    res = tpipe.pipeline_train_stages(stages, mbs,
                                      aux_weight=MW.AUX_W if aux else 0.0)
    for r, (arrays, info) in enumerate(ranks2):
        loss, a, dmbs, (dw,), (dh,) = res[r]
        assert loss.item() == info[f"1f1b.{tag}.loss"]
        assert a.item() == info[f"1f1b.{tag}.aux"]
        np.testing.assert_array_equal(dw.numpy(), arrays[f"1f1b.{tag}.dw"])
        np.testing.assert_array_equal(dh.numpy(), arrays[f"1f1b.{tag}.dh"])
        np.testing.assert_array_equal(dmbs.numpy(),
                                      arrays[f"1f1b.{tag}.dmbs"])
    w = [ws[s].clone().requires_grad_() for s in range(2)]
    hp = bias.clone().requires_grad_()
    xs = mbs.clone().requires_grad_()
    out = tpipe.pipeline_apply_stages(
        [MW.toy_stage(torch, w[s], aux) for s in range(2)], xs, with_aux=aux)
    out, a = out if aux else (out, torch.zeros(()))
    M = out.shape[0]
    loss = sum(((out[m] + hp - tgts[m]) ** 2).mean()
               for m in range(M)) / M + MW.AUX_W * a
    loss.backward()
    for r, (arrays, info) in enumerate(ranks2):
        assert loss.item() == info[f"gpipe.{tag}.loss"]
        np.testing.assert_array_equal(out.detach().numpy(),
                                      arrays[f"gpipe.{tag}.out"])
        np.testing.assert_array_equal(w[r].grad.numpy(),
                                      arrays[f"gpipe.{tag}.dw"])
        np.testing.assert_array_equal(hp.grad.numpy(),
                                      arrays[f"gpipe.{tag}.dh"])
    np.testing.assert_array_equal(xs.grad.numpy(),
                                  ranks2[0][0][f"gpipe.{tag}.dmbs"])


def test_tick_tables_pair_every_handoff():
    """Every handoff one side posts, the other side expects at the same
    tick, and nothing more, for both schedules (pp = 2..4, M = 1..9):
    the deadlock rule over Gloo."""
    for n in (2, 3, 4):
        for M in range(1, 10):
            mbs = [torch.zeros(1)] * M
            g = [tpipe.GPipeStage(s, n, None, mbs, False) for s in range(n)]
            f = [tpipe.OneFOneBStage(s, n, None, [], mbs, None, [])
                 for s in range(n)]
            for t in range(M + 2 * (n - 1)):
                for s in range(n - 1):
                    assert g[s].sends(t) == g[s + 1].receives(t)
                    assert f[s].sends_fwd(t) == f[s + 1].receives_fwd(t)
                    assert f[s + 1].sends_bwd(t) == f[s].receives_bwd(t)
            live = [[t for t in range(M + n - 1) if g[s].live(t)]
                    for s in range(n)]
            assert all(len(x) == M for x in live)

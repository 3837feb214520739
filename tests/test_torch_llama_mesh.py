"""Port parity: the Llama trained on rank meshes
(``horovod_tpu_torch/models/llama.py`` with ``mesh=``), against the JAX
package's ``make_train_step(cfg, mesh, tx)`` on a mesh of the same shape.

The port runs at np=2 and np=4 on the CPU over Gloo under the port's
launcher (``tests/mp_torch_mesh_worker.py``, mode ``llama``: one job a
world size, every mesh of ``MESHES`` in it), from the JAX package's full
parameters (``init_params(LlamaConfig.tiny(), PRNGKey(0), mesh)``, the
same values on every mesh) turned into each rank's blocks by
``shard_params``.  The JAX package runs in this
process over the first n of the conftest's 8 CPU devices, handed to its
``build_mesh`` so that its device order is the port's row-major rank
order, while the port's job runs.  Config: ``LlamaConfig.tiny()`` (2
layers, d_model 64, 4 heads, 2 kv heads, d_ff 128, vocab 256, fp32), B=8,
S=32, Adam at lr 1e-2, 3 steps; the MoE case with 4 experts at capacity
factor 2.0.

Bars: losses within rtol 1e-5 of the JAX package's; after one backward,
the loss within rtol 1e-5 and every gradient block within rtol 2e-3 /
atol 2e-4 (``tests/test_torch_train.py``'s); each at-rest block bitwise
the JAX array's block on the device of the same mesh coordinate; Adam's
state the size of its parameter's block; fsdp=4 against dp=4 within rtol
1e-4 (``tests/test_llama.py``'s bar); tp=4, where the 2 kv heads are
replicated, within rtol 1e-5 of the unsharded loss; the one-rank mesh
bitwise the plain step.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import mp_torch_mesh_worker as MW
from horovod_tpu.models import llama as jllama
from horovod_tpu.parallel import MeshConfig as JMeshConfig
from horovod_tpu.parallel import build_mesh as jbuild_mesh
from horovod_tpu_torch.models import llama as tllama

GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
# Meshes the JAX package trains on (dp=4 is held against the port's fsdp=4)
JAX_TRAINED = ("fsdp2", "tp2", "sp2_ring", "sp2_ulysses", "fsdp2_blockwise",
               "moe_fsdp2", "dp2tp2", "fsdp2tp2", "dp2sp2", "tp4", "fsdp4",
               "moe_ep2tp2", "moe_ep2sp2")
CASES = {name: n for n, meshes in MW.MESHES.items() for name in meshes}


def _jcfg(edits):
    return jllama.LlamaConfig.tiny(**edits)


def _jmesh(sizes, n):
    return jbuild_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def _jax_params_cached(edits: tuple):
    return jax.tree.map(np.asarray, jllama.init_params(
        _jcfg(dict(edits)), jax.random.PRNGKey(0), _jmesh({}, 1)))


def _jax_params(edits):
    """The JAX package's weights on a mesh, as numpy: its jitted init
    draws the same values on every mesh (its eager, mesh-less init rounds
    ``w_down``'s scale otherwise), so these are every mesh's."""
    return _jax_params_cached(tuple(sorted(edits.items())))


def _jax_cases(n, batch) -> dict:
    """What the JAX package gives on each mesh of world size n: 3 losses,
    the at-rest blocks by device index, and the first loss and gradients.
    The programs compile four at a time in threads (compilation is most
    of the time) and run one after another."""
    from concurrent.futures import ThreadPoolExecutor
    devs = list(jax.devices()[:n])
    todo = {}
    for name, (sizes, edits, extra) in MW.MESHES[n].items():
        if name not in JAX_TRAINED and not {"shards", "grads"} & set(extra):
            continue
        cfg, mesh = _jcfg(edits), _jmesh(sizes, n)
        params = jllama.init_params(cfg, jax.random.PRNGKey(0), mesh)
        jb = jax.device_put(batch, NamedSharding(mesh, P(("dp", "fsdp"))))
        todo[name] = dict(cfg=cfg, mesh=mesh, params=params, jb=jb,
                          extra=extra, out={})
        if "shards" in extra:
            todo[name]["out"]["shards"] = {
                (key, devs.index(sh.device)): np.asarray(sh.data)
                for key, leaf in MW.flat_params(params).items()
                for sh in leaf.addressable_shards}
        if name in JAX_TRAINED:
            tx = optax.adam(MW.LR)
            todo[name]["state"] = jax.jit(tx.init)(params)
            todo[name]["tx"] = tx

    def compile_(t):
        cfg, mesh, params, jb = t["cfg"], t["mesh"], t["params"], t["jb"]
        if "grads" in t["extra"]:
            t["grad_fn"] = jax.jit(jax.value_and_grad(
                lambda p: jllama.loss_fn(p, jb, cfg, mesh=mesh))).lower(
                    params).compile()
        if "tx" in t:
            t["step"] = jllama.make_train_step(cfg, mesh, t["tx"]).lower(
                params, t["state"], jb).compile()

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(compile_, todo.values()))
    for t in todo.values():
        params, out = t["params"], t["out"]
        if "grad_fn" in t:
            loss, grads = t["grad_fn"](params)
            out["grad_loss"] = float(loss)
            out["grads"] = MW.flat_params(jax.tree.map(np.asarray, grads))
        if "step" in t:
            state, losses = t["state"], []
            for _ in range(MW.STEPS):
                params, state, loss = t["step"](params, state, t["jb"])
                losses.append(float(loss))
            out["losses"] = losses
    return {name: t["out"] for name, t in todo.items()}


def _run(n, tmp_path_factory) -> tuple:
    """The port's job at world size n (in a thread) beside the JAX
    package's runs of the same meshes."""
    outdir = str(tmp_path_factory.mktemp(f"mesh{n}"))
    for kind, edits in (("dense", {}), ("moe", MW.MOE)):
        np.savez(os.path.join(outdir, f"params.{kind}.npz"),
                 **MW.flat_params(_jax_params(edits)))
    box = {}
    job = threading.Thread(
        target=lambda: box.setdefault("res", MW.launch("llama", outdir, n)))
    job.start()
    ref = _jax_cases(n, {"tokens": jnp.asarray(MW.tokens())})
    job.join()
    import mp_torch_dataplane_worker as DW
    DW.check_ranks(box["res"])
    return MW.load("llama", outdir, n), ref


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    return _run(4, tmp_path_factory)


def _case(request, name):
    return request.getfixturevalue(f"run{CASES[name]}")


@pytest.mark.parametrize("n", (2, 4))
def test_ranks_import_no_jax(request, n):
    ranks, _ = request.getfixturevalue(f"run{n}")
    assert len(ranks) == n
    assert not any(info["jax_loaded"] for _, info in ranks)


@pytest.mark.parametrize("name", [n for n in JAX_TRAINED
                                  if n != "moe_fsdp2"])
def test_losses_match_jax(request, name):
    """Three Adam steps: every rank reports the global loss, within rtol
    1e-5 of the JAX package's on the same mesh."""
    ranks, ref = _case(request, name)
    for _, info in ranks:
        np.testing.assert_allclose(info[f"{name}.losses"],
                                   ref[name]["losses"], rtol=1e-5)
    losses = ranks[0][1][f"{name}.losses"]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", ("dp2tp2", "sp2tp2", "moe_fsdp2"))
def test_loss_and_grads_match_jax(request, name):
    """One backward: the loss within rtol 1e-5, and each rank's block of
    every gradient (after ``reduce_gradients``) within the tolerances of
    ``tests/test_torch_train.py`` of the JAX gradient's block."""
    from horovod_tpu_torch.parallel import sharding as shd
    ranks, ref = _case(request, name)
    sizes, edits, _ = MW.MESHES[CASES[name]][name]
    tcfg = tllama.LlamaConfig.tiny(**edits)
    specs = MW.flat_params(tllama.param_shardings(tcfg, sizes))
    axes = ("pp", "dp", "fsdp", "ep", "sp", "tp")
    full = {a: sizes.get(a, 1) for a in axes}
    for r, (arrays, info) in enumerate(ranks):
        np.testing.assert_allclose(info[f"{name}.grad_loss"],
                                   ref[name]["grad_loss"], rtol=1e-5)
        coord = dict(zip(axes, np.unravel_index(
            r, [full[a] for a in axes])))
        for key, g in ref[name]["grads"].items():
            want = shd.block(g, specs[key], full, coord)
            np.testing.assert_allclose(
                arrays[f"{name}.grad.{key}"], want, rtol=GRAD_RTOL,
                atol=GRAD_ATOL, err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("name", [n for c in MW.MESHES.values()
                                  for n, v in c.items() if "shards" in v[2]])
def test_at_rest_blocks_are_the_jax_arrays_shards(request, name):
    """``shard_params`` of the JAX package's full weights gives each rank
    bitwise the block that the JAX package's ``init_params(mesh=)`` puts
    on the device of the same coordinate, ``embed`` under
    ``("tp", "fsdp")`` included; and no rank holds a full weight where
    the spec shards it."""
    ranks, ref = _case(request, name)
    blocks = ref[name]["shards"]
    for r, (arrays, _) in enumerate(ranks):
        for (key, dev), want in blocks.items():
            if dev != r:
                continue
            got = arrays[f"{name}.shard.{key}"]
            assert got.shape == want.shape, (r, key)
            np.testing.assert_array_equal(got, want, err_msg=f"{r} {key}")


@pytest.mark.parametrize("name", [n for c in MW.MESHES.values()
                                  for n, v in c.items() if "state" in v[2]])
def test_adam_state_is_sharded(request, name):
    """Adam's moments are the size of their parameter's block: 1/fsdp of
    an fsdp-sharded leaf (1/(fsdp tp), 1/(ep tp) where tp or ep shard it
    too), the whole of a replicated one."""
    ranks, _ = _case(request, name)
    sizes, edits, _ = MW.MESHES[CASES[name]][name]
    tcfg = tllama.LlamaConfig.tiny(**edits)
    from horovod_tpu_torch.parallel import sharding as shd
    full = tllama.params_from_jax(_jax_params(edits), "cpu")
    whole = [p.numel() for p in tllama.trainable(full)]
    specs = tllama.trainable_specs(full, tcfg, sizes)
    for _, info in ranks:
        for (local, m1, m2), w, spec in zip(info[f"{name}.state"], whole,
                                            specs):
            split = int(np.prod([sizes.get(a, 1)
                                 for a in shd.spec_axes(spec)]))
            assert local == m1 == m2 == w // split, (spec, local, w)
    assert any(s[0] < w for s, w in zip(ranks[0][1][f"{name}.state"],
                                        whole))


def test_moe_over_one_expert_group_routes_the_global_batch(run2,
                                                           monkeypatch):
    """MoE at ep=1 on fsdp=2: the tokens of the whole global batch route
    together (the reference's GSPMD-global ``ep=1`` branch), gathered from
    both ranks.  The first two losses are within rtol 1e-5 of the JAX
    package's (the gradients: ``test_loss_and_grads_match_jax``), and all
    three within rtol 1e-5 of the port's own unsharded step.  The JAX
    package's third loss differs from both in the third decimal: after
    two Adam steps at lr 1e-2 a few near-zero gradients have stepped
    their weights opposite ways in the two packages (Adam moves a weight
    by about lr * sign(g)), and at those weights layer 0 routes a token
    whose top-2 router probabilities are under 1e-4 apart (checked
    here), so one routing decision can flip; the port's unsharded MoE
    step (``mesh=None``) lands on the same third loss as this mesh."""
    from horovod_tpu_torch.parallel import moe as tmoe
    ranks, ref = run2
    cfg = tllama.LlamaConfig.tiny(**MW.MOE)
    params = tllama.params_from_jax(_jax_params(MW.MOE), "cpu")
    opt = torch.optim.Adam(tllama.trainable(params), lr=MW.LR, eps=1e-8)
    step = tllama.make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(MW.tokens())}
    plain = [step(params, batch).item() for _ in range(MW.STEPS - 1)]
    gaps, real = [], tmoe.switch_route

    def spy(logits, cap):
        top2 = torch.softmax(logits, -1).topk(2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        return real(logits, cap)

    monkeypatch.setattr(tmoe, "switch_route", spy)
    with torch.no_grad():
        tllama.loss_fn(params, batch, cfg)
    monkeypatch.setattr(tmoe, "switch_route", real)
    assert gaps[0] < 1e-4, gaps
    plain.append(step(params, batch).item())
    for _, info in ranks:
        got = info["moe_fsdp2.losses"]
        np.testing.assert_allclose(got[:2], ref["moe_fsdp2"]["losses"][:2],
                                   rtol=1e-5)
        np.testing.assert_allclose(got, plain, rtol=1e-5)


def test_fsdp4_matches_dp4(run4):
    """ZeRO-3 over 4 ranks trains as plain data parallelism over 4 (the
    reference's bar, rtol 1e-4)."""
    ranks, _ = run4
    np.testing.assert_allclose(ranks[0][1]["fsdp4.losses"],
                               ranks[0][1]["dp4.losses"], rtol=1e-4)


def test_replicated_kv_heads_on_tp4_match_unsharded(run4):
    """tp=4 divides the 4 heads but not the 2 kv heads: ``wk/wv`` are
    whole on every rank, K/V expanded before the heads are taken.  The
    losses are within rtol 1e-5 of the port's unsharded step's."""
    ranks, _ = run4
    cfg = tllama.LlamaConfig.tiny()
    assert tllama.shard_rules(cfg, {"tp": 4}) == {"kv_heads": None}
    params = tllama.params_from_jax(_jax_params({}), device="cpu")
    opt = torch.optim.Adam(tllama.trainable(params), lr=MW.LR, eps=1e-8)
    step = tllama.make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(MW.tokens())}
    plain = [step(params, batch).item() for _ in range(MW.STEPS)]
    for _, info in ranks:
        np.testing.assert_allclose(info["tp4.losses"], plain, rtol=1e-5)
    assert ranks[0][0]["tp4.shard.layers.wk"].shape == (2, 64, 2, 16)
    assert ranks[0][0]["tp4.shard.layers.wq"].shape == (2, 64, 1, 16)


def test_init_params_on_a_mesh_draws_the_unsharded_values(run4):
    """``init_params(mesh=)`` keeps each rank's block of exactly what the
    unsharded ``init_params`` draws from the same generator state."""
    ranks, _ = run4
    assert all(info["fsdp2tp2.init_equal"] for _, info in ranks)


@pytest.mark.parametrize("moe", (False, True), ids=("dense", "moe"))
def test_one_rank_mesh_is_bitwise_the_plain_step(moe):
    """Every axis of size 1: ``init_params(mesh=)`` draws bitwise the
    unsharded weights, the mesh step issues no collective and its losses
    over 3 steps are bitwise those of ``mesh=None``."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh
    cfg = tllama.LlamaConfig.tiny(**(MW.MOE if moe else {}))
    batch = {"tokens": torch.from_numpy(MW.tokens())}

    def run(mesh):
        params = tllama.init_params(cfg, torch.Generator().manual_seed(3),
                                    "cpu", mesh=mesh)
        opt = torch.optim.Adam(tllama.trainable(params), lr=MW.LR)
        step = tllama.make_train_step(cfg, opt, mesh=mesh)
        return params, [step(params, batch).item() for _ in range(3)]

    hvd.init(config=hvd.Config(platform="cpu"))
    try:
        mesh = build_mesh(MeshConfig())
        w0 = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                                mesh=mesh)
        w1 = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        for a, b in zip(MW.flat_params(w0).values(),
                        MW.flat_params(w1).values()):
            assert torch.equal(a, b)
        calls = []
        names = ("all_reduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "all_to_all_single",
                 "batch_isend_irecv", "broadcast")
        real = {k: getattr(dist, k) for k in names}
        for k in names:
            setattr(dist, k, lambda *a, _k=k, **kw: calls.append(_k)
                    or real[_k](*a, **kw))
        try:
            _, meshed = run(mesh)
        finally:
            for k, f in real.items():
                setattr(dist, k, f)
        _, plain = run(None)
    finally:
        hvd.shutdown()
    assert calls == []
    assert meshed == plain


class _Rank0Mesh:
    """Rank 0's view of a mesh of these axis sizes."""

    def __init__(self, **sizes):
        self.mesh_dim_names = ("pp", "dp", "fsdp", "ep", "sp", "tp")
        self.shape = tuple(sizes.get(a, 1) for a in self.mesh_dim_names)

    def get_coordinate(self):
        return [0] * 6


def test_unsplittable_batch_and_sequence_raise():
    cfg = tllama.LlamaConfig.tiny()
    plan = tllama._Plan(cfg, _Rank0Mesh(dp=3))
    with pytest.raises(ValueError, match="dp\\*fsdp\\*ep = 3"):
        plan.local_batch(torch.zeros(4, 8))
    with pytest.raises(ValueError, match="sp=2 must divide"):
        tllama._Plan(cfg, _Rank0Mesh(sp=2)).local_batch(torch.zeros(1, 7))


def test_rules_and_specs_are_the_references():
    """``param_logical_dims`` entry for entry, and every parameter's
    spec under ``shard_rules`` as the reference's ``PartitionSpec``s, on
    the meshes of this file."""
    for edits in ({}, MW.MOE):
        tcfg, jcfg = tllama.LlamaConfig.tiny(**edits), _jcfg(edits)
        assert tllama.param_logical_dims(tcfg) == \
            jllama.param_logical_dims(jcfg)
        for meshes in MW.MESHES.values():
            for sizes, _, _ in meshes.values():
                n = int(np.prod(list(sizes.values())))
                jm = _jmesh(sizes, n)
                assert tllama.shard_rules(tcfg, sizes) == \
                    jllama.shard_rules(jcfg, jm)
                js = MW.flat_params(jax.tree.map(
                    lambda s: tuple(s.spec), jllama.param_shardings(jcfg, jm),
                    is_leaf=lambda x: isinstance(x, NamedSharding)))
                ts = MW.flat_params(tllama.param_shardings(tcfg, sizes))
                assert ts == js, sizes


def test_blockwise_loss_only_without_tp_sp_pp():
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), blockwise_ce=True)
    for sizes, want in (({"dp": 2, "fsdp": 2}, True), ({"tp": 2}, False),
                        ({"sp": 2}, False), ({"pp": 2}, False), (None, True)):
        assert tllama._use_blockwise_ce(cfg, sizes) is want
        assert jllama._use_blockwise_ce(
            _jcfg(dict(blockwise_ce=True)),
            None if sizes is None else _jmesh(
                sizes, int(np.prod(list(sizes.values()))))) is want

"""Port parity: the Llama trained on pipelined meshes (``pp > 1``) by
``horovod_tpu_torch/models/llama.py``'s ``make_train_step(mesh=,
pipeline_schedule=)``, against the JAX package's ``make_train_step(cfg,
mesh, tx, pipeline_schedule=)`` on a mesh of the same shape.

The port runs at np=2 and np=4 on the CPU over Gloo under the port's
launcher (``tests/mp_torch_mesh_worker.py``, mode ``llama_pp``: one job a
world size, every mesh of ``PP_MESHES`` under both schedules in it), from
the JAX package's full parameters turned into each rank's blocks by
``shard_params``.  The JAX package runs in this process over the first n
of the conftest's 8 CPU devices while the port's job runs.  Config:
``LlamaConfig.tiny()`` (2 layers; 4 on pp=4), B=8, S=32, Adam at lr 1e-2,
3 steps; the MoE case with 4 experts at capacity factor 2.0.

Bars: losses within rtol 1e-5 of the JAX package's on the same mesh and
schedule; the first step's gradients (every rank's block, after every
reduction) within ``GRAD_REL`` of the JAX package's GPipe gradients on
the same mesh, normwise per leaf (max |port - jax| over max |jax|).  Not
its 1F1B gradients: on a mesh with tp = 2 those are twice its GPipe and
its unsharded (``mesh=None``) gradients, every leaf, which its losses do
not show (Adam's step is nearly invariant to the gradient's scale); the
port's 1F1B gives the GPipe gradients (ROADMAP section C).  1F1B's
losses within rtol 1e-5 of GPipe's and its gradients within
``GRAD_REL``; at most 2(pp - 1) saved inputs a stage; the stage blocks
bitwise the JAX arrays' shards; the one-process driver (every stage in
this process) bitwise the np=2 job.
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

# Normwise gradient bar: the port sums each gradient over the ranks in
# another order than XLA (Gloo's all-reduce, the fp32 accumulation of the
# ticks); the largest gap measured over these meshes is below 1e-6.
GRAD_REL = 1e-5
CASES = {name: n for n, meshes in MW.PP_MESHES.items() for name in meshes}
AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")


def _jmesh(sizes, n):
    return jbuild_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def _jax_params_cached(edits: tuple):
    return jax.tree.map(np.asarray, jllama.init_params(
        jllama.LlamaConfig.tiny(**dict(edits)), jax.random.PRNGKey(0),
        _jmesh({}, 1)))


def _jax_params(edits):
    return _jax_params_cached(tuple(sorted(edits.items())))


def _keep_grads():
    """An optax transformation that passes the updates on unchanged and
    keeps them as its state: chained ahead of Adam, the JAX step's
    gradients after every reduction it makes, read after the first
    step."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def _jax_cases(n, batch) -> dict:
    """The JAX package's losses on every pp mesh of world size n under
    both schedules, its GPipe gradients and its at-rest blocks.  The
    programs compile in threads and run one after another."""
    from concurrent.futures import ThreadPoolExecutor
    devs = list(jax.devices()[:n])
    todo = []
    out: dict = {}
    for name, (sizes, edits, extra) in MW.PP_MESHES[n].items():
        cfg, mesh = jllama.LlamaConfig.tiny(**edits), _jmesh(sizes, n)
        params = jllama.init_params(cfg, jax.random.PRNGKey(0), mesh)
        jb = jax.device_put(batch, NamedSharding(mesh, P(("dp", "fsdp"))))
        out[name] = {}
        if "shards" in extra:
            out[name]["shards"] = {
                (key, devs.index(sh.device)): np.asarray(sh.data)
                for key, leaf in MW.flat_params(params).items()
                for sh in leaf.addressable_shards}
        for sched, tx in (("1f1b", optax.adam(MW.LR)),
                          ("gpipe", optax.chain(_keep_grads(),
                                                optax.adam(MW.LR)))):
            mine = jax.tree.map(jnp.copy, params)   # the step donates it
            todo.append(dict(name=name, sched=sched, tx=tx, cfg=cfg,
                             mesh=mesh, params=mine, jb=jb,
                             state=jax.jit(tx.init)(mine)))

    def compile_(t):
        t["step"] = jllama.make_train_step(
            t["cfg"], t["mesh"], t["tx"],
            pipeline_schedule=t["sched"]).lower(
                t["params"], t["state"], t["jb"]).compile()

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(compile_, todo))
    for t in todo:
        params, state = t["params"], t["state"]
        losses = []
        for _ in range(MW.STEPS):
            params, state, loss = t["step"](params, state, t["jb"])
            losses.append(float(loss))
            if t["sched"] == "gpipe" and "grads" not in out[t["name"]]:
                out[t["name"]]["grads"] = MW.flat_params(
                    jax.tree.map(np.asarray, state[0]))
        out[t["name"]][f"{t['sched']}.losses"] = losses
    return out


def _run(n, tmp_path_factory) -> tuple:
    outdir = str(tmp_path_factory.mktemp(f"pp{n}"))
    for kind, edits in (("dense", {}), ("dense4", dict(n_layers=4)),
                        ("moe", MW.MOE)):
        np.savez(os.path.join(outdir, f"params.{kind}.npz"),
                 **MW.flat_params(_jax_params(edits)))
    box = {}
    job = threading.Thread(target=lambda: box.setdefault(
        "res", MW.launch("llama_pp", outdir, n, timeout=400)))
    job.start()
    ref = _jax_cases(n, {"tokens": jnp.asarray(MW.tokens())})
    job.join()
    import mp_torch_dataplane_worker as DW
    DW.check_ranks(box["res"])
    return MW.load("llama_pp", outdir, n), ref


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    return _run(4, tmp_path_factory)


def _case(request, name):
    return request.getfixturevalue(f"run{CASES[name]}")


def _normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


def _coord(r, sizes):
    full = [sizes.get(a, 1) for a in AXES]
    return dict(zip(AXES, (int(c) for c in np.unravel_index(r, full))))


@pytest.mark.parametrize("n", (2, 4))
def test_ranks_import_no_jax(request, n):
    ranks, _ = request.getfixturevalue(f"run{n}")
    assert len(ranks) == n
    assert not any(info["jax_loaded"] for _, info in ranks)


@pytest.mark.parametrize("sched", MW.SCHEDULES)
@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax(request, name, sched):
    """Three Adam steps under the schedule: every rank reports the global
    loss, within rtol 1e-5 of the JAX package's on the same mesh and
    schedule, and the loss falls."""
    ranks, ref = _case(request, name)
    for _, info in ranks:
        np.testing.assert_allclose(info[f"{name}.{sched}.losses"],
                                   ref[name][f"{sched}.losses"], rtol=1e-5)
    losses = ranks[0][1][f"{name}.{sched}.losses"]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("sched", MW.SCHEDULES)
@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_jax(request, name, sched):
    """The first step's gradients, each rank's block of every leaf after
    every reduction, within ``GRAD_REL`` (normwise) of the JAX package's
    GPipe gradients' block on the same mesh: both schedules compute the
    gradient of one global loss."""
    from horovod_tpu_torch.parallel import sharding as shd
    ranks, ref = _case(request, name)
    sizes, edits, _ = MW.PP_MESHES[CASES[name]][name]
    specs = MW.flat_params(tllama.param_shardings(
        tllama.LlamaConfig.tiny(**edits), sizes))
    full = {a: sizes.get(a, 1) for a in AXES}
    for r, (arrays, _) in enumerate(ranks):
        coord = _coord(r, sizes)
        for key, g in ref[name]["grads"].items():
            want = shd.block(g, specs[key], full, coord)
            got = arrays[f"{name}.{sched}.grad.{key}"]
            assert got.shape == want.shape, (r, key)
            assert _normwise(got, want) <= GRAD_REL, (r, key,
                                                      _normwise(got, want))


@pytest.mark.parametrize("name", list(CASES))
def test_1f1b_equals_gpipe(request, name):
    """The explicit-gradient 1F1B step and autograd through the GPipe
    forward give the same trajectory (the reference's
    ``test_pp_moe_1f1b_matches_gpipe``): losses within rtol 1e-5,
    first gradients within ``GRAD_REL``."""
    ranks, _ = _case(request, name)
    for arrays, info in ranks:
        np.testing.assert_allclose(info[f"{name}.1f1b.losses"],
                                   info[f"{name}.gpipe.losses"], rtol=1e-5)
        for key in [k for k in arrays if k.startswith(f"{name}.1f1b.grad.")]:
            other = arrays[key.replace(".1f1b.", ".gpipe.")]
            assert _normwise(arrays[key], other) <= GRAD_REL, key


@pytest.mark.parametrize("name", [n for c in MW.PP_MESHES.values()
                                  for n, v in c.items() if "saved" in v[2]])
def test_1f1b_holds_at_most_2_pp_minus_1_inputs(request, name):
    """A 1F1B stage's ring never holds more than 2(pp - 1) microbatch
    inputs (the reference's ``pipeline_train_local`` ring of K slots),
    whatever M is (M = 4 here, pp = 2: 2 a stage; pp = 4: 6 slots); the
    last stage holds none."""
    ranks, _ = _case(request, name)
    sizes = MW.PP_MESHES[CASES[name]][name][0]
    pp = sizes["pp"]
    for r, (_, info) in enumerate(ranks):
        held = info[f"{name}.1f1b.max_saved"]
        if _coord(r, sizes)["pp"] == pp - 1:
            assert held == 0         # its backward runs in its forward's tick
        else:
            assert 1 <= held <= 2 * (pp - 1)
        assert info[f"{name}.gpipe.max_saved"] == 0


def test_pp_microbatches_is_honoured_and_checked(run2):
    """``cfg.pp_microbatches`` sets M (8 here, where the auto count is
    4, the reference's most M <= 2 pp dividing the local batch), gives
    the losses of the auto count within 1e-4 (the reference's bar), and
    a count that does not divide the local batch raises the reference's
    ValueError."""
    ranks, _ = run2
    for _, info in ranks:
        assert info["pp2.1f1b.microbatches"] == 4
        assert info["pp2.1f1b.m8.microbatches"] == MW.PP_MICRO
        np.testing.assert_allclose(info["pp2.1f1b.m8.losses"],
                                   info["pp2.1f1b.losses"], rtol=1e-4)
        assert "pp_microbatches=3 must divide the local batch 8" in \
            info["pp2.bad_micro"]


@pytest.mark.parametrize("batch,sizes,req", [
    (8, dict(pp=2), None), (8, dict(pp=2, dp=2), None), (6, dict(pp=4), None),
    (8, dict(pp=2, ep=2, dp=2), None), (8, dict(pp=2), 8), (3, dict(pp=2), 1),
])
def test_pick_microbatches_is_the_references(batch, sizes, req):
    n = int(np.prod(list(sizes.values())))
    assert tllama._pick_microbatches(batch, sizes, req) == \
        jllama._pick_microbatches(batch, _jmesh(sizes, n), req)


@pytest.mark.parametrize("name", [n for c in MW.PP_MESHES.values()
                                  for n, v in c.items() if "shards" in v[2]])
def test_stage_blocks_are_the_jax_arrays_shards(request, name):
    """``shard_params`` of the JAX package's full weights gives each rank
    of a pp mesh bitwise its stage's block of the JAX arrays: the block
    ``init_params(mesh=)`` puts on the device of the same coordinate."""
    ranks, ref = _case(request, name)
    for r, (arrays, _) in enumerate(ranks):
        for (key, dev), want in ref[name]["shards"].items():
            if dev != r:
                continue
            got = arrays[f"{name}.shard.{key}"]
            assert got.shape == want.shape, (r, key)
            np.testing.assert_array_equal(got, want, err_msg=f"{r} {key}")


@pytest.mark.parametrize("sched", ("1f1b", "1f1b.m8"))
def test_one_process_driver_is_bitwise_the_np2_job(run2, sched):
    """``make_pipeline_step_local`` runs both stages of the 1F1B schedule
    in this process with the handoffs in memory, at the auto M (4) and
    at ``pp_microbatches=8``: its losses and first gradients are bitwise
    the np=2 job's (each rank's stage)."""
    ranks, _ = run2
    cfg = tllama.LlamaConfig.tiny()
    if sched.endswith(".m8"):
        cfg = dataclasses.replace(cfg, pp_microbatches=MW.PP_MICRO)
    params = tllama.params_from_jax(_jax_params({}), "cpu")
    opt = MW._Recording(torch.optim.Adam(tllama.trainable(params),
                                         lr=MW.LR, eps=1e-8), params)
    step = tllama.make_pipeline_step_local(cfg, opt, 2)
    batch = {"tokens": torch.from_numpy(MW.tokens())}
    losses = [step(params, batch).item() for _ in range(MW.STEPS)]
    for r, (arrays, info) in enumerate(ranks):
        assert losses == info[f"pp2.{sched}.losses"]
        for key, g in opt.grads.items():
            got = arrays[f"pp2.{sched}.grad.{key}"]
            want = g[r:r + 1] if key.startswith("layers.") else g
            np.testing.assert_array_equal(got, want, err_msg=key)


class _StageMesh:
    """Stage ``s``'s view of a mesh with pp = 2, every other axis 1."""
    mesh_dim_names = AXES
    shape = (2, 1, 1, 1, 1, 1)

    def __init__(self, s):
        self.s = s

    def get_coordinate(self):
        return [self.s, 0, 0, 0, 0, 0]


def test_init_params_on_pp_draws_the_stage_blocks():
    """``init_params(mesh=)`` on a pp mesh keeps, on each stage, exactly
    its layers of the unsharded draw from the same generator state."""
    cfg = tllama.LlamaConfig.tiny(n_layers=4)
    whole = tllama.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    for s in range(2):
        got = tllama.init_params(cfg, torch.Generator().manual_seed(5),
                                 "cpu", mesh=_StageMesh(s))
        for k, v in got["layers"].items():
            assert torch.equal(v, whole["layers"][k][2 * s:2 * s + 2]), k
        for k in ("embed", "final_norm", "lm_head"):
            assert torch.equal(got[k], whole[k])

"""Multi-process worker of the port's sharding and mesh-training tests.

``launch(mode, outdir, np_)`` runs ``np_`` copies of this script, one rank
each, through the port's launcher on the CPU over Gloo (the machinery of
``tests/mp_torch_port_worker.py``).  Every rank runs the battery of
``mode`` and writes what it got to ``outdir/<mode>.rank<r>.npz`` and
``.json``:

- ``sharding`` (``tests/test_torch_sharding.py``): a rank's blocks and
  their gather, ``constrain``, the gradient of every collective of
  ``parallel/comm.py`` against the unsharded computation, ring and
  Ulysses attention, ``matmul_reducescatter`` and the root's per-rank
  helpers;
- ``llama`` (``tests/test_torch_llama_mesh.py``): the tiny Llama trained
  on every mesh of :data:`MESHES` for this world size, from the JAX
  package's full parameters (``outdir/params.npz``, written by the test,
  since a rank never imports jax).

The inputs are made with numpy from fixed seeds by the functions below,
which the tests import to build the same inputs for the JAX side.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

import mp_torch_port_worker as W

ENV = {"OMP_NUM_THREADS": "1"}


def launch(mode: str, outdir: str, np_: int, timeout: float = 240) -> list:
    return W.launch(mode, outdir, np_=np_, timeout=timeout, extra_env=ENV,
                    script=__file__)


def load(mode: str, outdir, np_: int) -> list:
    """Each rank's (arrays, info) of a finished battery."""
    ranks = []
    for r in range(np_):
        with np.load(os.path.join(outdir, f"{mode}.rank{r}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(outdir, f"{mode}.rank{r}.json")) as f:
            ranks.append((arrays, json.load(f)))
    return ranks


class PipelineMesh:
    """A mesh with ``pp = 2`` (every other axis 1), as a ``DeviceMesh``
    shows its axes: what the refusal tests hand the model."""
    mesh_dim_names = ("pp", "dp", "fsdp", "ep", "sp", "tp")
    shape = (2, 1, 1, 1, 1, 1)


# ---------------------------------------------------------------------------
# inputs (shared with the tests)
# ---------------------------------------------------------------------------

LR = 1e-2
STEPS = 3
BATCH, SEQ = 8, 32
MOE = dict(use_moe=True, n_experts=4, capacity_factor=2.0)

# name -> (mesh sizes, config edits, what else the rank records)
MESHES = {
    2: {
        "fsdp2": (dict(fsdp=2), {}, ("shards", "state")),
        "tp2": (dict(tp=2), {}, ("shards", "state")),
        "sp2_ring": (dict(sp=2), dict(sp_attention="ring"), ()),
        "sp2_ulysses": (dict(sp=2), dict(sp_attention="ulysses"), ()),
        "fsdp2_blockwise": (dict(fsdp=2), dict(blockwise_ce=True), ()),
        "moe_fsdp2": (dict(fsdp=2), MOE, ("state", "grads")),
    },
    4: {
        "dp2tp2": (dict(dp=2, tp=2), {}, ("grads",)),
        "fsdp2tp2": (dict(fsdp=2, tp=2), {}, ("shards", "state", "init")),
        "dp2sp2": (dict(dp=2, sp=2), {}, ()),
        "sp2tp2": (dict(sp=2, tp=2), {}, ("grads",)),
        "tp4": (dict(tp=4), {}, ("shards",)),
        "fsdp4": (dict(fsdp=4), {}, ("shards", "state")),
        "dp4": (dict(dp=4), {}, ()),
        "moe_ep2tp2": (dict(ep=2, tp=2), MOE, ("shards", "state")),
        "moe_ep2sp2": (dict(ep=2, sp=2), MOE, ()),
    },
}


def tokens() -> np.ndarray:
    return np.random.RandomState(0).randint(
        0, 256, size=(BATCH, SEQ + 1)).astype(np.int32)


def flat_params(tree, prefix: str = "") -> dict:
    """A parameter tree as ``{"layers.wq": array, ...}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def nest_params(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


ATTN = dict(B=2, S=16, H=4, D=8)


def attn_inputs() -> tuple:
    """Global q, k, v ``[B, S, H, D]`` and the output cotangent."""
    rng = np.random.RandomState(7)
    shape = (ATTN["B"], ATTN["S"], ATTN["H"], ATTN["D"])
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(4))


def mrs_inputs(n: int) -> tuple:
    """``tests/test_sched.py::test_matmul_reducescatter_parity``'s rows:
    per-rank x ``[4, 32]``, per-rank w ``[32, 64]`` and ``[32, 60]``."""
    rng = np.random.RandomState(13)
    xs = rng.randn(n, 4, 32).astype(np.float32)
    w = rng.randn(n, 32, 64).astype(np.float32)
    w_odd = rng.randn(n, 32, 60).astype(np.float32)
    return xs, w, w_odd


def comm_inputs(n: int) -> dict:
    rng = np.random.RandomState(11)
    return {"x": rng.randn(6, 8).astype(np.float32),
            "w1": rng.randn(8, 4 * n).astype(np.float32),
            "w2": rng.randn(4 * n, 8).astype(np.float32),
            "data": rng.randn(n, 3, 8).astype(np.float32),
            "wrows": rng.randn(4 * n, 5).astype(np.float32),
            "c": rng.randn(n, 6, 8).astype(np.float32),
            "a2a": rng.randn(n, n, 3).astype(np.float32),
            "a2a_c": rng.randn(n, n, 3).astype(np.float32)}


def helper_values(n: int) -> list:
    return [np.arange(6, dtype=np.float32).reshape(2, 3) * (i + 1)
            for i in range(n)]


SHARD_SPECS = {
    "rows": (("tp", "fsdp"), None),
    "cols": (None, ("fsdp", "tp")),
    "both": ("fsdp", "tp"),
}


def shard_input() -> np.ndarray:
    return np.arange(16 * 8, dtype=np.float32).reshape(16, 8)


# ---------------------------------------------------------------------------
# batteries
# ---------------------------------------------------------------------------

def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_sharding(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.ops.sched import matmul_reducescatter
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh, comm
    from horovod_tpu_torch.parallel import ring_attention as RA
    from horovod_tpu_torch.parallel import sharding as shd

    # blocks, their gather and constrain on fsdp x tp
    grid = MeshConfig(fsdp=2, tp=n // 2)
    mesh = build_mesh(grid)
    info["coord"] = shd.coordinate(mesh)
    x = _t(shard_input())
    for name, spec in SHARD_SPECS.items():
        blk = shd.shard(x, spec, mesh)
        arrays[f"shard.{name}"] = _np(blk)
        arrays[f"unshard.{name}"] = _np(shd.unshard(blk, spec, mesh))
    xr = x.clone().requires_grad_()
    y = shd.constrain(xr, ("vocab_rows", None), mesh)
    arrays["constrain"] = _np(y)
    y.sum().backward()
    arrays["constrain.grad"] = _np(xr.grad)
    back = shd.constrain(y, (None, None), mesh,
                         current=("vocab_rows", None))
    arrays["constrain.back"] = _np(back)
    one = build_mesh(MeshConfig(dp=n))
    z = shd.constrain(x, ("embed", "mlp"), one)        # fsdp, tp of size 1
    info["constrain_noop"] = z is x
    groups = {k: sorted(dist.get_process_group_ranks(g))
              for k, g in mesh.hvd_axis_groups.items()}
    info["axis_groups"] = {"+".join(k): v for k, v in groups.items()}

    # the collectives' gradients, each over the flat axis of `one`
    c = comm_inputs(n)
    ax = ("dp",)
    # tp MLP: copy_to before the column-parallel product, reduce_from after
    xx = _t(c["x"]).requires_grad_()
    w1 = _t(c["w1"][:, me * 4:(me + 1) * 4]).requires_grad_()
    w2 = _t(c["w2"][me * 4:(me + 1) * 4]).requires_grad_()
    out = comm.reduce_from(torch.relu(comm.copy_to(xx, one, ax) @ w1) @ w2,
                           one, ax)
    (out * _t(c["c"][0])).sum().backward()
    arrays["tp.out"], arrays["tp.dx"] = _np(out), _np(xx.grad)
    arrays["tp.dw1"], arrays["tp.dw2"] = _np(w1.grad), _np(w2.grad)
    # ZeRO-3: rows of w gathered for ranks with different data
    wr = _t(c["wrows"][me * 4:(me + 1) * 4]).requires_grad_()
    full = comm.all_gather(wr, one, ax, 0)
    (_t(c["data"][me]) @ full[:8]).sum().backward()
    arrays["ag.dw"] = _np(wr.grad)
    # scatter: a replicated tensor split, the loss summed back
    xs = _t(c["x"]).requires_grad_()
    part = comm.scatter(xs, one, ax, 1)
    loss = comm.reduce_from((part ** 2 * _t(c["c"][me][:, me * (8 // n):
                                                    (me + 1) * (8 // n)]))
                            .sum(), one, ax)
    loss.backward()
    arrays["scatter.dx"], info["scatter.loss"] = _np(xs.grad), loss.item()
    # all_to_all: block i of dim 0 to rank i
    blocks = _t(c["a2a"][me]).requires_grad_()
    got = comm.all_to_all(blocks, one, ax)
    (got * _t(c["a2a_c"][me])).sum().backward()
    arrays["a2a.out"], arrays["a2a.dx"] = _np(got), _np(blocks.grad)

    # ring and Ulysses over the sp group: outputs and q/k/v gradients
    spm = build_mesh(MeshConfig(sp=n))
    group, _ = comm.group_of(spm, ("sp",))
    q, k, v, cot = attn_inputs()
    L = ATTN["S"] // n
    for mode in ("ring", "ulysses"):
        for causal in (True, False):
            loc = [_t(t[:, me * L:(me + 1) * L]).requires_grad_()
                   for t in (q, k, v)]
            fn = RA.sp_local_attention(mode)
            o = fn(*loc, group=group, causal=causal)
            (o * _t(cot[:, me * L:(me + 1) * L])).sum().backward()
            tag = f"{mode}.{'causal' if causal else 'full'}"
            arrays[f"{tag}.out"] = _np(o)
            for nm, t in zip("qkv", loc):
                arrays[f"{tag}.d{nm}"] = _np(t.grad)
    whole = RA.ring_self_attention(_t(q), _t(k), _t(v), spm)
    arrays["ring_self"] = _np(whole)

    # matmul_reducescatter over the world
    xs_, w_, w_odd = mrs_inputs(n)
    mono = _t(xs_[me]) @ _t(w_[me])
    dist.all_reduce(mono)
    arrays["mrs.mono"] = _np(mono)
    arrays["mrs.fused"] = _np(matmul_reducescatter(_t(xs_[me]), _t(w_[me]),
                                                   None, chunks=2))
    arrays["mrs.odd"] = _np(matmul_reducescatter(_t(xs_[me]), _t(w_odd[me]),
                                                 None, chunks=7))

    # the root's per-rank helpers
    vals = helper_values(n)
    arrays["per_rank"] = _np(hvd.per_rank(vals))
    arrays["per_rank_from_fn"] = _np(hvd.per_rank_from_fn(
        lambda i: vals[i] + 1))
    arrays["from_local"] = _np(hvd.from_local(vals[me][None]))
    arrays["replicate_local"] = _np(hvd.replicate_local(vals[0]))
    arrays["to_local"] = hvd.to_local(hvd.per_rank(vals))
    arrays["to_numpy"] = hvd.to_numpy(hvd.allreduce(hvd.per_rank(vals),
                                                    op=hvd.Sum))
    for tag, bad in (("count", vals[:-1]),
                     ("shapes", vals[:-1] + [np.zeros(3, np.float32)])):
        try:
            hvd.per_rank(bad)
        except ValueError as e:
            info[f"per_rank.{tag}"] = str(e)
    flat = hvd.mesh()
    info["mesh"] = {"names": list(flat.mesh_dim_names),
                    "shape": list(flat.mesh.shape),
                    "ranks": dist.get_process_group_ranks(flat.get_group())}


def _restack(params, grads: bool = False) -> dict:
    """A copy of each leaf (or its gradient) as numpy, layer leaves
    restacked."""
    import torch
    out = {}
    for k, stack in params["layers"].items():
        out[f"layers.{k}"] = _np(torch.stack(
            [leaf.grad for leaf in stack._layer_leaves]) if grads else stack)
    for k in ("embed", "final_norm", "lm_head"):
        out[k] = _np(params[k].grad if grads else params[k])
    return {k: v.copy() for k, v in out.items()}


def run_llama(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    import torch

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh

    outdir = os.environ["MESH_OUT"]
    full = {}
    for kind in ("dense", "moe"):
        with np.load(os.path.join(outdir, f"params.{kind}.npz")) as z:
            full[kind] = nest_params({k: z[k] for k in z.files})
    batch = {"tokens": _t(tokens())}
    for name, (sizes, edits, extra) in MESHES[n].items():
        mesh = build_mesh(MeshConfig(**sizes))
        cfg = llama.LlamaConfig.tiny(**edits)
        kind = "moe" if cfg.use_moe else "dense"
        params = llama.shard_params(full[kind], cfg, mesh, device="cpu")
        if "shards" in extra:
            for k, a in _restack(params).items():
                arrays[f"{name}.shard.{k}"] = a
        if "init" in extra:
            gen = torch.Generator().manual_seed(5)
            mine = llama.init_params(cfg, gen, "cpu", mesh=mesh)
            whole = llama.init_params(cfg, torch.Generator().manual_seed(5),
                                      "cpu")
            specs = llama.param_shardings(cfg, mesh)
            info[f"{name}.init_equal"] = all(
                torch.equal(mine["layers"][k], _block(
                    whole["layers"][k], specs["layers"][k], mesh))
                for k in mine["layers"]) and all(
                torch.equal(mine[k], _block(whole[k], specs[k], mesh))
                for k in ("embed", "final_norm", "lm_head"))
        if "grads" in extra:
            gparams = llama.shard_params(full[kind], cfg, mesh, device="cpu")
            llama.trainable(gparams)
            loss = llama.loss_fn(gparams, batch, cfg, mesh=mesh)
            loss.backward()
            llama.reduce_gradients(gparams, cfg, mesh)
            info[f"{name}.grad_loss"] = loss.item()
            for k, a in _restack(gparams, grads=True).items():
                arrays[f"{name}.grad.{k}"] = a
        opt = torch.optim.Adam(llama.trainable(params), lr=LR, eps=1e-8)
        step = llama.make_train_step(cfg, opt, mesh=mesh)
        info[f"{name}.losses"] = [step(params, batch).item()
                                  for _ in range(STEPS)]
        if "state" in extra:
            info[f"{name}.state"] = [
                [p.numel(), opt.state[p]["exp_avg"].numel(),
                 opt.state[p]["exp_avg_sq"].numel()]
                for p in llama.trainable(params)]


def _block(full, spec, mesh):
    from horovod_tpu_torch.parallel import sharding as shd
    return shd.block(full, spec, shd.axis_sizes(mesh), shd.coordinate(mesh))


BATTERIES = {"sharding": run_sharding, "llama": run_llama}


def main(mode: str, outdir: str) -> int:
    sys.path.insert(0, W.REPO)
    import horovod_tpu_torch as hvd
    os.environ["MESH_OUT"] = outdir
    hvd.init()
    me, n = hvd.rank(), hvd.size()
    arrays: dict = {}
    info: dict = {}
    BATTERIES[mode](hvd, me, n, arrays, info)
    info["jax_loaded"] = any(
        m == "jax" or m.startswith(("jax.", "jaxlib"))
        or m.split(".")[0] == "horovod_tpu" for m in list(sys.modules))
    np.savez(os.path.join(outdir, f"{mode}.rank{me}.npz"), **arrays)
    with open(os.path.join(outdir, f"{mode}.rank{me}.json"), "w") as f:
        json.dump(info, f)
    hvd.shutdown()
    print(f"rank {me}: {mode} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))

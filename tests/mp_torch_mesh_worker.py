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
  since a rank never imports jax);
- ``pipeline`` (``tests/test_torch_pipeline.py``): the GPipe and 1F1B
  schedules of ``parallel/pipeline.py`` on a toy stage over the ``pp``
  group of the whole world;
- ``llama_pp`` (``tests/test_torch_llama_pp.py``): the tiny Llama trained
  on every pipelined mesh of :data:`PP_MESHES` for this world size under
  both schedules, its first gradients and three losses;
- ``generate`` (``tests/test_torch_generate.py``) and ``serving``
  (``tests/test_torch_serving.py``): ``generate(mesh=)`` and the serving
  engine on the meshes of :data:`GEN_MESHES` and :data:`SERVE_MESHES`.

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
    """Stage 0's view of a mesh with ``pp = 2`` (every other axis 1), as
    a ``DeviceMesh`` shows its axes and coordinate: what the refusal tests
    hand the model (each refusal comes before any collective)."""
    mesh_dim_names = ("pp", "dp", "fsdp", "ep", "sp", "tp")
    shape = (2, 1, 1, 1, 1, 1)

    def get_coordinate(self):
        return [0] * 6


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


# name -> (mesh sizes, config edits, what else the rank records); every
# mesh runs under both schedules
PP_MESHES = {
    2: {
        "pp2": (dict(pp=2), {}, ("shards", "saved", "micro")),
    },
    4: {
        "pp2tp2": (dict(pp=2, tp=2), {}, ("shards",)),
        "pp2dp2": (dict(pp=2, dp=2), {}, ()),
        "pp2fsdp2": (dict(pp=2, fsdp=2), {}, ("shards",)),
        "pp2sp2_ring": (dict(pp=2, sp=2), dict(sp_attention="ring"), ()),
        "pp2sp2_ulysses": (dict(pp=2, sp=2), dict(sp_attention="ulysses"),
                           ()),
        "pp4": (dict(pp=4), dict(n_layers=4), ("saved",)),
        "moe_pp2ep2": (dict(pp=2, ep=2), MOE, ()),
    },
}
SCHEDULES = ("1f1b", "gpipe")
PP_MICRO = 8           # the "micro" case's cfg.pp_microbatches (auto: 4)


def params_kind(edits: dict) -> str:
    """The file of full weights a config's mesh runs from."""
    if edits.get("use_moe"):
        return "moe"
    return "dense4" if edits.get("n_layers") == 4 else "dense"


PIPE = dict(M=8, mb=2, d=4)


def pipe_inputs(n: int) -> tuple:
    """``tests/test_parallel.py``'s 1F1B oracle inputs for n stages:
    stage weights ``[n, d, d]``, the head's bias, microbatches and
    targets ``[M, mb, d]``."""
    rng = np.random.RandomState(7)
    M, mb, d = PIPE["M"], PIPE["mb"], PIPE["d"]
    ws = (rng.randn(n, d, d) * 0.3).astype(np.float32)
    bias = rng.randn(d).astype(np.float32)
    mbs = rng.randn(M, mb, d).astype(np.float32)
    tgts = rng.randn(M, mb, d).astype(np.float32)
    return ws, bias, mbs, tgts


AUX_W = 0.5


def toy_stage(torch, w, with_aux: bool):
    """Stage ``x -> tanh(x @ w)``, its aux ``mean(y ** 2)``."""
    def fn(x):
        y = torch.tanh(x @ w)
        return (y, (y * y).mean()) if with_aux else y
    return fn


GEN_MESHES = {2: {"tp2": dict(tp=2), "dp2": dict(dp=2), "pp2": dict(pp=2)},
              4: {"pp2tp2": dict(pp=2, tp=2), "pp2dp2": dict(pp=2, dp=2)}}
GEN = dict(B=4, P=5, new=4, seed=21, temperature=0.7)
SERVE_MESHES = {"dp2": dict(dp=2), "tp2": dict(tp=2)}
SERVE = dict(block_size=8, num_blocks=32, max_active=4, new=5)


def gen_prompt() -> np.ndarray:
    return np.random.RandomState(6).randint(
        0, 256, size=(GEN["B"], GEN["P"])).astype(np.int32)


def serve_prompts() -> list:
    """Six requests; the last three share an 8-token head with the first
    (one full block: the prefix cache's hits)."""
    rng = np.random.RandomState(8)
    out = [rng.randint(0, 256, size=(n,)).astype(np.int32)
           for n in (9, 5, 12)]
    out += [np.concatenate([out[0][:8], rng.randint(0, 256, size=(n,))])
            .astype(np.int32) for n in (3, 6, 1)]
    return out


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


def run_pipeline(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    import torch

    from horovod_tpu_torch.parallel import MeshConfig, build_mesh
    from horovod_tpu_torch.parallel import pipeline as PL

    mesh = build_mesh(MeshConfig(pp=n))
    group = mesh.get_group("pp")
    ws, bias, mbs, tgts = (_t(a) for a in pipe_inputs(n))
    arrays["apply"] = _np(PL.pipeline_apply(
        lambda w, x: torch.tanh(x @ w), ws, mbs, mesh))
    seen = []
    real_tick = PL.OneFOneBStage.tick

    def counting_tick(self, *a):
        out = real_tick(self, *a)
        seen.append(self.saved_inputs())
        return out

    PL.OneFOneBStage.tick = counting_tick
    for aux in (False, True):
        tag = "aux" if aux else "plain"
        w = ws[me].clone().requires_grad_()
        hp = bias.clone().requires_grad_()
        seen.clear()
        res = PL.pipeline_train_local(
            toy_stage(torch, w, True) if aux else
            (lambda x, w=w: (torch.tanh(x @ w), torch.zeros(()))), [w], mbs,
            lambda y, m: ((y + hp - tgts[m]) ** 2).mean(), [hp],
            group=group, aux_weight=AUX_W if aux else 0.0)
        loss, a, dmbs, (dw,), (dh,) = res
        info[f"1f1b.{tag}.loss"] = loss.item()
        info[f"1f1b.{tag}.aux"] = a.item()
        info[f"1f1b.{tag}.max_saved"] = max(seen)
        arrays[f"1f1b.{tag}.dw"] = _np(dw)
        arrays[f"1f1b.{tag}.dh"] = _np(dh)
        arrays[f"1f1b.{tag}.dmbs"] = _np(dmbs)
        # GPipe under autograd: the same loss through the fill-drain
        # forward and the handoffs' backward
        w = ws[me].clone().requires_grad_()
        hp = bias.clone().requires_grad_()
        xs = mbs.clone().requires_grad_()
        out = PL.pipeline_apply_local(toy_stage(torch, w, aux), xs,
                                      group=group, with_aux=aux)
        out, a = out if aux else (out, torch.zeros(()))
        M = out.shape[0]
        loss = sum(((out[m] + hp - tgts[m]) ** 2).mean()
                   for m in range(M)) / M + AUX_W * a
        loss.backward()
        info[f"gpipe.{tag}.loss"] = loss.item()
        arrays[f"gpipe.{tag}.out"] = _np(out)
        arrays[f"gpipe.{tag}.dw"] = _np(w.grad)
        arrays[f"gpipe.{tag}.dh"] = _np(hp.grad)
        arrays[f"gpipe.{tag}.dmbs"] = (_np(xs.grad) if xs.grad is not None
                                       else np.zeros(0, np.float32))
    PL.OneFOneBStage.tick = real_tick


class _Recording:
    """An optimizer that keeps a copy of the first step's gradients
    (restacked) and then steps the one it wraps."""

    def __init__(self, opt, params):
        self.opt, self.params, self.grads = opt, params, None

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        if self.grads is None:
            self.grads = _restack(self.params, grads=True)
        self.opt.step()


def _load_full(outdir: str) -> dict:
    full = {}
    for kind in ("dense", "dense4", "moe"):
        path = os.path.join(outdir, f"params.{kind}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                full[kind] = nest_params({k: z[k] for k in z.files})
    return full


def run_llama_pp(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    import dataclasses

    import torch

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh
    from horovod_tpu_torch.parallel import pipeline as PL

    full = _load_full(os.environ["MESH_OUT"])
    batch = {"tokens": _t(tokens())}
    saved = []
    real_tick = PL.OneFOneBStage.tick

    def counting_tick(self, *a):
        out = real_tick(self, *a)
        saved.append(self.saved_inputs())
        return out

    PL.OneFOneBStage.tick = counting_tick
    picked = []
    real_pick = llama._pick_microbatches
    llama._pick_microbatches = lambda *a: picked.append(real_pick(*a)) \
        or picked[-1]
    for name, (sizes, edits, extra) in PP_MESHES[n].items():
        mesh = build_mesh(MeshConfig(**sizes))
        cfg = llama.LlamaConfig.tiny(**edits)
        src = full[params_kind(edits)]
        if "shards" in extra:
            for k, a in _restack(llama.shard_params(src, cfg, mesh,
                                                    "cpu")).items():
                arrays[f"{name}.shard.{k}"] = a
        cases = [(s, cfg) for s in SCHEDULES]
        if "micro" in extra:
            cases.append(("1f1b.m8", dataclasses.replace(
                cfg, pp_microbatches=PP_MICRO)))
        for sched, c in cases:
            params = llama.shard_params(src, c, mesh, device="cpu")
            opt = _Recording(torch.optim.Adam(llama.trainable(params),
                                              lr=LR, eps=1e-8), params)
            step = llama.make_train_step(
                c, opt, mesh=mesh, pipeline_schedule=sched.split(".")[0])
            saved.clear()
            picked.clear()
            info[f"{name}.{sched}.losses"] = [step(params, batch).item()
                                              for _ in range(STEPS)]
            info[f"{name}.{sched}.microbatches"] = picked[0]
            info[f"{name}.{sched}.max_saved"] = max(saved, default=0)
            for k, a in opt.grads.items():
                arrays[f"{name}.{sched}.grad.{k}"] = a
        if "micro" in extra:
            bad = dataclasses.replace(cfg, pp_microbatches=3)
            params = llama.shard_params(src, bad, mesh, device="cpu")
            step = llama.make_train_step(
                bad, torch.optim.Adam(llama.trainable(params)), mesh=mesh)
            try:
                step(params, batch)
            except ValueError as e:
                info[f"{name}.bad_micro"] = str(e)
    PL.OneFOneBStage.tick = real_tick
    llama._pick_microbatches = real_pick


def run_generate(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    import dataclasses

    import torch

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh

    full = _load_full(os.environ["MESH_OUT"])["dense"]
    prompt = _t(gen_prompt())
    cfg = llama.LlamaConfig.tiny()
    for name, sizes in GEN_MESHES[n].items():
        mesh = build_mesh(MeshConfig(**sizes))
        params = llama.shard_params(full, cfg, mesh, device="cpu")
        arrays[f"{name}.greedy"] = _np(llama.generate(
            params, prompt, cfg, max_new_tokens=GEN["new"], mesh=mesh))
        for i in range(2):
            g = torch.Generator().manual_seed(GEN["seed"])
            arrays[f"{name}.sampled{i}"] = _np(llama.generate(
                params, prompt, cfg, max_new_tokens=GEN["new"], mesh=mesh,
                temperature=GEN["temperature"], generator=g))
        if sizes.get("tp", 1) > 1:
            arrays[f"{name}.overlap"] = _np(llama.generate(
                params, prompt, dataclasses.replace(cfg,
                                                    decode_tp_overlap=True),
                max_new_tokens=GEN["new"], mesh=mesh))


def run_serving(hvd, me: int, n: int, arrays: dict, info: dict) -> None:
    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh

    full = _load_full(os.environ["MESH_OUT"])["dense"]
    cfg = llama.LlamaConfig.tiny()
    knobs = {k: SERVE[k] for k in ("block_size", "num_blocks", "max_active")}
    for name, sizes in SERVE_MESHES.items():
        mesh = build_mesh(MeshConfig(**sizes))
        params = llama.shard_params(full, cfg, mesh, device="cpu")
        for tag, extra in (("plain", {}), ("prefix", {"prefix_cache": True})):
            sess = serving.serve(params, cfg, mesh=mesh, device="cpu",
                                 **knobs, **extra)
            futs = [sess.submit(p, SERVE["new"]) for p in serve_prompts()]
            sess.drain()
            for i, f in enumerate(futs):
                arrays[f"{name}.{tag}.req{i}"] = np.asarray(
                    f.result().tokens, np.int32)
            info[f"{name}.{tag}.pool"] = list(sess.engine.k_pool.shape)
            info[f"{name}.{tag}.ticks"] = sess.engine.decode_ticks
            sess.close()


BATTERIES = {"sharding": run_sharding, "llama": run_llama,
             "pipeline": run_pipeline, "llama_pp": run_llama_pp,
             "generate": run_generate, "serving": run_serving}


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

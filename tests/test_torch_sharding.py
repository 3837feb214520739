"""Port parity: logical sharding (``horovod_tpu_torch/parallel/sharding.py``),
the collectives over mesh axes (``parallel/comm.py``), ring and Ulysses
attention (``parallel/ring_attention.py``), ``matmul_reducescatter``
(``ops/sched/in_context.py``) and the root's per-rank helpers
(``ops/per_rank.py``, ``context.mesh``).

In this process: the rules as data against the reference's
(``DEFAULT_RULES``, ``spec_for``, ``fitted_rules``, ``spec_axes``), and a
rank's block of a tensor against the shard the JAX package places on the
device of the same mesh coordinate, bitwise.

np=2 and np=4 processes on the CPU over Gloo under the port's launcher
(``tests/mp_torch_mesh_worker.py``, mode ``sharding``, one job a world
size): blocks and their gather on an fsdp x tp mesh, ``constrain``, the
multi-axis groups ``build_mesh`` makes; every collective of ``comm`` with
its gradient against the unsharded computation (exact in fp32 up to the
order of a sum: rtol 1e-6); ring and Ulysses attention, causal and full,
and their q/k/v gradients against the JAX package's ring and Ulysses
over the same number of CPU devices and against dense attention (atol
1e-5); ``matmul_reducescatter`` against the all-reduced product
(``tests/test_sched.py::test_matmul_reducescatter_parity``), bitwise at
np=2; the per-rank helpers against the reference's on the same values.
"""

from __future__ import annotations

import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import mp_torch_dataplane_worker as DW
import mp_torch_mesh_worker as MW
from horovod_tpu.jaxcompat import shard_map
from horovod_tpu.parallel import MeshConfig as JMeshConfig
from horovod_tpu.parallel import build_mesh as jbuild_mesh
from horovod_tpu.parallel import ring_attention as jra
from horovod_tpu.parallel import sharding as jshd
from horovod_tpu_torch.parallel import AXES, MeshConfig
from horovod_tpu_torch.parallel import sharding as shd

DIMS = [("batch", "seq", None), ("embed", "mlp"), ("vocab_rows", None),
        ("stage", "experts", "embed", "expert_mlp"), ("heads", "head_dim"),
        ("kv_heads", "qkv", "norm"), (None,), ()]


def _jmesh(sizes: dict):
    n = int(np.prod(list(sizes.values()) or [1]))
    return jbuild_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])


def _coord(rank: int, sizes: dict) -> dict:
    return dict(zip(AXES, (int(i) for i in np.unravel_index(
        rank, [sizes.get(a, 1) for a in AXES]))))


# ---------------------------------------------------------------------------
# the rules as data
# ---------------------------------------------------------------------------

def test_default_rules_are_the_references():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "-".join(map(str, d)))
def test_spec_for_is_the_references(dims):
    rules = {"mlp": ("tp", "sp"), "seq": None}
    assert shd.spec_for(dims) == tuple(jshd.spec_for(dims))
    assert shd.spec_for(dims, rules) == tuple(jshd.spec_for(dims, rules))
    spec = shd.spec_for(dims)
    assert shd.spec_axes(spec) == jshd.spec_axes(jshd.spec_for(dims))


def test_spec_for_unknown_dim_raises():
    with pytest.raises(KeyError, match="unknown logical dim 'nope'"):
        shd.spec_for(("embed", "nope"))


@pytest.mark.parametrize("sizes,dims", [
    (dict(tp=4), {"heads": 4, "kv_heads": 2}),
    (dict(tp=2, fsdp=2), {"vocab_rows": 6, "heads": 8, "kv_heads": 1}),
    (dict(tp=2, fsdp=2), {"vocab_rows": 4, "batch": 2}),
    (dict(dp=2, fsdp=2), {"batch": 6, "embed": 3}),
    (dict(ep=2, tp=2), {"experts": 3, "expert_mlp": 4}),
])
def test_fitted_rules_are_the_references(sizes, dims):
    """The dividing prefix of a dim's axes, replication when even the
    first does not divide: ``kv_heads=2`` on tp=4 replicates."""
    got = shd.fitted_rules(MeshConfig(**sizes), dims)
    assert got == jshd.fitted_rules(_jmesh(sizes), dims)
    assert got == shd.fitted_rules(sizes, dims)
    if sizes == dict(tp=4):
        assert got == {"kv_heads": None}


@pytest.mark.parametrize("sizes", [dict(fsdp=2, tp=2), dict(dp=2, tp=4),
                                   dict(fsdp=2, ep=2, tp=2), dict(sp=4)])
@pytest.mark.parametrize("spec", [(("tp", "fsdp"), None),
                                  (None, ("fsdp", "tp")), ("fsdp", "tp"),
                                  (("dp", "fsdp"), "sp"), ("ep", None),
                                  (None, None)])
def test_block_is_the_jax_shard(sizes, spec):
    """The block of a rank at each coordinate, bitwise the shard the JAX
    package puts on the device of that coordinate: a dim over several
    axes splits major to minor in the entry's order."""
    x = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    mesh = _jmesh(sizes)
    arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
    devs = list(mesh.devices.flat)
    for s in arr.addressable_shards:
        r = devs.index(s.device)
        got = shd.block(x, spec, {a: sizes.get(a, 1) for a in AXES},
                        _coord(r, sizes))
        np.testing.assert_array_equal(got, np.asarray(s.data))
        np.testing.assert_array_equal(
            shd.block(torch.from_numpy(x), spec, sizes,
                      _coord(r, sizes)).numpy(), np.asarray(s.data))


def test_block_of_an_unsplittable_dim_raises():
    with pytest.raises(ValueError, match="does not split"):
        shd.block(np.zeros((6, 2)), ("tp", None), {"tp": 4}, {"tp": 0})


def test_constrain_with_axes_of_size_one_is_a_no_op():
    x = torch.ones(4, 4)
    assert shd.constrain(x, ("embed", "mlp"), MeshConfig()) is x
    assert shd.constrain(x, ("embed", "mlp"), None) is x
    assert shd.shard(x, ("fsdp", "tp"), MeshConfig(dp=4)) is x


# ---------------------------------------------------------------------------
# the np=2 and np=4 jobs
# ---------------------------------------------------------------------------

def _jax_attention(n: int) -> dict:
    """The JAX package's ring (``ring_self_attention``) and Ulysses
    (``ulysses_attention_local`` under ``shard_map``) over n CPU devices:
    outputs and the q/k/v gradients of ``sum(out * cot)``."""
    q, k, v, cot = (jnp.asarray(t) for t in MW.attn_inputs())
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    out = {}
    for mode in ("ring", "ulysses"):
        for causal in (True, False):
            if mode == "ring":
                def fn(q, k, v, causal=causal):
                    return jra.ring_self_attention(q, k, v, mesh,
                                                   causal=causal)
            else:
                spec = P(None, "sp")
                fn = jax.jit(shard_map(
                    partial(jra.ulysses_attention_local, axis_name="sp",
                            causal=causal),
                    mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                    check_vma=False))
            tag = f"{mode}.{'causal' if causal else 'full'}"
            o, grads = jax.value_and_grad(
                lambda q, k, v, fn=fn: (fn(q, k, v) * cot).sum(),
                argnums=(0, 1, 2))(q, k, v)
            out[f"{tag}.out"] = np.asarray(fn(q, k, v))
            for nm, g in zip("qkv", grads):
                out[f"{tag}.d{nm}"] = np.asarray(g)
    return out


def _jax_helpers(n: int) -> dict:
    """The reference's per-rank helpers over a runtime of n CPU devices."""
    import horovod_tpu as jhvd
    vals = MW.helper_values(n)
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:n])
    try:
        out = {"to_local": jhvd.to_local(jhvd.per_rank(vals)),
               "from_fn": jhvd.to_local(jhvd.per_rank_from_fn(
                   lambda i: vals[i] + 1)),
               "from_local": jhvd.to_local(jhvd.from_local(np.stack(vals))),
               "to_numpy": jhvd.to_numpy(jhvd.allreduce(
                   jhvd.per_rank(vals), op=jhvd.Sum)),
               "mesh": (list(jhvd.mesh().axis_names),
                        list(jhvd.mesh().devices.shape))}
        for tag, bad in (("count", vals[:-1]),
                         ("shapes", vals[:-1] + [np.zeros(3, np.float32)])):
            with pytest.raises(ValueError) as e:
                jhvd.per_rank(bad)
            out[f"per_rank.{tag}"] = str(e.value)
        xs, w, _ = MW.mrs_inputs(n)
        jm = jhvd.mesh()
        ax = jm.axis_names[0]
        out["mrs.mono"] = np.asarray(jax.jit(shard_map(
            lambda xv, wv: jax.lax.psum(xv[0] @ wv[0], ax), mesh=jm,
            in_specs=(P(ax), P(ax)), out_specs=P(), check_vma=False))(xs, w))
    finally:
        jhvd.shutdown()
        jhvd.init()
    return out


def _run(n, tmp_path_factory):
    out = str(tmp_path_factory.mktemp(f"sharding{n}"))
    box = {}
    job = threading.Thread(target=lambda: box.setdefault(
        "res", MW.launch("sharding", out, n)))
    job.start()
    ref = {**_jax_attention(n), **_jax_helpers(n)}
    job.join()
    DW.check_ranks(box["res"])
    return n, MW.load("sharding", out, n), ref


@pytest.fixture(scope="module", params=(2, 4), ids=("np2", "np4"))
def run(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


def test_ranks_import_no_jax(run):
    assert not any(info["jax_loaded"] for _, info in run[1])


def test_blocks_gather_back_to_the_full_tensor(run):
    """On fsdp=2 x tp=n/2: each rank's block of every spec is the JAX
    shard's (the in-process test above) at its coordinate, and
    ``unshard`` of the blocks is the full tensor on every rank."""
    n, ranks, _ = run
    sizes = {"fsdp": 2, "tp": n // 2}
    x = MW.shard_input()
    for r, (arrays, info) in enumerate(ranks):
        assert info["coord"] == _coord(r, sizes)
        for name, spec in MW.SHARD_SPECS.items():
            np.testing.assert_array_equal(
                arrays[f"shard.{name}"],
                shd.block(x, spec, sizes, _coord(r, sizes)))
            np.testing.assert_array_equal(arrays[f"unshard.{name}"], x)


def test_constrain_reshards_and_its_gradient(run):
    """Full to ``vocab_rows`` keeps the rank's rows (its gradient: ones
    on them, zeros elsewhere, the slice's); back to unsharded gathers
    the full tensor; over axes of size 1 nothing happens."""
    n, ranks, _ = run
    sizes = {"fsdp": 2, "tp": n // 2}
    x = MW.shard_input()
    spec = shd.spec_for(("vocab_rows", None))
    for r, (arrays, info) in enumerate(ranks):
        want = shd.block(x, spec, sizes, _coord(r, sizes))
        np.testing.assert_array_equal(arrays["constrain"], want)
        grad = np.zeros_like(x)
        shd.block(grad, spec, sizes, _coord(r, sizes))[...] = 1.0
        np.testing.assert_array_equal(arrays["constrain.grad"], grad)
        np.testing.assert_array_equal(arrays["constrain.back"], x)
        assert info["constrain_noop"]


def test_build_mesh_makes_the_multi_axis_groups(run):
    n, ranks, _ = run
    want = {"fsdp+tp": list(range(4))} if n == 4 else {}
    for _, info in ranks:
        assert info["axis_groups"] == want


def test_collective_gradients_match_the_unsharded_computation(run):
    """copy_to / reduce_from around a column- then row-parallel MLP; the
    all-gather of row blocks for ranks with different data (its
    reduce-scatter backward); scatter of a replicated tensor (its
    all-gather backward); all_to_all (the inverse exchange backward)."""
    n, ranks, _ = run
    c = MW.comm_inputs(n)
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in c.items()}
    out = torch.relu(t["x"] @ t["w1"]) @ t["w2"]
    (out * t["c"][0]).sum().backward()
    wr = t["wrows"]
    sum((t["data"][r] @ wr[:8]).sum() for r in range(n)).backward()
    xs = torch.from_numpy(c["x"]).requires_grad_()
    w = 8 // n
    loss = sum((xs[:, r * w:(r + 1) * w] ** 2
                * t["c"][r][:, r * w:(r + 1) * w]).sum() for r in range(n))
    loss.backward()
    a2a = torch.from_numpy(c["a2a"]).requires_grad_()
    got = a2a.transpose(0, 1)                # rank r gets block r of every
    (got * t["a2a_c"]).sum().backward()
    tol = dict(rtol=1e-6, atol=1e-6)
    for r, (arrays, info) in enumerate(ranks):
        np.testing.assert_allclose(arrays["tp.out"], out.detach(), **tol)
        np.testing.assert_allclose(arrays["tp.dx"], t["x"].grad, **tol)
        np.testing.assert_allclose(arrays["tp.dw1"],
                                   t["w1"].grad[:, r * 4:(r + 1) * 4], **tol)
        np.testing.assert_allclose(arrays["tp.dw2"],
                                   t["w2"].grad[r * 4:(r + 1) * 4], **tol)
        np.testing.assert_allclose(arrays["ag.dw"],
                                   wr.grad[r * 4:(r + 1) * 4], **tol)
        np.testing.assert_allclose(arrays["scatter.dx"], xs.grad, **tol)
        np.testing.assert_allclose(info["scatter.loss"], loss.item(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(arrays["a2a.out"],
                                      got[r].detach().numpy())
        np.testing.assert_array_equal(arrays["a2a.dx"], a2a.grad[r])


def _dense(q, k, v, causal):
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        S = q.shape[1]
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).numpy()


@pytest.mark.parametrize("mode", ("ring", "ulysses"))
@pytest.mark.parametrize("causal", (True, False), ids=("causal", "full"))
def test_sp_attention_matches_the_reference_and_dense(run, mode, causal):
    """Each rank's sequence chunk of the output and of the q/k/v
    gradients, concatenated in rank order, against the JAX package's on
    the same number of devices and against dense attention."""
    n, ranks, ref = run
    tag = f"{mode}.{'causal' if causal else 'full'}"
    q, k, v, _ = MW.attn_inputs()
    for key in ("out", "dq", "dk", "dv"):
        got = np.concatenate([a[f"{tag}.{key}"] for a, _ in ranks], axis=1)
        np.testing.assert_allclose(got, ref[f"{tag}.{key}"], atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    got = np.concatenate([a[f"{tag}.out"] for a, _ in ranks], axis=1)
    np.testing.assert_allclose(got, _dense(q, k, v, causal), atol=1e-5)
    if mode == "ring" and causal:
        for arrays, _ in ranks:
            np.testing.assert_allclose(arrays["ring_self"],
                                       ref["ring.causal.out"], atol=1e-5)


def test_matmul_reducescatter_parity(run):
    """The fused projection against the all-reduced product: bitwise at
    np=2 (two operands add in either order), and against the JAX
    package's psum; an output dim that does not split is the plain
    all-reduce, bitwise."""
    n, ranks, ref = run
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays["mrs.odd"].shape, (4, 60))
        if n == 2:
            np.testing.assert_array_equal(arrays["mrs.fused"],
                                          arrays["mrs.mono"])
            np.testing.assert_array_equal(arrays["mrs.mono"],
                                          ref["mrs.mono"])
        np.testing.assert_allclose(arrays["mrs.fused"], ref["mrs.mono"],
                                   rtol=1e-5, atol=1e-4)
    xs, _, w_odd = MW.mrs_inputs(n)
    odd = sum(xs[r] @ w_odd[r] for r in range(n))
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["mrs.odd"], odd, rtol=1e-5,
                                   atol=1e-4)


def test_root_helpers_match_the_reference(run):
    """Each rank's row of ``per_rank``, ``per_rank_from_fn`` and
    ``from_local``, stacked in rank order, is the reference's array on a
    runtime of n devices; ``to_local`` gives the rank's row, ``to_numpy``
    a reduced result; the shape check's messages are the reference's;
    ``mesh()`` is the flat mesh over every rank."""
    n, ranks, ref = run
    vals = np.stack(MW.helper_values(n))
    np.testing.assert_array_equal(ref["to_local"], vals)
    np.testing.assert_array_equal(
        np.stack([a["per_rank"] for a, _ in ranks]), ref["to_local"])
    np.testing.assert_array_equal(
        np.concatenate([a["to_local"] for a, _ in ranks]), ref["to_local"])
    np.testing.assert_array_equal(
        np.stack([a["per_rank_from_fn"] for a, _ in ranks]), ref["from_fn"])
    np.testing.assert_array_equal(
        np.stack([a["from_local"] for a, _ in ranks]), ref["from_local"])
    for r, (arrays, info) in enumerate(ranks):
        np.testing.assert_array_equal(arrays["replicate_local"], vals[0])
        np.testing.assert_allclose(arrays["to_numpy"], ref["to_numpy"],
                                   rtol=1e-6)
        assert info["per_rank.count"] == ref["per_rank.count"]
        assert info["per_rank.shapes"] == ref["per_rank.shapes"]
        assert info["mesh"] == {"names": ref["mesh"][0],
                                "shape": ref["mesh"][1],
                                "ranks": list(range(n))}


def test_helpers_refuse_what_the_reference_refuses():
    import horovod_tpu_torch as hvd
    hvd.init(config=hvd.Config(platform="cpu"))
    try:
        with pytest.raises(ValueError, match="expected 1 local rows"):
            hvd.from_local(np.zeros((2, 3)))
        assert hvd.to_numpy(torch.ones(2, dtype=torch.bfloat16)).dtype \
            == np.float32
        assert hvd.mesh() is hvd.mesh()
    finally:
        hvd.shutdown()
    with pytest.raises(hvd.NotInitializedError):
        hvd.mesh()

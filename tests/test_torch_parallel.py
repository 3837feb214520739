"""Port parity: the rank mesh and Switch-MoE
(``horovod_tpu_torch/parallel/mesh.py`` and ``parallel/moe.py``), the
counterparts of the mesh and MoE cases of ``tests/test_parallel.py``.

np=2 and np=4 processes on the CPU over Gloo under the port's launcher
(``tests/mp_torch_dataplane_worker.py``, mode ``parallel``):
``build_mesh`` (its ``ep`` groups, ``MeshConfig.auto``'s layout, the
wrong-count error); ``moe_layer`` at ep = np on the dense per-token
oracle's case (ample capacity) and on the capacity-drop case, each rank
its own token shard and experts; ``moe_layer_hvd`` over the engine's
``alltoall`` on the capacity oracle's case of
``test_moe_layer_hvd_parity_with_drops``.  ep = 1 runs in this process.

Tolerances: ``switch_route`` against the JAX one on the same fp32 logits,
the masks exactly and the aux within 1e-6; ``moe_layer`` within 1e-5 of
the oracle and of the JAX package's ``moe_layer`` over the same number
of CPU devices; ``moe_layer_hvd``'s kept rows within 1e-5 of the oracle,
its dropped rows exactly 0, its drops equal to the oracle's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import mp_torch_dataplane_worker as DW
from horovod_tpu.parallel import MeshConfig as JMeshConfig
from horovod_tpu.parallel import moe as jmoe
from horovod_tpu_torch.parallel import AXES, MeshConfig, moe


@pytest.fixture(scope="module", params=(2, 4), ids=("np2", "np4"))
def run(request, tmp_path_factory):
    n = request.param
    out = tmp_path_factory.mktemp(f"parallel{n}")
    DW.check_ranks(DW.launch("parallel", str(out), n))
    return n, DW.load("parallel", out, n)


def _oracle(tokens, router, we):
    logits = tokens @ router
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    idx = p.argmax(-1)
    gate = p[np.arange(len(tokens)), idx]
    return np.stack([gate[t] * (tokens[t] @ we[idx[t]])
                     for t in range(len(tokens))])


def _j_moe_layer(tokens, router, we, n, cf, layer="j"):
    mesh = Mesh(np.array(jax.devices()[:n]), ("ep",))
    out, aux = jmoe.moe_layer(
        jax.device_put(tokens, NamedSharding(mesh, P("ep"))),
        jax.device_put(router, NamedSharding(mesh, P())),
        lambda w, x: x @ w,
        jax.device_put(we, NamedSharding(mesh, P("ep"))), mesh,
        capacity_factor=cf, layer=layer)
    return np.asarray(out), float(aux)


def test_ranks_import_no_jax(run):
    assert not any(info["jax_loaded"] for _, info in run[1])


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def test_mesh_config_auto_is_the_references():
    for n in (1, 2, 4, 8, 12, 16, 30):
        assert MeshConfig.auto(n).axis_sizes() == \
            JMeshConfig.auto(n).axis_sizes()
        assert MeshConfig.auto(n).total == n
    assert AXES == ("pp", "dp", "fsdp", "ep", "sp", "tp")


def test_build_mesh_axes_and_wrong_count(run):
    """The axes in the reference's order, row-major over the ranks: at
    ep = n every rank is in one ep group; ``auto``'s tp (innermost) pairs
    neighbouring ranks; a config that does not multiply to the world
    raises before any group is made."""
    n, ranks = run
    auto = MeshConfig.auto(n)
    for r, (_, info) in enumerate(ranks):
        assert info["mesh_names"] == list(AXES)
        assert info["mesh_shape"] == [1, 1, 1, n, 1, 1]
        assert info["ep_ranks"] == list(range(n))
        tp = auto.tp
        assert info["auto_tp_ranks"] == list(range(r - r % tp,
                                                   r - r % tp + tp))
        assert "multiply to 3" in info["wrong_count"]
        assert f"but {n} ranks" in info["wrong_count"]


def test_build_mesh_at_one_rank_and_its_error():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import config
    from horovod_tpu_torch.parallel import build_mesh
    with pytest.raises(RuntimeError, match="init"):
        build_mesh(MeshConfig())
    hvd.init(config=config.Config(platform="cpu"))
    try:
        mesh = build_mesh(MeshConfig())
        assert mesh.mesh_dim_names == AXES
        assert tuple(mesh.mesh.shape) == (1,) * 6
        with pytest.raises(ValueError, match="multiply to 2"):
            build_mesh(MeshConfig(dp=2))
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# switch_route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,E,C", [(16, 4, 2), (64, 8, 10), (33, 4, 1),
                                   (40, 4, 40)])
def test_switch_route_matches_jax(T, E, C):
    logits = np.random.RandomState(T + E).randn(T, E).astype(np.float32)
    jd, jc, ja, jdrop = jmoe.switch_route(jnp.asarray(logits), C)
    td, tc, ta, tdrop = moe.switch_route(torch.from_numpy(logits), C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    assert td.dtype == torch.float32
    # the drop mask names exactly the tokens with no slot
    np.testing.assert_array_equal(tdrop.numpy(),
                                  td.numpy().sum(axis=(1, 2)) == 0.0)
    assert (td.numpy().sum(axis=(0, 2)) <= C).all()


def test_switch_route_aux_gradient_flows_through_the_mean_probs():
    logits = torch.from_numpy(np.random.RandomState(2).randn(16, 4).astype(
        np.float32)).requires_grad_()
    _, combine, aux, _ = moe.switch_route(logits, 8)
    (ga,) = torch.autograd.grad(aux, logits, retain_graph=True)
    jga = jax.grad(lambda x: jmoe.switch_route(x, 8)[2])(
        jnp.asarray(logits.detach().numpy()))
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), rtol=1e-5,
                               atol=1e-7)
    (gc,) = torch.autograd.grad(combine.sum(), logits)
    jgc = jax.grad(lambda x: jmoe.switch_route(x, 8)[1].sum())(
        jnp.asarray(logits.detach().numpy()))
    np.testing.assert_allclose(gc.numpy(), np.asarray(jgc), rtol=1e-5,
                               atol=1e-7)


def test_capacity_truncates_as_python():
    for T, E, cf in ((10, 16, 1.25), (64, 8, 0.25), (4096, 8, 1.25),
                     (7, 3, 1.0), (1, 8, 0.5)):
        assert moe.capacity_of(T, E, cf) == max(1, int(T * cf / E))


# ---------------------------------------------------------------------------
# moe_layer
# ---------------------------------------------------------------------------

def test_moe_layer_ep1_in_process():
    """ep = 1 (no exchange, this process's group of one): against the
    oracle and the JAX package's moe_layer on one device."""
    tokens, router, we = DW.moe_ep_inputs()
    expert = lambda w, x: x @ w  # noqa: E731
    out, aux = moe.moe_layer_local(torch.from_numpy(tokens),
                                   torch.from_numpy(router), expert,
                                   torch.from_numpy(we),
                                   capacity_factor=float(DW.MOE_EP["E"]))
    np.testing.assert_allclose(out.numpy(), _oracle(tokens, router, we),
                               rtol=1e-5, atol=1e-5)
    jout, jaux = _j_moe_layer(tokens, router, we, 1, float(DW.MOE_EP["E"]))
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), jaux, rtol=1e-5)


def test_moe_layer_parity_across_ep(run):
    n, ranks = run
    tokens, router, we = DW.moe_ep_inputs()
    got = np.concatenate([a["moe.ep"] for a, _ in ranks])
    np.testing.assert_allclose(got, _oracle(tokens, router, we), rtol=1e-5,
                               atol=1e-5)
    jout, jaux = _j_moe_layer(tokens, router, we, n, float(DW.MOE_EP["E"]))
    np.testing.assert_allclose(got, jout, rtol=1e-5, atol=1e-5)
    for _, info in ranks:
        np.testing.assert_allclose(info["moe.ep.aux"], jaux, rtol=1e-5)
        assert info["moe.ep.drops"] == 0


def test_moe_layer_capacity_drops_and_counter(run):
    """Every token routes to expert 0 with a capacity of 1 a shard: every
    shard keeps one token; outputs equal the JAX package's (dropped rows
    exactly 0) and each rank counts the group's total, T - n."""
    from horovod_tpu.obs import REGISTRY
    n, ranks = run
    tokens, router, we = DW.moe_drop_inputs()
    got = np.concatenate([a["moe.drop"] for a, _ in ranks])
    fam = REGISTRY.get("hvd_moe_dropped_tokens_total")
    before = fam.labels(layer="t_jdrop").value
    jout, _ = _j_moe_layer(tokens, router, we, n, DW.MOE_DROP["cf"],
                           layer="t_jdrop")
    np.testing.assert_allclose(got, jout, rtol=1e-6, atol=1e-7)
    zero = (got == 0).all(axis=1)
    np.testing.assert_array_equal(zero, (jout == 0).all(axis=1))
    assert zero.sum() == len(tokens) - n
    want = fam.labels(layer="t_jdrop").value - before
    assert want == len(tokens) - n
    for _, info in ranks:
        assert info["moe.drop.drops"] == want


# ---------------------------------------------------------------------------
# moe_layer_hvd
# ---------------------------------------------------------------------------

def test_moe_layer_hvd_parity_with_drops(run):
    n, ranks = run
    c = DW.MOE_HVD
    router, W, toks = DW.moe_hvd_inputs(n)
    capacity = max(1, int(c["T"] * c["cf"] / c["E"]))
    total = 0
    for r, (arrays, info) in enumerate(ranks):
        logits = toks[r] @ router
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        idx = p.argmax(-1)
        gate = p[np.arange(c["T"]), idx]
        seen = {e: 0 for e in range(c["E"])}
        drops = 0
        for t in range(c["T"]):
            e = int(idx[t])
            if seen[e] < capacity:
                seen[e] += 1
                np.testing.assert_allclose(
                    arrays["hvd"][t], gate[t] * (toks[r][t] @ W[e]),
                    rtol=1e-5, atol=1e-5)
            else:
                drops += 1
                np.testing.assert_array_equal(arrays["hvd"][t], 0.0)
        assert info["hvd.dropped"] == drops == info["hvd.counted"]
        onehot = np.eye(c["E"])[idx]
        np.testing.assert_allclose(
            info["hvd.aux"], c["E"] * (onehot.mean(0) * p.mean(0)).sum(),
            rtol=1e-5)
        total += drops
    assert total > 0

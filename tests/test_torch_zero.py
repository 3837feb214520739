"""Port parity: the ZeRO-1 sharded optimizer (``horovod_tpu_torch/optim/
zero.py``, ``partition.py``).

np=2 and np=4 processes on the CPU over Gloo under the port's launcher
(``tests/mp_torch_dataplane_worker.py``, mode ``zero``): two Adam steps
over five tensors of unaligned sizes, whose gradients are rank-seeded
numpy rows (``loss = sum(p * G)``), through the dense
``DistributedOptimizer`` and through ``ZeroDistributedOptimizer``, at the
fp32 and int8 wires, monolithic and decomposed, one bucket and several.

Tolerances, the reference's contract (``horovod_tpu/optim/zero.py``):
ZeRO's parameters equal the dense optimizer's bitwise at np=2 and within
2 ulp at np=4 (normwise, as the reference measures it), the dense
optimizer reducing each gradient as its own group as the reference's
does; the fp32 run against ``optax.adam`` on the ranks' mean gradient
within rtol 1e-5, atol 1e-6 (1e-4 of the learning rate: the two Adams
round their updates differently).  The state gauge equals Adam's state
on this rank's shard, padding included.

In this process: the plan, shard extraction and reassembly against the
JAX package's ``optim/partition.py``, the restrictions, and ZeRO at one
rank (gradients are views into the flat buckets; the step is the inner
Adam's, bitwise).
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mp_torch_dataplane_worker as DW
from horovod_tpu.optim import partition as JP
from horovod_tpu_torch.optim import partition as TP
from test_torch_reduction import bitwise, ulps

SETUPS = {s[0]: s for s in DW.ZERO_SETUPS}


@pytest.fixture(scope="module", params=(2, 4), ids=("np2", "np4"))
def run(request, tmp_path_factory):
    n = request.param
    out = tmp_path_factory.mktemp(f"zero{n}")
    for rc, text in DW.launch("zero", str(out), n):
        assert rc == 0, text
    return n, DW.load("zero", out, n)


def test_ranks_import_no_jax(run):
    assert not any(info["jax_loaded"] for _, info in run[1])


@pytest.mark.parametrize("tag", sorted(SETUPS))
def test_zero_steps_as_the_dense_optimizer(run, tag):
    n, ranks = run
    for i in range(len(DW.ZERO_SHAPES)):
        dense = ranks[0][0][f"{tag}.dense.{i}"]
        for arrays, _ in ranks:
            got = arrays[f"{tag}.zero.{i}"]
            if n == 2:
                assert bitwise(got, arrays[f"{tag}.dense.{i}"]), (tag, i)
            assert ulps(got, dense) <= 2, (tag, i, ulps(got, dense))
            assert not np.array_equal(got, DW.zero_params(i))


def test_zero_adam_matches_optax(run):
    n, ranks = run
    params = [jnp.asarray(DW.zero_params(i))
              for i in range(len(DW.ZERO_SHAPES))]
    tx = optax.adam(DW.ZERO_LR)
    state = tx.init(params)
    for step in range(DW.ZERO_STEPS):
        grads = [jnp.asarray(np.mean([DW.zero_grad(i, r, step)
                                      for r in range(n)], axis=0))
                 for i in range(len(params))]
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    for i, want in enumerate(params):
        for arrays, _ in ranks:
            np.testing.assert_allclose(arrays[f"fp32.mono.zero.{i}"],
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("tag", sorted(SETUPS))
def test_state_is_the_shard_plus_padding(run, tag):
    """Adam's two moments over this rank's shard (padding included) and
    one step counter a piece; about 1/n of the dense optimizer's."""
    n, ranks = run
    total = sum(int(np.prod(s)) for s in DW.ZERO_SHAPES)
    for _, info in ranks:
        assert info[f"{tag}.gauge"] == info[f"{tag}.state_bytes"]
        assert info[f"{tag}.state_bytes"] == \
            8 * info[f"{tag}.shard_numel"] + 4 * info[f"{tag}.pieces"]
        assert info[f"{tag}.dense_state_bytes"] == \
            8 * total + 4 * len(DW.ZERO_SHAPES)
        assert info[f"{tag}.shard_numel"] * n >= total
    assert ranks[0][1]["fp32.dec.buckets.buckets"] > 1
    assert ranks[0][1]["fp32.mono.buckets"] == 1
    if n == 2:   # the fp32 unit is n: almost no padding
        assert ranks[0][1]["fp32.mono.shard_numel"] * 2 < total + 2 * 5


def test_from_config_picks_the_optimizer(run):
    for _, info in run[1]:
        assert info["from_config.zero"] == "ZeroDistributedOptimizer"
        assert info["from_config.dense"] == "_DistributedOptimizer"


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def _leaves():
    rng = np.random.RandomState(0)
    return [rng.randn(*s).astype(np.float32)
            for s in ((33, 20), (7,), (513,), (3, 1000), (5,))]


@pytest.mark.parametrize("n,mode,bucket_bytes", list(itertools.product(
    (1, 2, 4, 8), ("fp32", "int8"), (0, 4096))))
def test_plan_and_shards_are_the_references(n, mode, bucket_bytes):
    leaves = _leaves()
    modes = [mode if i % 2 == 0 else "fp32" for i in range(len(leaves))]
    tp = TP.build_plan([torch.from_numpy(x) for x in leaves], n,
                       modes=modes, block=64, chunks=3,
                       bucket_bytes=bucket_bytes)
    jp = JP.build_plan(leaves, n, modes=modes, block=64, chunks=3,
                       bucket_bytes=bucket_bytes)
    assert (tp.numel, tp.padded, tp.shard_numel) == \
        (jp.numel, jp.padded, jp.shard_numel)
    for tb, jb in zip(tp.buckets, jp.buckets, strict=True):
        assert (tb.numel, tb.shard, tb.mode) == (jb.numel, jb.shard, jb.mode)
        assert [(s.index, s.shape, s.numel, s.padded, s.offset)
                for s in tb.leaves] == \
            [(s.index, s.shape, s.numel, s.padded, s.offset)
             for s in jb.leaves]
        layout = TP.bucket_layout(tp, tb)
        assert layout == JP.bucket_layout(jp, jb)
        flat = TP.flatten_bucket(tb, [torch.from_numpy(x) for x in leaves])
        assert bitwise(flat.numpy(), np.asarray(JP.flatten_bucket(jb,
                                                                  leaves)))
        shards = [TP.extract_shard(flat, me, layout, n) for me in range(n)]
        for me in range(n):
            assert bitwise(shards[me].numpy(), np.asarray(JP.extract_shard(
                jnp.asarray(flat.numpy()), me, layout, n)))
        back = TP.assemble_from_shards(torch.cat(shards), layout, n)
        assert bitwise(back.numpy(), flat.numpy())
        for idx, t in TP.unflatten_bucket(tb, flat):
            assert bitwise(t.numpy(), leaves[idx])


@pytest.fixture
def one_rank(monkeypatch):
    import os

    import horovod_tpu_torch as tdv
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    tdv.init(config=tdv.Config(platform="cpu"))
    yield tdv
    tdv.shutdown()


def test_restrictions(one_rank):
    p = [torch.nn.Parameter(torch.zeros(4))]
    with pytest.raises(NotImplementedError, match="stage 2"):
        one_rank.ZeroDistributedOptimizer(torch.optim.SGD(p, lr=0.1),
                                          partition=2)
    with pytest.raises(ValueError, match="AVERAGE/SUM"):
        one_rank.ZeroDistributedOptimizer(torch.optim.SGD(p, lr=0.1),
                                          op=one_rank.Adasum)
    opt = torch.optim.Adam(p, lr=0.1)
    p[0].grad = torch.ones(4)
    opt.step()
    with pytest.raises(ValueError, match="not stepped yet"):
        one_rank.ZeroDistributedOptimizer(opt)


def test_one_rank_zero_is_the_inner_adam_on_flat_bucket_views(one_rank):
    """At one rank the gradients are views into the flat buckets, no
    collective runs, and the step is the inner Adam's, bitwise; the extra
    memory is the padding alone."""
    torch.manual_seed(0)
    a = torch.nn.Linear(30, 7)
    b = torch.nn.Linear(30, 7)
    b.load_state_dict(a.state_dict())
    zopt = one_rank.ZeroDistributedOptimizer(
        torch.optim.Adam(a.parameters(), lr=0.05))
    ref = torch.optim.Adam(b.parameters(), lr=0.05)
    [flat] = zopt._flat_g
    assert flat.numel() == sum(p.numel() for p in a.parameters())
    for step in range(3):
        x = torch.randn(4, 30)
        for model, opt in ((a, zopt), (b, ref)):
            opt.zero_grad()
            model(x).square().sum().backward()
            opt.step()
        for p in a.parameters():
            base = flat.data_ptr()
            assert base <= p.grad.data_ptr() < base + 4 * flat.numel()
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    assert zopt.state_bytes() == sum(
        v.numel() * v.element_size() for st in ref.state.values()
        for v in st.values() if isinstance(v, torch.Tensor))

"""Port parity: AVERAGE at a rank count that is not a power of two.

XLA compiles the JAX package's ``out / n`` (``horovod_tpu/ops/
collectives.py:258-263``) into a product by the reciprocal rounded to the
payload's dtype for float32 and float16, and keeps a true division for
bfloat16.  The port's ``collectives.average_`` and the executor's fp32
combine follow it, so np=3 averages equal the JAX package's bitwise.

np=3 processes on the CPU over Gloo under the port's launcher
(``tests/mp_torch_dataplane_worker.py``, mode ``average``): float32,
float16 and bfloat16 payloads, monolithic, a fused cycle, ``rs_ag:<k>``
and ``compiled:rs_ag:<k>``.  The inputs make every sum exact in its dtype
(``avg_rows``), so only the division can differ; tolerance: bitwise.
In this process: the rule itself against XLA's rewrite at n = 1..8.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mp_torch_dataplane_worker as DW
from horovod_tpu.ops import collectives as JC
from horovod_tpu_torch.ops import collectives as TC
from test_torch_reduction import mesh

NP = 3
_JDT = {"float32": jnp.float32, "float16": jnp.float16,
        "bfloat16": jnp.bfloat16}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("average3")
    DW.check_ranks(DW.launch("average", str(out), NP))
    return DW.load("average", out, NP)


def _reference(dt: str) -> np.ndarray:
    rows = np.stack([DW.avg_rows(dt, r, NP) for r in range(NP)])
    fn = JC._build_allreduce(mesh(NP), "hvd", JC.ReduceOp.AVERAGE, 1.0, 1.0)
    out = fn(jnp.asarray(rows).astype(_JDT[dt]))
    return np.asarray(out.astype(jnp.float32))


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("dt", [d for d, _ in DW.AVG_DTYPES])
@pytest.mark.parametrize("path", ["mono", "fused"]
                         + [f"{p}{k}" for p in ("rs_ag", "compiled")
                            for k in DW.AVG_CHUNKS])
def test_np3_average_equals_the_reference_bitwise(run, dt, path):
    want = _reference(dt)
    for arrays, _ in run:
        got = arrays[f"{dt}.{path}"]
        assert got.shape == want.shape
        diff = int((_bits(got) != _bits(want)).sum())
        assert diff == 0, f"{diff} of {want.size} {dt} averages differ"


@pytest.mark.parametrize("dt", ["float32", "float16", "bfloat16", "float64"])
@pytest.mark.parametrize("n", range(1, 9))
def test_average_rounds_as_xla_compiles_the_division(dt, n):
    """``average_`` against XLA's jitted ``x / n`` on random values (not
    exact sums); float64 under x64."""
    x = (np.random.RandomState(n).randn(20000) * 3).astype(np.float64)
    with jax.enable_x64(dt == "float64"):
        jx = jnp.asarray(x).astype(getattr(jnp, dt))
        want = np.asarray(jax.jit(lambda v: v / n)(jx)).astype(np.float64)
        tx = torch.from_numpy(np.asarray(jx).astype(np.float64)).to(
            getattr(torch, dt))
    got = TC.average(tx, n).double().numpy()
    assert np.array_equal(got, want), int((got != want).sum())


def test_integer_average_floors():
    t = torch.tensor([-7, -1, 0, 5, 7], dtype=torch.int32)
    assert TC.average(t, 3).tolist() == [-3, -1, 0, 1, 2]

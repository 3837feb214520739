"""Port parity: the collective verbs of ``horovod_tpu_torch`` at two ranks.

Two processes, one rank each, run every verb of the port on the CPU over
Gloo (``tests/mp_torch_port_worker.py``, mode ``collectives``): allreduce
with every ReduceOp in float32, bfloat16 and int32 (int32 AVERAGE on
negative values, where floor division and truncation differ), prescale
and postscale, grouped allreduce (and its ``grouped_allreduce_sync``
name), reducescatter, alltoall with and without
splits, allgather (equal and ragged rows), broadcast from rank 1, the
in-place forms, a two-rank and a one-rank process set.

Each result is held against the JAX package's verb on the same inputs,
given as ``per_rank`` arrays over a two-device process set of the
conftest's 8 CPU devices.  Tolerances: float32 and int32 exact, except
PRODUCT in float32 (the reference multiplies in rank order after a
gather, the port too, but through another library: rtol 1e-6); bfloat16
results within one bfloat16 ulp (rtol 2^-8), whose inputs are exact in
bfloat16.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest

import horovod_tpu as hvd
import mp_torch_port_worker as W

CASES = {c["name"]: c for c in W.COLLECTIVE_CASES}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    res = W.launch("collectives", str(out), timeout=150)
    for rc, text in res:
        assert rc == 0, text
    ranks = []
    for r in range(W.NP):
        with np.load(out / f"collectives.rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        info = json.loads((out / f"collectives.rank{r}.json").read_text())
        ranks.append((arrays, info))
    return ranks


@pytest.fixture(scope="module")
def sets():
    two = hvd.add_process_set([0, 1])
    one = hvd.add_process_set([1])
    yield {"all": two, "one": one}
    hvd.remove_process_set(two)
    hvd.remove_process_set(one)


def _jax_dtype(dt: str):
    return {"float32": np.float32, "int32": np.int32,
            "bfloat16": jnp.bfloat16}[dt]


def _per_rank(case, ps, part=0):
    dt = _jax_dtype(case["dtype"])
    return hvd.per_rank([np.asarray(W.case_input(case, r, part)).astype(dt)
                         for r in range(W.NP)], process_set=ps)


def _f32(x) -> np.ndarray:
    return np.asarray(hvd.to_numpy(x) if not isinstance(x, np.ndarray)
                      else x).astype(np.float32)


def _close(case, got, want, name):
    if case["dtype"] == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0,
                                   err_msg=name)
    elif case.get("op") == "product" and case["dtype"] == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def _jax_reference(case, sets) -> list:
    """The JAX package's result for each rank."""
    ps = sets["all"]
    verb = case["verb"].rstrip("_").replace("_async", "")
    op = getattr(hvd.ReduceOp, case.get("op", "sum").upper())
    if verb == "allreduce":
        if case.get("ps") == "one":
            x = hvd.per_rank([W.case_input(case, 1)],
                             process_set=sets["one"])
            return [None, _f32(hvd.allreduce(x, op, process_set=sets["one"]))]
        out = _f32(hvd.allreduce(
            _per_rank(case, ps), op,
            prescale_factor=case.get("prescale", 1.0),
            postscale_factor=case.get("postscale", 1.0), process_set=ps))
        return [out] * W.NP
    if verb.startswith("grouped_allreduce"):
        outs = getattr(hvd, verb)(
            [_per_rank(case, ps, part) for part in range(3)], op,
            process_set=ps)
        return [[_f32(o) for o in outs]] * W.NP
    if verb == "reducescatter":
        out = _f32(hvd.reducescatter(_per_rank(case, ps), op,
                                     process_set=ps))
        return list(out)
    if verb == "alltoall":
        if case.get("splits"):
            pieces = [W.case_input(case, r) for r in range(W.NP)]
            return [_f32(o) for o in hvd.alltoall(
                pieces, splits=np.array(case["splits"]), process_set=ps)]
        return list(_f32(hvd.alltoall(_per_rank(case, ps), process_set=ps)))
    if verb == "allgather":
        if case.get("ragged"):
            pieces = [W.case_input(case, r) for r in range(W.NP)]
            out = np.asarray(hvd.allgather(pieces, process_set=ps))
        else:
            out = _f32(hvd.allgather(_per_rank(case, ps), process_set=ps))
        return [out.astype(np.float32)] * W.NP
    if verb == "broadcast":
        out = _f32(hvd.broadcast(_per_rank(case, ps), case["root"],
                                 process_set=ps))
        return [out] * W.NP
    raise AssertionError(verb)


@pytest.mark.parametrize("name", sorted(CASES))
def test_verb_matches_jax(port, sets, name):
    case = CASES[name]
    want = _jax_reference(case, sets)
    for r, (arrays, info) in enumerate(port):
        if want[r] is None:          # not a member of the one-rank set
            assert "not in ProcessSet" in info[f"{name}.error"]
            assert name not in arrays
            continue
        if case["verb"].startswith("grouped_allreduce"):
            for i, w in enumerate(want[r]):
                _close(case, arrays[f"{name}.{i}"].astype(np.float32), w,
                       f"{name}.{i} rank {r}")
            continue
        if case["verb"].endswith("_"):      # the result is the input
            assert info[f"{name}.same_tensor"] is True
        got = arrays[name]
        assert got.dtype == (np.int32 if case["dtype"] == "int32"
                             else np.float32), got.dtype
        assert got.shape == want[r].shape, (got.shape, want[r].shape)
        _close(case, got.astype(np.float32), want[r], f"{name} rank {r}")


def test_integer_average_floors_negative_sums(port):
    """The case that tells floor division from NCCL's truncating ncclAvg:
    an odd negative sum of the two ranks."""
    case = CASES["allreduce.average.int32"]
    total = W.case_input(case, 0).astype(np.int64) + W.case_input(case, 1)
    assert ((total < 0) & (total % 2 == 1)).any()
    np.testing.assert_array_equal(port[0][0][case["name"]], total // 2)


def test_workers_load_no_jax(port):
    assert [info["jax_loaded"] for _, info in port] == [False] * W.NP

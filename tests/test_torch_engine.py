"""Port parity: the negotiating, fusing engine of ``horovod_tpu_torch``.

The semantics of ``tests/test_engine.py`` and ``tests/mp_join_worker.py``
at two ranks: two processes run the engine battery of
``tests/mp_torch_port_worker.py`` (mode ``engine``) on the CPU over Gloo,
negotiating through the native controller, with a timeline each.  Held
here:

- an async allreduce round trip, ``poll`` after ``synchronize``;
- 20 tensors enqueued in one cycle fuse into one dispatch (the
  ``hvd_fusion_batch_tensors`` histogram), four 32-byte tensors under a
  40-byte threshold go one by one, and every result equals the JAX
  package's allreduce of the same inputs (float32, exact);
- a duplicate in-flight name, an error at dispatch and a failing
  negotiator each reach the handle as ``HorovodInternalError`` on every
  rank, and the failed name can be used again;
- ``join()``: rank 0 stops after 3 steps and rank 1 runs 5; the joined
  rank contributes zeros and AVERAGE still divides by 2, as the JAX
  package computes it with a zero input; both ranks return 1, the last
  to join;
- the timeline's QUEUE → NEGOTIATE → DISPATCH spans of a tensor.

And at one rank in this process, with stand-in negotiators (the cases of
``tests/test_engine.py``): a non-allreduce made ready by a joined rank
errors and is consumed; a ``join()`` that times out hands its result to
the next call; ``start_timeline``/``stop_timeline`` at run time.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import horovod_tpu as hvd
import mp_torch_port_worker as W


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("engine")
    res = W.launch("engine", str(out), timeout=150,
                   extra_env={"HVDTPU_TIMELINE": str(out / "tl.json")})
    for rc, text in res:
        assert rc == 0, text
    ranks = []
    for r in range(W.NP):
        with np.load(out / f"engine.rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        info = json.loads((out / f"engine.rank{r}.json").read_text())
        events = json.loads((out / f"tl.r{r}.json").read_text())
        ranks.append((arrays, info, events))
    return ranks


@pytest.fixture(scope="module")
def ps():
    two = hvd.add_process_set([0, 1])
    yield two
    hvd.remove_process_set(two)


def _jax(fn, ps, op) -> np.ndarray:
    x = hvd.per_rank([fn(r) for r in range(W.NP)], process_set=ps)
    return np.asarray(hvd.to_numpy(hvd.allreduce(x, op, process_set=ps)))


def test_async_roundtrip(port, ps):
    want = _jax(lambda r: W.engine_input("rt", r, 0), ps, hvd.Average)
    for arrays, info, _ in port:
        np.testing.assert_array_equal(arrays["roundtrip"], want)
        assert info["roundtrip_polled"] is True


def _histogram_delta(counts) -> dict:
    """Cumulative bucket deltas -> {upper edge index: observations}."""
    per = np.diff([0] + counts)
    return {i: int(c) for i, c in enumerate(per) if c}


def test_one_cycle_fuses(port, ps):
    for r, (arrays, info, _) in enumerate(port):
        # buckets (1, 2, 4, 8, 16, 32, ...): one dispatch of 20 tensors
        # lands in the (16, 32] bucket, index 5.
        assert _histogram_delta(info["fusion_batches"]) == {5: 1}, r
        for i in range(W.ENGINE_FUSED):
            want = _jax(lambda q: W.engine_input("fused", q, i), ps, hvd.Sum)
            np.testing.assert_array_equal(arrays[f"fused.{i}"], want)


def test_threshold_splits_the_group(port, ps):
    for r, (arrays, info, _) in enumerate(port):
        assert _histogram_delta(info["threshold_batches"]) == \
            {0: W.ENGINE_THRESHOLD}, r
        for i in range(W.ENGINE_THRESHOLD):
            want = _jax(lambda q: W.engine_input("thresh", q, i, 8), ps,
                        hvd.Sum)
            np.testing.assert_array_equal(arrays[f"thresh.{i}"], want)


@pytest.mark.parametrize("key,match", [
    ("duplicate", "already pending"),
    ("dispatch_error", "not divisible by ranks"),
    ("negotiator_error", "controller gone"),
])
def test_errors_reach_the_handle(port, key, match):
    for _, info, _ in port:
        assert match in info[key], info[key]


def test_failed_name_is_free_again(port):
    for arrays, _, _ in port:
        np.testing.assert_array_equal(arrays["negotiator_retry"],
                                      np.full((2,), 1.0, np.float32))


def test_join_zero_participation(port, ps):
    steps0, steps1 = W.JOIN_STEPS
    for step in range(steps1):
        live = [r for r in range(W.NP) if step < W.JOIN_STEPS[r]]
        want = _jax(lambda r: W.join_input(r, step) if r in live
                    else np.zeros((4,), np.float32), ps, hvd.Average)
        for r in live:
            np.testing.assert_array_equal(port[r][0][f"join.{step}"], want,
                                          err_msg=f"rank {r} step {step}")
        assert (f"join.{step}" in port[0][0]) == (step < steps0)
    assert [info["join_last"] for _, info, _ in port] == [1, 1]


def test_timeline_phases(port):
    for r, (_, _, events) in enumerate(port):
        lanes = {e["args"]["name"]: e["tid"] for e in events
                 if e.get("name") == "thread_name"}
        tid = lanes["t.async"]
        spans = [e["name"] for e in events
                 if e.get("ph") == "B" and e.get("tid") == tid]
        assert spans == ["QUEUE", "NEGOTIATE", "DISPATCH"], (r, spans)
        assert [e.get("args", {}).get("rank") for e in events
                if e.get("name") == "clock_sync"] == [r]


def test_engine_cycles_and_no_jax(port):
    for _, info, _ in port:
        assert info["cycles"] > 0
        assert info["jax_loaded"] is False


# ---------------------------------------------------------------------------
# join's error paths, at one rank in this process with a stand-in
# negotiator (the cases of tests/test_engine.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def port_engine(monkeypatch):
    import os

    import horovod_tpu_torch as tdv
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    tdv.init(config=tdv.Config(platform="cpu"))
    eng = tdv.global_state().engine
    real = eng._negotiator
    yield tdv, eng
    eng._negotiator = real
    tdv.shutdown()


def test_join_covered_non_allreduce_errors(port_engine):
    """A non-allreduce whose readiness depended on a joined rank's zeros
    errors on the ranks that own it, and is consumed, not re-queued."""
    import time

    import torch

    from horovod_tpu_torch.ops.engine import NegotiationOutcome, Negotiator
    tdv, eng = port_engine

    class Covered(Negotiator):
        def negotiate(self, entries, *, joined=False):
            names = [e.name for e in entries]
            return NegotiationOutcome(ready=names, join_covered=set(names))

    eng._negotiator = Covered()
    x = torch.ones(2)
    with pytest.raises(tdv.HorovodInternalError, match="allreduce"):
        tdv.synchronize(tdv.allgather_async(x, name="t.cov.ag"))
    deadline = time.monotonic() + 2
    while time.monotonic() < deadline:
        with eng._lock:
            if not eng._queue and "t.cov.ag" not in eng._names_pending:
                break
        time.sleep(0.01)
    with eng._lock:
        assert not eng._queue and "t.cov.ag" not in eng._names_pending
    with pytest.raises(tdv.HorovodInternalError, match="allreduce"):
        tdv.synchronize(tdv.broadcast_async(x, 0, name="t.cov.bc"))
    out = tdv.synchronize(tdv.allreduce_async(x, tdv.Sum, name="t.cov.ar"))
    assert torch.equal(out, x)


def test_join_timeout_then_latched_result(port_engine):
    """join() timing out leaves the rank joined; the join that completes
    with no waiter hands its result to the next join() call."""
    import time

    from horovod_tpu_torch.ops.engine import NegotiationOutcome, Negotiator
    tdv, eng = port_engine

    class SlowJoin(Negotiator):
        always_check_in = True

        def __init__(self):
            self.joined_rounds = 0

        def negotiate(self, entries, *, joined=False):
            names = [e.name for e in entries]
            if joined:
                self.joined_rounds += 1
                if self.joined_rounds >= 3:
                    return NegotiationOutcome(
                        ready=names, all_joined=True, last_join_rank=5)
                # another rank's non-joinable tensor: skipped, not fatal
                return NegotiationOutcome(
                    ready=names + ["t.ghost.ag"],
                    metas={"t.ghost.ag": '{"v":"allgather",'
                           '"d":"float32","s":[8,2],"o":"sum"}'},
                    join_covered={"t.ghost.ag"})
            return NegotiationOutcome(ready=names)

    eng._negotiator = SlowJoin()
    with pytest.raises(TimeoutError):
        eng.join(timeout=1e-4)
    deadline = time.monotonic() + 10
    while not eng._join_pending_consume and time.monotonic() < deadline:
        time.sleep(0.005)
    assert eng.join(timeout=5) == 5
    assert not eng._join_pending_consume and not eng._join_requested


def test_start_and_stop_timeline(port_engine, tmp_path):
    """``start_timeline`` swaps in a Chrome-trace timeline at run time
    and ``stop_timeline`` flushes it († hvd.start_timeline, v0.21)."""
    import torch
    tdv, _ = port_engine
    path = tmp_path / "tl.json"
    tdv.start_timeline(str(path))
    tdv.allreduce(torch.ones(3), name="t.runtime_tl")
    tdv.stop_timeline()
    assert tdv.global_state().timeline is None
    events = json.loads(path.read_text())
    lanes = {e["args"]["name"]: e["tid"] for e in events
             if e.get("name") == "thread_name"}
    spans = [e["name"] for e in events
             if e.get("ph") == "B" and e.get("tid") == lanes["t.runtime_tl"]]
    assert spans == ["QUEUE", "NEGOTIATE", "DISPATCH"]

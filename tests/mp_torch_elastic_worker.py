"""Worker of the port's elastic launcher tests (``tests/test_torch_elastic.py``).

Run by ``python -m horovod_tpu_torch.runner --host-discovery-script ...``
on the CPU (``HVDTPU_PLATFORM=cpu``), as the reference's
``tests/mp_elastic_worker.py`` and ``mp_elastic_ckpt_worker.py`` are by
its launcher:

- ``scalar``: a scalar advanced by a negotiated allreduce under
  ``@hvd.elastic.run`` over a :class:`FileBackedState` committed each step
  (``w <- allreduce_sum(w + 1)``, so at size 1 ``w`` equals the step);
  with ``HVDTPU_TEST_KILL=1`` rank 1 of a two-rank world crashes at step
  3, before that step's collective;
- ``ckpt``: a small MLP trained full-batch with Adam through
  ``hvd.DistributedOptimizer``, every step checkpointed (parameters, Adam
  state, step) by :class:`~horovod_tpu_torch.utils.checkpoint.Checkpointer`
  and every start restored from the latest checkpoint.  The data are the
  same on every rank and the average of identical gradients over 1, 2 or
  4 ranks is exact, so every logged loss equals the uninterrupted
  single-process run (:func:`oracle_losses`) only if the model and Adam
  state round-trip exactly; with ``HVDTPU_TEST_KILL=1`` rank
  ``HVDTPU_TEST_KILL_RANK`` (default 1) of the first incarnation crashes
  at ``KILL_STEP_CKPT``.

Env: ``HVDTPU_TEST_STATE``, ``_LOG``, ``_CKPT``, ``_KILL``, ``_KILL_RANK``,
``_TOTAL``, ``_STEP_DELAY``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

KILL_STEP = 3
KILL_STEP_CKPT = 4
LR = 5e-2


def log_line(text: str) -> None:
    with open(os.environ["HVDTPU_TEST_LOG"], "a") as f:
        f.write(text + "\n")


def build():
    """The MLP's parameters and data, from fixed seeds."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(32, 4).astype(np.float32))
    y = torch.from_numpy(rng.randn(32, 1).astype(np.float32))
    init = np.random.RandomState(0)
    params = {
        "w1": torch.from_numpy((init.randn(4, 8) * 0.5).astype(np.float32)),
        "b1": torch.zeros(8),
        "w2": torch.from_numpy((init.randn(8, 1) * 0.5).astype(np.float32)),
        "b2": torch.zeros(1),
    }
    for p in params.values():
        p.requires_grad_()
    return params, x, y


def loss_fn(p, x, y):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return ((h @ p["w2"] + p["b2"] - y) ** 2).mean()


def oracle_losses(total: int) -> list:
    """The uninterrupted run in one process, no runtime."""
    params, x, y = build()
    adam = torch.optim.Adam(list(params.values()), lr=LR)
    out = []
    for _ in range(total):
        adam.zero_grad()
        loss = loss_fn(params, x, y)
        loss.backward()
        adam.step()
        out.append(float(loss.detach()))
    return out


def main_scalar(hvd) -> int:
    from horovod_tpu_torch.elastic import FileBackedState
    total = int(os.environ.get("HVDTPU_TEST_TOTAL", "6"))
    delay = float(os.environ.get("HVDTPU_TEST_STEP_DELAY", "0"))
    kill = os.environ.get("HVDTPU_TEST_KILL") == "1"
    me, n = hvd.rank(), hvd.size()
    state = FileBackedState(os.environ["HVDTPU_TEST_STATE"], step=0, w=0.0)
    log_line(f"START rank={me} size={n} resume_step={state.step} "
             f"w={state.w}")

    @hvd.elastic.run
    def train(state):
        for step in range(state.step, total):
            if kill and n == 2 and me == 1 and step == KILL_STEP:
                log_line(f"CRASH rank={me} step={step}")
                os._exit(7)
            if delay:
                time.sleep(delay)
            out = hvd.allreduce(torch.full((1,), state.w + 1.0), hvd.Sum,
                                name=f"w.{step}")
            state.w = float(out[0])
            state.step = step + 1
            state.commit()   # durable save, then epoch check (may exit 75)
            log_line(f"STEP rank={me} size={n} step={step} w={state.w}")
        return state.w

    train(state)
    log_line(f"DONE rank={me} size={n} step={state.step} w={state.w}")
    return 0


def main_ckpt(hvd) -> int:
    from horovod_tpu_torch.elastic import FileBackedState
    from horovod_tpu_torch.utils.checkpoint import Checkpointer
    total = int(os.environ.get("HVDTPU_TEST_TOTAL", "12"))
    delay = float(os.environ.get("HVDTPU_TEST_STEP_DELAY", "0"))
    kill_rank = int(os.environ.get("HVDTPU_TEST_KILL_RANK", "1"))
    kill = os.environ.get("HVDTPU_TEST_KILL") == "1"
    me, n = hvd.rank(), hvd.size()
    params, x, y = build()
    adam = torch.optim.Adam(list(params.values()), lr=LR)
    opt = hvd.DistributedOptimizer(adam, named_parameters=params.items())
    ckpt = Checkpointer(os.environ["HVDTPU_TEST_CKPT"], max_to_keep=2,
                        read_only=me != 0)
    start_step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        tree = ckpt.restore(latest, target={"params": params})
        with torch.no_grad():
            for k, v in tree["params"].items():
                params[k].copy_(v)
        adam.load_state_dict(tree["adam"])
        start_step = int(tree["step"])
    state = FileBackedState(os.environ["HVDTPU_TEST_STATE"], step=start_step)
    state.step = max(state.step, start_step)
    log_line(f"START rank={me} size={n} resume_step={state.step}")

    @hvd.elastic.run
    def train(state):
        for step in range(state.step, total):
            if (kill and n > 1 and me == kill_rank
                    and step == KILL_STEP_CKPT and start_step == 0):
                log_line(f"CRASH rank={me} step={step}")
                os._exit(7)
            if delay:
                time.sleep(delay)
            opt.zero_grad()
            loss = loss_fn(params, x, y)
            loss.backward()
            opt.step()
            ckpt.save(step + 1, {"params": params,
                                 "adam": adam.state_dict(),
                                 "step": step + 1})
            state.step = step + 1
            state.commit()
            log_line(f"STEP rank={me} size={n} step={step} "
                     f"loss={float(loss.detach()).hex()}")
        return state.step

    train(state)
    ckpt.close()
    log_line(f"DONE rank={me} size={n} step={state.step}")
    return 0


def main(mode: str) -> int:
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        return {"scalar": main_scalar, "ckpt": main_ckpt}[mode](hvd)
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))

"""Multi-process worker of the model zoo's tests
(``tests/test_torch_models_mp.py``).

``launch(mode, outdir, np_)`` runs ``np_`` copies of this script, one rank
each, through the port's launcher on the CPU over Gloo (the machinery of
``tests/mp_torch_port_worker.py``).  Every rank runs the battery of
``mode`` and writes what it got to ``outdir/<mode>.rank<r>.npz`` and
``.json``:

- ``dp``: ``resnet18_thin`` and BERT tiny trained data-parallel through
  the port's ``DistributedOptimizer`` around SGD, each rank on its
  half of the batch, the ResNet's running statistics averaged over the
  ranks after each step; from the JAX package's variables
  (``outdir/<model>.npz``, written by the test: a rank never imports
  jax);
- ``syncbn``: ``resnet18_thin`` with its batch norm synchronized over
  the world group, each rank on its half of the batch: the logits, the
  running statistics and the gradients averaged over the ranks;
- ``lookup``: DLRM's ``sharded_embedding_lookup`` of the full tables
  and indices, a rank's batch shard, and the tables' gradient under a
  fixed cotangent; at two ranks also the refusals of uneven shards.

The inputs are made with numpy from fixed seeds by the functions below,
which the test imports to build the same inputs for the JAX side.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

import mp_torch_port_worker as W
from mp_torch_mesh_worker import flat_params, nest_params

ENV = {"OMP_NUM_THREADS": "1"}
STEPS = 3
RESNET_LR = 0.05
BERT_LR = 0.1
RESNET_BATCH, RESNET_SIZE = 8, 16
BERT_BATCH, BERT_SEQ = 8, 16
LOOKUP = dict(n_sparse=8, vocab=64, dim=8, batch=16)


def launch(mode: str, outdir: str, np_: int, timeout: float = 180) -> list:
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


def save_variables(outdir: str, name: str, variables: dict) -> None:
    np.savez(os.path.join(outdir, f"{name}.npz"), **flat_params(variables))


def _load_variables(outdir: str, name: str) -> dict:
    with np.load(os.path.join(outdir, f"{name}.npz")) as z:
        return nest_params({k: z[k] for k in z.files})


# ---------------------------------------------------------------------------
# inputs (shared with the test)
# ---------------------------------------------------------------------------

def resnet_batch() -> tuple:
    rng = np.random.RandomState(11)
    x = rng.rand(RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3).astype(
        np.float32)
    return x, rng.randint(0, 10, size=(RESNET_BATCH,)).astype(np.int64)


def lookup_inputs() -> tuple:
    """(tables [T, V, D], indices [B, T], cotangent [B, T, D])."""
    c = LOOKUP
    rng = np.random.RandomState(12)
    tables = (rng.randn(c["n_sparse"], c["vocab"], c["dim"]) * 0.05
              ).astype(np.float32)
    idx = rng.randint(0, c["vocab"], size=(c["batch"], c["n_sparse"])
                      ).astype(np.int32)
    cot = rng.randn(c["batch"], c["n_sparse"], c["dim"]).astype(np.float32)
    return tables, idx, cot


def _half(a: np.ndarray, me: int, n: int) -> np.ndarray:
    b = a.shape[0] // n
    return a[me * b:(me + 1) * b]


# ---------------------------------------------------------------------------
# the batteries (run in the worker processes)
# ---------------------------------------------------------------------------

def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _resnet(outdir: str, group=None):
    from horovod_tpu_torch.models import resnet
    import torch
    model = resnet.resnet18_thin(num_classes=10, dtype=torch.float32,
                                 group=group, device="cpu")
    model.load_state_dict(resnet.params_from_jax(
        _load_variables(outdir, "resnet"), "cpu"))
    return model


def run_dp(hvd, me: int, n: int, arrays: dict, info: dict,
           outdir: str) -> None:
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.models import bert

    x, y = resnet_batch()
    model = _resnet(outdir)
    model.train()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=RESNET_LR),
        named_parameters=model.named_parameters())
    losses = []
    for step in range(STEPS):
        opt.zero_grad()
        loss = F.cross_entropy(model(_t(_half(x, me, n))),
                               _t(_half(y, me, n)))
        loss.backward()
        opt.step()
        # the running statistics averaged over the replicas
        for name, buf in model.named_buffers():
            buf.copy_(hvd.allreduce(buf, name=f"bs.{step}.{name}"))
        losses.append(float(hvd.allreduce(loss.detach(),
                                          name=f"resnet.loss.{step}")))
    info["resnet_losses"] = losses
    for name, value in model.state_dict().items():
        arrays[f"resnet.{name}"] = value.numpy()

    cfg = bert.BertConfig.tiny()
    model = bert.Bert(cfg, device="cpu")
    model.load_state_dict(bert.params_from_jax(
        _load_variables(outdir, "bert"), "cpu"))
    full = bert.synthetic_mlm_batch(cfg, BERT_BATCH, BERT_SEQ, seed=13,
                                    device="cpu")
    mine = {k: _half(v, me, n) for k, v in full.items()}
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=BERT_LR),
        named_parameters=model.named_parameters())
    losses = []
    for step in range(STEPS):
        opt.zero_grad()
        loss = bert.mlm_loss(model, mine)
        loss.backward()
        opt.step()
        losses.append(float(hvd.allreduce(loss.detach(),
                                          name=f"bert.loss.{step}")))
    info["bert_losses"] = losses
    for name, value in model.state_dict().items():
        arrays[f"bert.{name}"] = value.numpy()


def run_syncbn(hvd, me: int, n: int, arrays: dict, info: dict,
               outdir: str) -> None:
    import torch.distributed as dist
    import torch.nn.functional as F
    x, y = resnet_batch()
    model = _resnet(outdir, group=dist.group.WORLD)
    model.train()
    logits = model(_t(_half(x, me, n)))
    F.cross_entropy(logits, _t(_half(y, me, n))).backward()
    arrays["logits"] = logits.detach().numpy()
    for name, buf in model.named_buffers():
        arrays[f"buffer.{name}"] = buf.numpy()
    for name, p in model.named_parameters():
        arrays[f"grad.{name}"] = hvd.allreduce(
            p.grad, name=f"grad.{name}").numpy()


def run_lookup(hvd, me: int, n: int, arrays: dict, info: dict,
               outdir: str) -> None:
    from horovod_tpu_torch.models import dlrm
    tables, idx, cot = lookup_inputs()
    t = _t(tables).requires_grad_()
    out = dlrm.sharded_embedding_lookup(t, _t(idx))
    (out * _t(_half(cot, me, n))).sum().backward()
    arrays["out"] = out.detach().numpy()
    arrays["grad"] = hvd.allreduce(t.grad, hvd.Sum, name="grad").numpy()
    if n == 2:
        refusals = {}
        for name, (tb, ix) in {
                "batch": (t, _t(idx[:15])),
                "tables": (t[:3], _t(idx[:, :3]))}.items():
            try:
                dlrm.sharded_embedding_lookup(tb, ix)
            except ValueError as e:
                refusals[name] = str(e)
        info["refusals"] = refusals


BATTERIES = {"dp": run_dp, "syncbn": run_syncbn, "lookup": run_lookup}


def main(mode: str, outdir: str) -> int:
    sys.path.insert(0, W.REPO)
    import horovod_tpu_torch as hvd
    hvd.init()
    me, n = hvd.rank(), hvd.size()
    arrays: dict = {}
    info: dict = {}
    BATTERIES[mode](hvd, me, n, arrays, info, outdir)
    info["jax_loaded"] = any(
        m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
        or m.split(".")[0] == "horovod_tpu" for m in list(sys.modules))
    np.savez(os.path.join(outdir, f"{mode}.rank{me}.npz"), **arrays)
    with open(os.path.join(outdir, f"{mode}.rank{me}.json"), "w") as f:
        json.dump(info, f)
    hvd.shutdown()
    print(f"rank {me}: {mode} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))

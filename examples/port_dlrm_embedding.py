"""DLRM with sharded embedding tables on the PyTorch/CUDA port: the JAX
package's ``examples/dlrm_embedding.py`` (BASELINE config 5) on
``horovod_tpu_torch.models.dlrm``.

Each rank owns ``n_sparse / size`` whole tables and a shard of the batch.
Every step one ``all_to_all`` ships the batch shards' indices to the
tables' owners and one ships the embeddings back († the reason Horovod
added ``alltoall``); the backward runs the reverse exchange.  The dense
half (bottom MLP, interaction, top MLP) is data-parallel through
``DistributedOptimizer``; a rank's tables take the gradients of every
rank's lookups through the exchange, so they are stepped locally (scaled
by ``1 / size``: the loss is the mean of the ranks' losses).  Adam, as
the JAX example.

    python -m horovod_tpu_torch.runner -np 2 -- \\
        python examples/port_dlrm_embedding.py
    (add --platform cpu to both without a card)
"""

import argparse
import os

import torch
import torch.nn.functional as F


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--platform", choices=("gpu", "cpu"), default=None,
                   help="the runtime's platform (default: the card)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=64,
                   help="the global batch, split over the ranks")
    p.add_argument("--lr", type=float, default=1e-2)
    args = p.parse_args()
    if args.platform:
        os.environ["HVDTPU_PLATFORM"] = args.platform

    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import dlrm

    hvd.init()
    dev, me, n = hvd.device(), hvd.rank(), hvd.size()
    cfg = dlrm.DlrmConfig.tiny()
    if cfg.n_sparse % n or args.batch_size % n:
        raise SystemExit(f"{n} ranks must divide {cfg.n_sparse} tables and "
                         f"a batch of {args.batch_size}")
    # The exchange's group is a new one: the runtime's engine issues the
    # dense gradients' allreduces on the world group from its own thread
    # while the backward runs the reverse exchange.
    group = dist.new_group(list(range(n)))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = dlrm.DlrmDense(cfg, device=dev, generator=gen)
    t = cfg.n_sparse // n                # every rank draws the same tables
    tables = torch.nn.Parameter(dlrm.init_embedding_tables(
        cfg, gen, dev)[me * t:(me + 1) * t].clone())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    dense_opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=args.lr),
        named_parameters=model.named_parameters())
    table_opt = torch.optim.Adam([tables], lr=args.lr)

    batch = dlrm.synthetic_batch(cfg, args.batch_size, seed=0, device=dev)
    b = args.batch_size // n
    mine = {k: v[me * b:(me + 1) * b] for k, v in batch.items()}
    losses = []
    for step in range(args.steps):
        dense_opt.zero_grad()
        table_opt.zero_grad()
        emb = dlrm.sharded_embedding_lookup_local(tables, mine["sparse"],
                                                  group=group)
        logit = model(mine["dense"], emb)
        loss = F.binary_cross_entropy_with_logits(logit, mine["label"])
        loss.backward()
        if n > 1:
            tables.grad.div_(n)
        dense_opt.step()
        table_opt.step()
        losses.append(float(hvd.allreduce(loss.detach(),
                                          name=f"loss.{step}")))
    if me == 0:
        print(f"DONE dlrm first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"size={n} device={dev}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()

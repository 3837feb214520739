"""MNIST with the PyTorch/CUDA port (``horovod_tpu_torch``): the
reference's ``examples/pytorch/pytorch_mnist.py`` workflow on the port's
``ConvNet`` (``horovod_tpu_torch.models.mnist``).

One process a card: the weights broadcast from rank 0, gradients averaged
by ``DistributedOptimizer``, the learning rate scaled by the world size,
the loss averaged across ranks.  The data is synthetic (MNIST-shaped,
from each rank's own seed).

    python -m horovod_tpu_torch.runner -np 2 -- python examples/port_mnist.py
    (add --platform cpu to both on a machine without a card)
"""

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--platform", choices=("gpu", "cpu"), default=None,
                   help="the runtime's platform (default: the card)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.01)
    args = p.parse_args()
    if args.platform:
        os.environ["HVDTPU_PLATFORM"] = args.platform

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import mnist

    hvd.init()
    dev = hvd.device()
    rng = np.random.RandomState(hvd.rank())
    x = torch.from_numpy(rng.rand(args.batch_size, 28, 28, 1)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 10, size=(args.batch_size,))).to(dev)

    gen = torch.Generator(device=dev).manual_seed(1 + hvd.rank())
    model = mnist.ConvNet(device=dev, generator=gen)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr * hvd.size(),
                        momentum=0.5),
        named_parameters=model.named_parameters())
    model.train()
    losses = []
    for step in range(args.steps):
        opt.zero_grad()
        logits = model(x, deterministic=False, generator=gen)
        loss = F.cross_entropy(logits, y)
        loss.backward()
        opt.step()
        losses.append(float(hvd.allreduce(loss.detach(),
                                          name=f"loss.{step}")))
    if hvd.rank() == 0:
        print(f"DONE mnist first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"size={hvd.size()} device={dev}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()

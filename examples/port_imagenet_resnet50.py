"""ResNet-50 ImageNet training with the PyTorch/CUDA port: the reference's
``examples/pytorch/pytorch_imagenet_resnet50.py`` workflow on the port's
``resnet50`` (``horovod_tpu_torch.models.resnet``, flax's ResNet-v1.5
numerics: bf16 convolutions, fp32 batch norm).

Per-parameter gradient hooks feed async allreduces
(``DistributedOptimizer``, optionally over several backward passes and
with an fp16 wire), the learning rate scaled by the world size with a
linear warm-up, SGD with momentum, the loss averaged across ranks, the
batch statistics synchronized across ranks with ``--sync-bn``.  No
ImageNet is read: the images are synthetic, shaped by the flags.  The
defaults are ImageNet's geometry at a per-card batch of 32.

    python -m horovod_tpu_torch.runner -np 2 -- \\
        python examples/port_imagenet_resnet50.py
    (add --platform cpu to both, and small flags, without a card)
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
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--base-lr", type=float, default=0.0125)
    p.add_argument("--warmup-steps", type=int, default=5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--batches-per-allreduce", type=int, default=1,
                   help="† local gradient aggregation "
                        "(backward_passes_per_step)")
    p.add_argument("--fp16-allreduce", action="store_true")
    p.add_argument("--sync-bn", action="store_true",
                   help="batch statistics over every rank's batch")
    args = p.parse_args()
    if args.platform:
        os.environ["HVDTPU_PLATFORM"] = args.platform

    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet

    hvd.init()
    dev = hvd.device()
    # The norms' group is a new one: the runtime's engine issues the
    # gradients' allreduces on the world group from its own thread while
    # the backward runs, and one group's collectives must come in one
    # order on every rank.
    group = dist.new_group(list(range(hvd.size()))) if args.sync_bn \
        else None
    model = resnet.resnet50(
        num_classes=args.num_classes, device=dev, group=group,
        generator=torch.Generator(device=dev).manual_seed(42))
    model = model.to(memory_format=torch.channels_last)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    lr = args.base_lr * hvd.size() * args.batches_per_allreduce
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=args.momentum),
        named_parameters=model.named_parameters(),
        compression=(hvd.Compression.fp16 if args.fp16_allreduce
                     else hvd.Compression.none),
        backward_passes_per_step=args.batches_per_allreduce)

    rng = np.random.RandomState(hvd.rank())
    s = args.image_size
    images = torch.from_numpy(rng.rand(args.batch_size, s, s, 3)
                              .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.randint(
        0, args.num_classes, size=(args.batch_size,))).to(dev)
    model.train()
    losses = []
    for step in range(args.steps):
        for group in opt.param_groups:     # linear warm-up to lr
            group["lr"] = lr * min(1.0, (step + 1) / args.warmup_steps)
        opt.zero_grad()
        for _ in range(args.batches_per_allreduce):
            loss = F.cross_entropy(model(images), labels)
            loss.backward()
        opt.step()
        losses.append(float(hvd.allreduce(loss.detach(),
                                          name=f"loss.{step}")))
    if hvd.rank() == 0:
        print(f"DONE resnet50 first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"size={hvd.size()} device={dev}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()

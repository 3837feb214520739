"""ResNet-50 v1.5 trained through the port: ``models/resnet.py``
``resnet50`` (bf16 convolutions in ``channels_last``, fp32 batch norm
and head) holding the weights the benchmark makes from the seed,
``broadcast_parameters`` and ``DistributedOptimizer(torch.optim.SGD)``
with momentum, one batch of the traffic's images a step."""

from __future__ import annotations

import torch
import torch.nn.functional as F

RATE_METRIC = "train_images_per_s"


class Program:
    def __init__(self, cell, seed: int, device, hvd):
        from horovod_tpu_torch.models import resnet

        c, tr = cell.config, cell.traffic
        self.ref = cell.reference()
        self.config, self.seed, self.device = c, seed, device
        model = resnet.ResNet(stage_sizes=tuple(c["stage_sizes"]),
                              num_classes=c["num_classes"],
                              width=c["width"],
                              dtype=getattr(torch, c["conv_dtype"]),
                              device="meta")
        model.load_state_dict(self.ref.make_weights(c, seed, device),
                              assign=True)
        self.model = model.to(memory_format=torch.channels_last).train()
        self.named = list(self.model.named_parameters())
        hvd.broadcast_parameters(self.named, root_rank=0)
        o = tr["optimizer"]
        self.opt = hvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in self.named], lr=o["lr"],
                            momentum=o["momentum"]),
            named_parameters=self.named)
        images, labels = self.ref.make_rows(c, tr, seed, device)
        self.images, self.labels = images[hvd.rank()], labels[hvd.rank()]
        self.work_per_step = tr["batch"]

    def step(self, i: int) -> torch.Tensor:
        j = i % len(self.images)
        self.opt.zero_grad()
        loss = F.cross_entropy(self.model(self.images[j]), self.labels[j])
        loss.backward()
        self.opt.step()
        return loss.detach()

    def read_grad1(self) -> dict:
        """After one SGD step the momentum buffer is the gradient (a leaf
        the optimizer never stepped reads 0)."""
        out = {}
        for n, p in self.named:
            b = self.opt.state.get(p, {}).get("momentum_buffer")
            out[n] = 0.0 if b is None else \
                torch.linalg.vector_norm(b).item()
        return out

    def read_change(self) -> dict:
        p0 = self.ref.make_weights(self.config, self.seed, self.device)
        return {n: torch.linalg.vector_norm(p.detach() - p0[n]).item()
                for n, p in self.named}

    def free(self) -> None:
        self.model = self.named = self.opt = None

"""MNIST ConvNet, the port of ``horovod_tpu/models/mnist.py`` (config 1 of
BASELINE.json).

conv 16@5x5 → max pool → conv 32@5x5 → dropout 0.25 → max pool → fc 64 →
dropout → fc 10, as the JAX package's ``ConvNet``:

- inputs are NHWC ``[B, 28, 28, 1]``, the JAX package's layout; inside,
  the NHWC tensor is read as NCHW in ``channels_last`` memory (a view);
- the convolutions pad "SAME" (2 a side for 5x5 at stride 1), the pools
  are 2x2 "VALID";
- the flatten is flax's NHWC order (h, w, c), so the first dense layer's
  weights carry across unchanged;
- dropout draws from an explicit ``torch.Generator``; ``deterministic``
  (the default, as in the reference) turns it off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import context
from . import _common as C


class ConvNet(nn.Module):
    """Small ConvNet for 28x28x1 inputs, 10 classes."""

    def __init__(self, features1: int = 16, features2: int = 32,
                 hidden: int = 64, num_classes: int = 10,
                 dropout_rate: float = 0.5, *, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        dev, gen = C.resolve(device, generator)
        self.dropout_rate = dropout_rate
        self.conv1 = nn.Conv2d(1, features1, 5, padding=2, device=dev)
        self.conv2 = nn.Conv2d(features1, features2, 5, padding=2,
                               device=dev)
        self.fc1 = nn.Linear(7 * 7 * features2, hidden, device=dev)
        self.fc2 = nn.Linear(hidden, num_classes, device=dev)
        for m in (self.conv1, self.conv2, self.fc1, self.fc2):
            fan_in = m.weight[0].numel()
            C.lecun_normal_(m.weight, fan_in, gen)
            if m.bias.device.type != "meta":
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``x``: ``[B, 28, 28, 1]``; logits ``[B, num_classes]``.  With
        ``deterministic=False`` dropout draws from ``generator``."""
        rate1 = 0.0 if deterministic else 0.25
        rate2 = 0.0 if deterministic else self.dropout_rate
        x = x.permute(0, 3, 1, 2)                    # NHWC as channels_last
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = C.dropout(self.conv2(x), rate1, generator)
        x = F.max_pool2d(F.relu(x), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's (h, w, c)
        x = F.relu(self.fc1(x))
        x = C.dropout(x, rate2, generator)
        return self.fc2(x)


def params_from_jax(variables: dict, device=None) -> dict:
    """The JAX package's ``ConvNet`` variables (numpy leaves) as this
    module's ``state_dict`` on ``device``."""
    dev = context.device(device)
    p = variables["params"]
    sd = {}
    for name, key in (("conv1", "Conv_0"), ("conv2", "Conv_1")):
        sd[f"{name}.weight"] = C.conv(p[key]["kernel"], dev)
        sd[f"{name}.bias"] = C.leaf(p[key]["bias"], dev)
    for name, key in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = C.dense(p[key], dev)
    return sd

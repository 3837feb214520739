"""What the model zoo's modules share: the JAX package's default
initializers drawn from an explicit ``torch.Generator``, and the carrying
of flax variables into a ``state_dict``."""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from .. import context

# flax's ``lecun_normal``: a normal truncated at two standard deviations,
# widened by this factor so the variance stays 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def resolve(device, generator: Optional[torch.Generator]):
    """(device, generator) of a module's construction: the device as
    :func:`~..context.device` resolves it, and a generator seeded with 0
    on that device when none is given.  On ``meta`` nothing is drawn."""
    dev = context.device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    return dev, generator


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's default kernel initializer, in place."""
    if w.device.type == "meta":
        return w
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std,
                                           2.0 * std, generator=generator)


def normal_(w: torch.Tensor, std: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if w.device.type == "meta":
        return w
    with torch.no_grad():
        return w.normal_(0.0, std, generator=generator)


def leaf(a: Any, dev: torch.device) -> torch.Tensor:
    """One flax leaf (numpy or anything ``np.asarray`` takes) as an fp32
    torch tensor on ``dev``."""
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True,
                                     order="C")).to(dev)


def dense(p: dict, dev: torch.device) -> tuple:
    """A flax ``Dense``'s (weight (out, in), bias) from its kernel
    (in, out) and bias."""
    return leaf(np.asarray(p["kernel"]).T, dev), leaf(p["bias"], dev)


def conv(kernel: Any, dev: torch.device) -> torch.Tensor:
    """A flax ``Conv`` kernel (HWIO) as a torch weight (OIHW)."""
    return leaf(np.asarray(kernel).transpose(3, 2, 0, 1), dev)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep each element with probability
    ``1 - rate`` (drawn from ``generator``) and scale the kept ones by
    ``1 / (1 - rate)``."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

"""ResNet-v1.5, the port of ``horovod_tpu/models/resnet.py`` (config 2 of
BASELINE.json): :class:`BottleneckBlock`, :class:`ResNet`,
:func:`resnet50` and :func:`resnet18_thin`.

What the JAX package's flax model does, done where it does it:

- **Layout.** Inputs are NHWC ``[B, H, W, 3]``; inside, an NHWC tensor is
  read as NCHW in ``channels_last`` memory (a view, and cuDNN's fast
  layout on Hopper).
- **"SAME" padding.** Every convolution and the stem's max pool pad as
  XLA's "SAME" does, from the input size: a total of
  ``max((ceil(n / s) - 1) s + k - n, 0)``, ``total // 2`` before and the
  rest after.  At stride 2 that is asymmetric (the 7x7/2 stem on 224:
  (2, 3); a 3x3/2 on an even size: (0, 1)), so the pad is an explicit
  ``F.pad`` (``-inf`` for the pool), never ``Conv2d(padding=)``.
- **Batch norm** (:class:`BatchNorm`) has flax's semantics, not
  ``torch.nn.BatchNorm2d``'s: statistics in fp32, the variance biased
  and computed as ``mean(x²) - mean(x)²`` (clipped at 0), the running
  statistics ``ra = 0.9 ra + 0.1 batch``; with a process group the mean
  and the mean of squares are averaged over it (flax's ``pmean`` over
  ``axis_name``), which makes it a synchronized batch norm.  The last
  norm of each block starts with a zero scale.  Under the runtime at
  more than one rank that group must be one of its own
  (``torch.distributed.new_group``): the world group, on which the
  runtime's engine issues the gradients' allreduces from its thread,
  raises ``ValueError``.
- **dtypes.** Convolutions cast their input and kernel to ``dtype``
  (bf16 by default) as ``nn.Conv(dtype=)`` does; norms compute and
  return fp32; the head is fp32; parameters stay fp32.

``self.training`` selects the batch statistics (the reference's
``train=True``) or the running ones.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import context
from ..parallel.comm import mean_across_group
from . import _common as C


def same_pads(size: int, k: int, s: int) -> tuple:
    """XLA's "SAME" (before, after) padding of one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0
              ) -> torch.Tensor:
    (t, b), (l, r) = (same_pads(x.shape[2], k, s),
                      same_pads(x.shape[3], k, s))
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


class Conv(nn.Module):
    """flax's ``nn.Conv(features, (k, k), strides=s, use_bias=False,
    dtype=)``: "SAME" padding, input and kernel cast to ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, *,
                 dtype: torch.dtype, device, generator) -> None:
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k,
                                               device=device))
        C.lecun_normal_(self.weight, cin * k * k, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pad_same(x.to(self.dtype), self.k, self.stride)
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
    dtype=float32, axis_name=)`` over the channels of an NCHW tensor."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, group=None, zero_scale: bool = False,
                 device) -> None:
        super().__init__()
        self.momentum, self.eps, self.group = momentum, eps, group
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.empty(features, device=device))
        self.register_buffer("var", torch.empty(features, device=device))
        if device.type != "meta":
            with torch.no_grad():
                self.scale.fill_(0.0 if zero_scale else 1.0)
                self.bias.zero_()
                self.mean.zero_()
                self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            stats = torch.stack([x.mean((0, 2, 3)),
                                 (x * x).mean((0, 2, 3))])
            if self.group is not None:
                stats = mean_across_group(stats, self.group)
            mean, mean2 = stats[0], stats[1]
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 (stride here, v1.5) → 1x1 (x4), each followed by a
    norm; a 1x1 projection of the input where the shape changes."""

    def __init__(self, cin: int, features: int, strides: int = 1,
                 projection: bool = False, *, group=None,
                 dtype: torch.dtype = torch.bfloat16, device,
                 generator) -> None:
        super().__init__()
        cv = dict(dtype=dtype, device=device, generator=generator)
        bn = dict(group=group, device=device)
        self.conv0 = Conv(cin, features, 1, **cv)
        self.bn0 = BatchNorm(features, **bn)
        self.conv1 = Conv(features, features, 3, strides, **cv)
        self.bn1 = BatchNorm(features, **bn)
        self.conv2 = Conv(features, features * 4, 1, **cv)
        self.bn2 = BatchNorm(features * 4, zero_scale=True, **bn)
        self.project = projection or strides != 1
        if self.project:
            self.conv3 = Conv(cin, features * 4, 1, strides, **cv)
            self.bn3 = BatchNorm(features * 4, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        residual = self.bn3(self.conv3(x)) if self.project else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet-v1.5 family; ``stage_sizes`` (3, 4, 6, 3) is ResNet-50.
    ``group``: a process group whose ranks share batch statistics (the
    reference's ``axis_name``), None for per-rank statistics."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, group=None, *,
                 device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        dev, gen = C.resolve(device, generator)
        self.dtype = dtype
        self.conv_init = Conv(3, width, 7, 2, dtype=dtype, device=dev,
                              generator=gen)
        self.bn_init = BatchNorm(width, group=group, device=dev)
        blocks, cin = [], width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                blocks.append(BottleneckBlock(
                    cin, width * 2 ** i,
                    strides=2 if j == 0 and i > 0 else 1,
                    projection=(j == 0), group=group, dtype=dtype,
                    device=dev, generator=gen))
                cin = width * 2 ** i * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=dev)
        C.lecun_normal_(self.head.weight, cin, gen)
        if dev.type != "meta":
            nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[B, H, W, 3]``; fp32 logits ``[B, num_classes]``."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)    # NHWC as channels_last
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(_pad_same(x, 3, 2, -math.inf), 3, 2)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean((2, 3)))


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, **kw)


def resnet18_thin(num_classes: int = 10, **kw) -> ResNet:
    """Small variant for tests and CI."""
    return ResNet(stage_sizes=(1, 1), width=8, num_classes=num_classes,
                  **kw)


def forward_macs(model: ResNet, image: int) -> int:
    """Multiply-adds of one image's forward through the convolutions and
    the head at ``image`` x ``image`` (norms, pools and adds not
    counted)."""
    macs, size = 0, image

    def conv(c: Conv, n: int) -> int:
        nonlocal macs
        out = -(-n // c.stride)
        cout, cin = c.weight.shape[:2]
        macs += out * out * cout * cin * c.k * c.k
        return out

    size = -(-conv(model.conv_init, size) // 2)       # the stem's pool
    for b in model.blocks:
        y = conv(b.conv0, size)
        y = conv(b.conv1, y)
        conv(b.conv2, y)
        if b.project:
            conv(b.conv3, size)
        size = y
    return macs + model.head.weight.numel()


def params_from_jax(variables: dict, device=None) -> dict:
    """The JAX package's ``ResNet`` variables (``params`` and
    ``batch_stats``, numpy leaves) as this module's ``state_dict`` on
    ``device``: kernels HWIO → OIHW, the head's (in, out) → (out, in)."""
    dev = context.device(device)
    p, bs = variables["params"], variables["batch_stats"]
    sd = {"conv_init.weight": C.conv(p["conv_init"]["kernel"], dev)}

    def norm(prefix: str, pp: dict, ss: dict) -> None:
        sd[f"{prefix}.scale"] = C.leaf(pp["scale"], dev)
        sd[f"{prefix}.bias"] = C.leaf(pp["bias"], dev)
        sd[f"{prefix}.mean"] = C.leaf(ss["mean"], dev)
        sd[f"{prefix}.var"] = C.leaf(ss["var"], dev)

    norm("bn_init", p["bn_init"], bs["bn_init"])
    i = 0
    while f"BottleneckBlock_{i}" in p:
        key = f"BottleneckBlock_{i}"
        for j in range(4):
            if f"Conv_{j}" not in p[key]:
                continue
            sd[f"blocks.{i}.conv{j}.weight"] = C.conv(
                p[key][f"Conv_{j}"]["kernel"], dev)
            norm(f"blocks.{i}.bn{j}", p[key][f"BatchNorm_{j}"],
                 bs[key][f"BatchNorm_{j}"])
        i += 1
    sd["head.weight"], sd["head.bias"] = C.dense(p["Dense_0"], dev)
    return sd


"""ResNet-50 v1.5's training step in plain PyTorch: the benchmark's inputs
(weights, images and labels, made from the seed) and the reference that
the program's first steps are held against.

The reference follows the published network: a 7x7/2 stem convolution,
batch norm, ReLU and a 3x3/2 max pool; bottleneck blocks 1x1 -> 3x3
(the stage's stride here, v1.5) -> 1x1 (x4), each convolution followed
by batch norm, a 1x1 projection with its norm on each stage's first
block, ReLU after the residual sum; global average pooling and a dense
head; the mean cross-entropy; SGD with momentum.  Convolutions pad as
"SAME" does (a stride-2 pad is uneven).  Batch norm uses the batch's
statistics, the biased variance as ``mean(x^2) - mean(x)^2`` (clipped at
0), epsilon 1e-5; the last norm of each block starts at scale 0.

It computes everything in float32 with TF32 off and imports nothing of
the program.  ``precision="fp8"`` (the control) rounds every
convolution's and the head's operands to fp8; ``fault`` plants
``half_batch`` or ``no_exchange``."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from portbench.harness.fp8 import operand


def _blocks(c: dict) -> list:
    """(index, cin, features, stride, projection) of every block."""
    out, cin, w = [], c["width"], c["width"]
    for i, n in enumerate(c["stage_sizes"]):
        for j in range(n):
            out.append((len(out), cin, w * 2 ** i,
                        2 if j == 0 and i > 0 else 1, j == 0))
            cin = w * 2 ** i * 4
    return out


def _shapes(c: dict) -> list:
    """(state_dict key, shape, fan_in) of every convolution and the head's
    weight, in the order they are drawn."""
    w, ch = c["width"], c["channels"]
    out = [("conv_init.weight", (w, ch, 7, 7), ch * 49)]
    for b, cin, f, _, proj in _blocks(c):
        out += [(f"blocks.{b}.conv0.weight", (f, cin, 1, 1), cin),
                (f"blocks.{b}.conv1.weight", (f, f, 3, 3), f * 9),
                (f"blocks.{b}.conv2.weight", (4 * f, f, 1, 1), f)]
        if proj:
            out.append((f"blocks.{b}.conv3.weight", (4 * f, cin, 1, 1), cin))
    cin = _blocks(c)[-1][2] * 4
    out.append(("head.weight", (c["num_classes"], cin), cin))
    return out


def _norms(c: dict) -> list:
    """(prefix, features, zero scale) of every batch norm."""
    out = [("bn_init", c["width"], False)]
    for b, _, f, _, proj in _blocks(c):
        out += [(f"blocks.{b}.bn0", f, False), (f"blocks.{b}.bn1", f, False),
                (f"blocks.{b}.bn2", 4 * f, c["zero_init_last_bn"])]
        if proj:
            out.append((f"blocks.{b}.bn3", 4 * f, False))
    return out


# -- the benchmark's inputs ------------------------------------------------

def make_weights(c: dict, seed: int, device) -> dict:
    """The model's parameters and batch-norm statistics from ``seed``, as
    a ``state_dict`` of the port's ``ResNet`` (fp32): every convolution
    and the head ``N(0, 1/fan_in)`` from one draw, norm scales 1 (0 for
    each block's last), biases 0, running means 0 and variances 1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes = _shapes(c)
    total = sum(math.prod(s) for _, s, _ in shapes)
    z = torch.randn(total, generator=gen, device=device)
    sd, at = {}, 0
    for key, shape, fan_in in shapes:
        n = math.prod(shape)
        sd[key] = (z[at:at + n] / math.sqrt(fan_in)).reshape(shape).clone()
        at += n
    sd["head.bias"] = torch.zeros(c["num_classes"], device=device)
    for prefix, f, zero in _norms(c):
        sd[f"{prefix}.scale"] = torch.full((f,), 0.0 if zero else 1.0,
                                           device=device)
        sd[f"{prefix}.bias"] = torch.zeros(f, device=device)
        sd[f"{prefix}.mean"] = torch.zeros(f, device=device)
        sd[f"{prefix}.var"] = torch.ones(f, device=device)
    return sd


def parameter_names(c: dict) -> list:
    names = [k for k, _, _ in _shapes(c)] + ["head.bias"]
    for prefix, _, _ in _norms(c):
        names += [f"{prefix}.scale", f"{prefix}.bias"]
    return names


def make_rows(c: dict, traffic: dict, seed: int, device) -> tuple:
    """Images ``[ranks, rows, batch, H, W, C]`` in [0, 1) and labels
    ``[ranks, rows, batch]``, from the seed's own generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ 0x5DEECE66D)
    lead = (traffic["ranks"], traffic["rows"], traffic["batch"])
    s = c["image_size"]
    images = torch.rand(lead + (s, s, c["channels"]), generator=gen,
                        device=device)
    labels = torch.randint(0, c["num_classes"], lead, generator=gen,
                           device=device)
    return images, labels


# -- the network -----------------------------------------------------------------

def same_pads(n: int, k: int, s: int) -> tuple:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad(x, k, s, value=0.0):
    (t, b), (l, r) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    return F.pad(x, (l, r, t, b), value=value)


def forward(p: dict, x: torch.Tensor, c: dict, precision: str):
    """Logits of images ``x`` ``[B, H, W, C]``; ``p`` maps the state_dict's
    parameter names to tensors."""
    eps = c["batch_norm"]["epsilon"]

    def conv(x, key, stride):
        w = p[key]
        k = w.shape[-1]
        return F.conv2d(operand(_pad(x, k, stride), precision),
                        operand(w, precision), stride=stride)

    def bn(x, prefix):
        mean = x.mean((0, 2, 3))
        var = torch.clamp_min((x * x).mean((0, 2, 3)) - mean * mean, 0.0)
        mul = torch.rsqrt(var + eps) * p[f"{prefix}.scale"]
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + p[f"{prefix}.bias"][:, None, None]

    x = x.permute(0, 3, 1, 2)
    x = F.relu(bn(conv(x, "conv_init.weight", 2), "bn_init"))
    x = F.max_pool2d(_pad(x, 3, 2, -math.inf), 3, 2)
    for b, _, _, s, proj in _blocks(c):
        pre = f"blocks.{b}"
        y = F.relu(bn(conv(x, f"{pre}.conv0.weight", 1), f"{pre}.bn0"))
        y = F.relu(bn(conv(y, f"{pre}.conv1.weight", s), f"{pre}.bn1"))
        y = bn(conv(y, f"{pre}.conv2.weight", 1), f"{pre}.bn2")
        r = bn(conv(x, f"{pre}.conv3.weight", s), f"{pre}.bn3") if proj \
            else x
        x = F.relu(r + y)
    pooled = x.mean((2, 3))
    return operand(pooled, precision) @ operand(p["head.weight"],
                                                  precision).t() \
        + p["head.bias"]


# -- the reference's steps -------------------------------------------------------

def readings(c: dict, traffic: dict, seed: int, device, *, rank: int = 0,
             world: int = 1, group=None, precision: str = "fp32",
             fault: Optional[str] = None) -> dict:
    """The reference's readings over ``traffic["check_steps"]`` SGD steps
    on this rank's batches (see ``harness/judge.py``)."""
    import torch.distributed as dist

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        opt = traffic["optimizer"]
        sd = make_weights(c, seed, device)
        names = parameter_names(c)
        p = {k: sd[k].clone().requires_grad_() for k in names}
        p0 = {k: sd[k] for k in names}
        del sd
        images, labels = make_rows(c, traffic, seed, device)
        images, labels = images[rank], labels[rank]
        buf: dict = {}
        out = {"loss": [], "grad1": {}, "change": {}, "gmax": {}}
        for t in range(traffic["check_steps"]):
            x, y = images[t], labels[t]
            if fault == "half_batch" and world == 1:
                x, y = x[:len(x) // 2], y[:len(y) // 2]
            loss = F.cross_entropy(forward(p, x, c, precision), y)
            out["loss"].append(loss.item())
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            del loss
            with torch.no_grad():
                for k, g in zip(names, grads):
                    if world > 1:
                        share = world
                        if fault == "half_batch":
                            share = world // 2
                            if rank >= share:
                                g = torch.zeros_like(g)
                        if fault != "no_exchange":
                            dist.all_reduce(g, group=group)
                            g = g / share
                    norm = torch.linalg.vector_norm(g).item()
                    out["gmax"][k] = max(out["gmax"].get(k, 0.0), norm)
                    if t == 0:
                        out["grad1"][k] = norm
                    buf[k] = g.clone() if t == 0 else \
                        buf[k].mul_(opt["momentum"]).add_(g)
                    p[k].add_(buf[k], alpha=-opt["lr"])
            del grads
        with torch.no_grad():
            for k in names:
                out["change"][k] = torch.linalg.vector_norm(
                    p[k] - p0[k]).item()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]

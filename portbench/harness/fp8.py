"""The control's precision: a product's operands rounded to fp8, e4m3 on
the way in and e5m2 for the gradient on the way back, one scale a tensor,
as a program that stepped down from bf16 would compute.  The plain
references call :func:`operand` on every product's operands."""

from __future__ import annotations

import torch


def _fp8(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / fmax
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product's operand at ``precision`` ("fp32" or "fp8")."""
    return _RoundFp8.apply(x) if precision == "fp8" else x

"""Gradient compression for cross-rank communication.

The port of ``horovod_tpu/ops/compression.py`` († ``horovod/torch/
compression.py``): ``hvd.Compression.none`` / ``hvd.Compression.fp16`` —
floating-point tensors are cast down before the allreduce and restored
after, halving wire bytes.  As in the JAX package, ``fp16`` casts to
bfloat16 (fp32's exponent range, no loss scaling) and ``fp16_ieee`` to
IEEE float16; ``bf16`` names the bfloat16 cast outright.

The block-scaled quantized wires (``int8``, ``fp8``) quantize inside the
collective and wait for ROADMAP section A 'Wire precision': naming them
raises.
"""

from __future__ import annotations

from typing import Any

import torch


class Compressor:
    """Interface († ``Compression`` class hierarchy)."""

    @staticmethod
    def compress(tensor: torch.Tensor) -> tuple[torch.Tensor, Any]:
        """Returns (compressed, ctx) where ctx is whatever decompress needs."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx: Any) -> torch.Tensor:
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Cast float tensors wider than 16 bits to 16 bits for the
    collective, restore after."""

    wire_dtype = torch.bfloat16

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point() and tensor.element_size() > 2:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class BF16Compressor(FP16Compressor):
    """The bfloat16 cast, by its own name."""


class IEEEFP16Compressor(FP16Compressor):
    """Exact reference parity: IEEE float16 wire format."""

    wire_dtype = torch.float16


class _QuantizedCompressor(Compressor):
    wire_mode = ""

    @classmethod
    def compress(cls, tensor):
        raise NotImplementedError(
            f"the {cls.wire_mode} wire quantizes inside the collective and "
            "is not ported yet (ROADMAP section A 'Wire precision')")

    decompress = compress


class Int8Compressor(_QuantizedCompressor):
    wire_mode = "int8"


class FP8Compressor(_QuantizedCompressor):
    wire_mode = "fp8"


def check_supported(compression) -> None:
    """Raise at construction, not at the first step, for a compressor the
    port cannot run."""
    if isinstance(compression, type) and \
            issubclass(compression, _QuantizedCompressor):
        compression.compress(None)


class Compression:
    """Namespace matching ``hvd.Compression.{none,fp16}`` (†)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    fp16_ieee = IEEEFP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    fp8 = FP8Compressor

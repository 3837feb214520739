"""Gradient compression for cross-rank communication.

The port of ``horovod_tpu/ops/compression.py`` († ``horovod/torch/
compression.py``): ``hvd.Compression.none`` / ``hvd.Compression.fp16`` —
floating-point tensors are cast down before the allreduce and restored
after, halving wire bytes.  As in the JAX package, ``fp16`` casts to
bfloat16 (fp32's exponent range, no loss scaling) and ``fp16_ieee`` to
IEEE float16; ``bf16`` names the bfloat16 cast outright.

Every compressor carries a ``wire_mode`` (:mod:`.reduction`).  The
block-scaled quantized entries (``int8``, ``fp8``) route engine-side
(:func:`routes_engine_side`): per-rank codes with independent scales
cannot be summed by a plain allreduce, so quantization happens inside the
collective and their host-side ``compress``/``decompress`` are the
identity.  The cast entries keep their host-side cast.
"""

from __future__ import annotations

from typing import Any

import torch


class Compressor:
    """Interface († ``Compression`` class hierarchy)."""

    #: the engine's wire mode for this compressor ("" = config default)
    wire_mode = ""

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
    wire_mode = "bf16"

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
    wire_mode = "fp16"


class Int8Compressor(NoneCompressor):
    """Block-scaled int8 wire, quantized inside the collective."""

    wire_mode = "int8"


class FP8Compressor(NoneCompressor):
    """Block-scaled fp8-e4m3 wire, quantized inside the collective."""

    wire_mode = "fp8"


def routes_engine_side(compression) -> bool:
    """True when a compressor rides the engine's wire mode instead of a
    host-side compress/decompress: the quantized entries."""
    from .reduction import QUANT_MODES
    return getattr(compression, "wire_mode", "") in QUANT_MODES


class Compression:
    """Namespace matching ``hvd.Compression.{none,fp16}`` (†), extended
    with the engine's quantized wire modes."""

    none = NoneCompressor
    fp16 = FP16Compressor
    fp16_ieee = IEEEFP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    fp8 = FP8Compressor

"""Reduction algebra: the wire precision of the collective engine.

The port of ``horovod_tpu/ops/reduction.py``.  One interface covers the
cast wires, the block-scaled quantized wires and Adasum's combine:

    wire_encode(x)  -> (wire, scales)   # what goes on the interconnect
    combine(parts)  -> accumulated      # how contributions reduce (fp32)
    wire_decode(w, scales) -> tensor    # back to math precision

Wire modes (``HVDTPU_WIRE_PRECISION`` / ``compression=``):

``fp32``
    The default: one full-precision ``all_reduce``.
``bf16`` / ``fp16``
    Cast wire: cast, ``all_reduce``, cast back.
``int8`` / ``fp8``
    Block-scaled quantized allreduce (EQuARX), decomposed so precision and
    schedule compose: reduce-scatter, accumulate, allgather.

    1. per-block absmax, then ``all_reduce(MAX)`` of the RAW absmax, so
       every rank quantizes with the shared scale (4 B a block);
    2. quantize into a narrow accumulation container and
       ``reduce_scatter`` it;
    3. dequantize, sum and average in fp32 on the owning shard;
    4. requantize the shard with local per-block scales and
       ``all_gather`` the 1-byte payload and the scales.

The reference's build functions make programs over a mesh; here each is a
function of this rank's tensor over a ``torch.distributed`` group, run on
the engine's stream like every other dispatch.  The numbers are the
reference's: the same operations in fp32 in the same order, ``round``
half to even in both packages, and exact sums of the int8 codes.

**The int8 container.**  The reference sums int8 codes in an int16
container (``horovod_tpu/ops/reduction.py:253``).  Neither NCCL nor Gloo
sums int16 (Gloo rejects it: "Invalid scalar type").  The port sums them
in **fp16** up to 16 ranks: fp16 holds every integer up to 2048 exactly
and ``16 * 127 = 2032``, so every partial sum, in any order, is exact, the
bits are the reference's and the wire stays 2 B an element.  Beyond 16
ranks only **int32** is exact, at 4 B an element.  :func:`container_dtype`
makes the choice; :func:`ring_wire_bytes` and ``hvd_wire_bytes_saved_total``
count the container actually used.  fp8 sums in fp16 as in the reference.
The 1-byte payloads go through ``all_gather`` as ``uint8`` views (Gloo
rejects ``float8_e4m3fn``).

When not to quantize: reductions that are not a per-element sum
(Adasum's dot products amplify the error, MIN/MAX would return the grid),
integer payloads, and payloads under ``quant_min_bytes``;
:func:`resolve_precision` applies all of these, as the reference's does.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from ..obs import REGISTRY as _obs

MODES = ("fp32", "bf16", "fp16", "int8", "fp8")
QUANT_MODES = ("int8", "fp8")
CAST_MODES = ("bf16", "fp16")
# Most ranks whose int8 code sums an fp16 container holds exactly.
INT8_FP16_RANKS = 16

_m_wire_saved = _obs.counter(
    "hvd_wire_bytes_saved_total",
    "interconnect bytes saved by wire-precision modes vs an fp32 ring "
    "allreduce of the same payloads", ("mode",))
_m_wire_mode = _obs.gauge(
    "hvd_wire_precision_mode",
    "1 for the wire precision mode currently in effect as the engine "
    "default, 0 otherwise", ("mode",))


def publish_mode_gauge(active: str) -> None:
    """Reflect the engine-default wire mode in the metrics plane."""
    for m in MODES:
        _m_wire_mode.labels(mode=m).set(1.0 if m == active else 0.0)


def f32_recip(v: float) -> float:
    """``1 / v`` rounded to float32.  XLA turns a division by a
    compile-time constant into a multiplication by its float32 reciprocal
    (seen on the CPU: ``x / 127.0`` differs from a true division in 4% of
    float32 values, ``x * float32(1/127)`` in none), so the reference's
    ``amax / qmax`` and ``x / n`` are those products; the quantized and
    cast pipelines here multiply by the same reciprocals to keep its
    bits."""
    return torch.tensor(1.0 / v, dtype=torch.float32).item()


def container_dtype(mode: str, n: int) -> torch.dtype:
    """The dtype a quantized mode's codes are summed in across ``n``
    ranks (module docstring)."""
    if mode == "int8":
        return torch.float16 if n <= INT8_FP16_RANKS else torch.int32
    return torch.float16


def account_wire(mode: str, logical_bytes: int, n: int, block: int,
                 itemsize: int = 4) -> None:
    """Record bytes-saved telemetry for one dispatched allreduce against
    the payload's own unquantized ring."""
    if not mode or mode == "fp32" or n <= 1 or logical_bytes <= 0:
        return
    saved = (ring_wire_bytes("fp32", logical_bytes, n, block, itemsize)
             - ring_wire_bytes(mode, logical_bytes, n, block, itemsize))
    if saved > 0:
        _m_wire_saved.labels(mode=mode).inc(saved)


def ring_wire_bytes(mode: str, logical_bytes: int, n: int,
                    block: int = 512, itemsize: int = 4) -> int:
    """Interconnect bytes per device for one ring allreduce: ``(n-1)/n``
    of, per logical element, ``2 * itemsize`` unquantized, 4 for a cast
    wire, and for a quantized wire the container out, 1 byte back and 4 B
    a block each way for the scales.  The reference counts a 2-byte
    container always; here int8 beyond 16 ranks counts its int32."""
    numel = logical_bytes // max(1, itemsize)
    frac = (n - 1) / n if n > 1 else 0.0
    if mode in CAST_MODES:
        per_elem = 4.0
    elif mode in QUANT_MODES:
        acc = torch.empty((), dtype=container_dtype(mode, n)).element_size()
        per_elem = acc + 1.0 + 8.0 / block
    else:
        per_elem = 2.0 * itemsize
    return int(frac * per_elem * numel)


def resolve_precision(requested: str, op: Any, dtype: torch.dtype,
                      nbytes: int, cfg, n: int) -> str:
    """The wire mode of one allreduce, from values every rank agrees on
    (op, dtype, size, synchronized config), so fused groups and
    negotiation metas match across processes.  ``requested`` is the
    per-call override ("" defers to ``cfg.wire_precision``).  fp32 for
    one rank, non-sum ops, non-float payloads, 16-bit payloads under a
    cast mode, quantized payloads under ``quant_min_bytes`` and rank
    counts that would overflow the reference's narrow containers."""
    from .collectives import ReduceOp
    mode = requested or getattr(cfg, "wire_precision", "fp32") or "fp32"
    if mode not in MODES:
        raise ValueError(
            f"unknown wire precision {mode!r}; expected one of {MODES}")
    if mode == "fp32" or n <= 1:
        return "fp32"
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        return "fp32"
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        return "fp32"
    if dtype.itemsize <= 2 and mode in CAST_MODES:
        return "fp32"       # already 16-bit: casting saves nothing
    if mode in QUANT_MODES:
        if nbytes < getattr(cfg, "quant_min_bytes", 0):
            return "fp32"
        if n > (256 if mode == "int8" else 146):
            return "fp32"
    return mode


def as_wire_mode(compression: Any) -> str:
    """The public ``compression=`` argument as a wire mode string: a mode
    string, a ``hvd.Compression`` entry (its ``wire_mode``), or None for
    the config default ("")."""
    if compression is None:
        return ""
    if isinstance(compression, str):
        if compression and compression not in MODES:
            raise ValueError(
                f"unknown wire precision {compression!r}; "
                f"expected one of {MODES}")
        return compression
    mode = getattr(compression, "wire_mode", None)
    if mode is not None:
        return mode
    raise TypeError(
        f"compression must be a mode string {MODES}, a hvd.Compression "
        f"entry, or None; got {type(compression).__name__}")


# ---------------------------------------------------------------------------
# Algebras
# ---------------------------------------------------------------------------

class ReductionAlgebra:
    """wire_encode / combine / wire_decode.  ``wire_encode`` maps an fp32
    tensor whose last dim is the block axis onto (wire payload,
    scales-or-None); ``wire_decode`` inverts it into fp32; ``combine``
    reduces decoded per-rank contributions (dim 0)."""

    name = "fp32"

    def wire_encode(self, x: torch.Tensor):
        return x, None

    def wire_decode(self, wire: torch.Tensor, scales) -> torch.Tensor:
        return wire

    def combine(self, parts: torch.Tensor, group=None) -> torch.Tensor:
        return parts.sum(0)


class CastAlgebra(ReductionAlgebra):
    """Dtype-cast wire: ``Compression.fp16``'s semantics as an algebra."""

    def __init__(self, wire_dtype: torch.dtype, name: str) -> None:
        self.wire_dtype = wire_dtype
        self.name = name

    def wire_encode(self, x):
        return x.to(self.wire_dtype), None

    def wire_decode(self, wire, scales):
        return wire.float()


class BlockQuantAlgebra(ReductionAlgebra):
    """Block-scaled quantization to int8 or fp8-e4m3.  ``wire_encode``
    takes local per-block scales, or a ``shared_scale`` the ranks agreed
    on (the reduce-scatter phase, where codes must sum exactly)."""

    def __init__(self, mode: str) -> None:
        self.name = mode
        if mode == "int8":
            self.qmax = 127.0
            self.wire_dtype = torch.int8
        elif mode == "fp8":
            self.qmax = 448.0              # f8e4m3 max normal
            self.wire_dtype = torch.float8_e4m3fn
        else:
            raise ValueError(f"not a quantized mode: {mode!r}")
        self._inv_qmax = f32_recip(self.qmax)

    @staticmethod
    def block_absmax(blocks: torch.Tensor) -> torch.Tensor:
        """Raw per-block absmax.  Ranks agree on the MAX of this, and only
        then take :meth:`scale_from_absmax`: a MAX of finished scales
        would let one rank's all-zero block (1.0 sentinel) quantize every
        other rank's small values to zero."""
        return blocks.abs().amax(dim=-1)

    def scale_from_absmax(self, amax: torch.Tensor) -> torch.Tensor:
        """Quantization step; 1.0 for all-zero blocks so encode and
        decode stay finite."""
        return torch.where(amax > 0, amax * self._inv_qmax, 1.0)

    def block_scales(self, blocks: torch.Tensor) -> torch.Tensor:
        return self.scale_from_absmax(self.block_absmax(blocks))

    def wire_encode(self, blocks, shared_scale: Optional[torch.Tensor] = None):
        scale = (self.block_scales(blocks) if shared_scale is None
                 else shared_scale)
        q = blocks / scale[..., None]
        if self.wire_dtype == torch.int8:
            q = torch.round(q)          # half to even, as jnp.round
        # fp8: the cast itself rounds onto the e4m3 grid.
        return q.to(self.wire_dtype), scale

    def wire_decode(self, wire, scales):
        return wire.float() * scales[..., None]


class AdasumAlgebra(ReductionAlgebra):
    """Adasum's pairwise projection as a combine hook: the log2(n) tree
    over shards, each pair's dot and norms summed across the group so the
    projection uses the full vectors' inner products.  The wire stays
    full precision."""

    name = "adasum"

    def combine(self, parts: torch.Tensor, group=None) -> torch.Tensor:
        vecs = [parts[i] for i in range(parts.shape[0])]
        while len(vecs) > 1:
            nxt = [self._pair_combine(vecs[i], vecs[i + 1], group)
                   for i in range(0, len(vecs) - 1, 2)]
            if len(vecs) % 2:
                nxt.append(vecs[-1])
            vecs = nxt
        return vecs[0]

    @staticmethod
    def _pair_combine(a, b, group=None):
        """adasum(a, b) over shards: the three scalars summed over the
        group's shards first, so they are the whole vectors'."""
        import torch.distributed as dist
        a32, b32 = a.float(), b.float()
        partial = torch.stack([torch.sum(a32 * b32), torch.sum(a32 * a32),
                               torch.sum(b32 * b32)])
        dist.all_reduce(partial, group=group)
        dot, na, nb = partial[0], partial[1], partial[2]
        ca = torch.where(na > 0, 1.0 - dot / (2.0 * na.clamp(min=1e-30)), 1.0)
        cb = torch.where(nb > 0, 1.0 - dot / (2.0 * nb.clamp(min=1e-30)), 1.0)
        return (ca * a32 + cb * b32).to(a.dtype)


_ALGEBRAS = {
    "fp32": ReductionAlgebra(),
    "bf16": CastAlgebra(torch.bfloat16, "bf16"),
    "fp16": CastAlgebra(torch.float16, "fp16"),
    "int8": BlockQuantAlgebra("int8"),
    "fp8": BlockQuantAlgebra("fp8"),
}


def algebra_for(mode: str) -> ReductionAlgebra:
    try:
        return _ALGEBRAS[mode]
    except KeyError:
        raise ValueError(
            f"unknown wire precision {mode!r}; expected one of {MODES}")


# ---------------------------------------------------------------------------
# Flat collectives over a group (one name each across torch versions)
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def reduce_scatter_flat(out: torch.Tensor, inp: torch.Tensor, group=None,
                        async_op: bool = False):
    """SUM ``inp`` over the group; this rank keeps its ``out.numel()``
    slice (rank order)."""
    dist = _dist()
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    return fn(out, inp, group=group, async_op=async_op)


def all_gather_flat(out: torch.Tensor, inp: torch.Tensor, group=None,
                    async_op: bool = False):
    """Every rank's ``inp`` into ``out``, rank-major.  1-byte float
    payloads travel as ``uint8``."""
    dist = _dist()
    if inp.dtype == torch.float8_e4m3fn:
        out, inp = out.view(torch.uint8), inp.view(torch.uint8)
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    return fn(out, inp, group=group, async_op=async_op)


def _pad(flat: torch.Tensor, plen: int) -> torch.Tensor:
    if plen == flat.numel():
        return flat
    return torch.cat([flat, flat.new_zeros(plen - flat.numel())])


def _padded_len(numel: int, n: int, block: int) -> int:
    return max(1, math.ceil(numel / (n * block))) * n * block


# ---------------------------------------------------------------------------
# The quantized pipeline, one unit per schedule step (the executor walks
# them per chunk; the monolithic allreduce runs them once)
# ---------------------------------------------------------------------------

def quant_reduce_scatter(chunk: torch.Tensor, mode: str, group, n: int,
                         block: int, prescale: float = 1.0,
                         async_op: bool = False):
    """Encode + reduce-scatter of one block-aligned chunk (``clen``
    elements, a multiple of ``n * block``): the shared scale (MAX of the
    raw absmax, then the zero sentinel), the codes against it, and a
    ``reduce_scatter`` of the container.  Returns ``(acc, my_scale,
    work)``; ``work`` is the pending reduce-scatter with ``async_op``."""
    dist = _dist()
    alg = algebra_for(mode)
    x = chunk.float()
    if prescale != 1.0:
        x = x * prescale
    blocks = x.view(-1, block)
    amax = alg.block_absmax(blocks)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    shared = alg.scale_from_absmax(amax)
    q, _ = alg.wire_encode(blocks, shared_scale=shared)
    cont = q.view(-1).to(container_dtype(mode, n))
    acc = cont.new_empty(cont.numel() // n)
    work = reduce_scatter_flat(acc, cont, group, async_op=async_op)
    sb = blocks.shape[0] // n
    me = dist.get_rank(group) if n > 1 else 0
    return acc, shared[me * sb:(me + 1) * sb], work


def quant_combine(acc: torch.Tensor, my_scale: torch.Tensor, mode: str,
                  block: int, n: int, average: bool):
    """Dequantize the summed shard in fp32 (and average), then
    requantize it with local per-block scales: ``(wire, scales)``."""
    alg = algebra_for(mode)
    accf = alg.wire_decode(acc.view(-1, block), my_scale)
    if average:
        accf = accf * f32_recip(n)
    w2, s2 = alg.wire_encode(accf)
    return w2.view(-1), s2


def quant_all_gather(w2: torch.Tensor, s2: torch.Tensor, mode: str, group,
                     n: int, block: int,
                     postscale: float = 1.0) -> torch.Tensor:
    """Allgather of every rank's codes and scales, decoded to fp32."""
    alg = algebra_for(mode)
    gw = w2.new_empty(w2.numel() * n)
    gs = s2.new_empty(s2.numel() * n)
    all_gather_flat(gw, w2, group)
    all_gather_flat(gs, s2, group)
    out = alg.wire_decode(gw.view(-1, block), gs).view(-1)
    if postscale != 1.0:
        out = out * postscale
    return out


def quant_allreduce(x: torch.Tensor, op, mode: str, group, n: int,
                    block: int, prescale: float = 1.0,
                    postscale: float = 1.0) -> torch.Tensor:
    """The monolithic quantized allreduce of ``x`` (reference
    ``_build_quant_allreduce``): the payload padded to ``n * block``
    units, one pass of the three units above; a new tensor of ``x``'s
    shape and dtype."""
    from .collectives import ReduceOp
    numel = x.numel()
    flat = _pad(x.reshape(-1), _padded_len(numel, n, block))
    acc, my_scale, _ = quant_reduce_scatter(flat, mode, group, n, block,
                                            prescale)
    w2, s2 = quant_combine(acc, my_scale, mode, block, n,
                           op is ReduceOp.AVERAGE)
    out = quant_all_gather(w2, s2, mode, group, n, block, postscale)
    return out[:numel].view(x.shape).to(x.dtype)


def cast_allreduce(x: torch.Tensor, op, mode: str, group, n: int,
                   prescale: float = 1.0,
                   postscale: float = 1.0) -> torch.Tensor:
    """Cast wire (reference ``_build_cast_allreduce``): prescale in the
    payload's dtype, cast, ``all_reduce``, back to fp32, average and
    postscale there; a new tensor of ``x``'s dtype."""
    from .collectives import ReduceOp
    alg = algebra_for(mode)
    if prescale != 1.0:
        x = x * torch.tensor(prescale, dtype=x.dtype)
    wire, _ = alg.wire_encode(x)
    wire = wire.contiguous()
    _dist().all_reduce(wire, group=group)
    out = alg.wire_decode(wire, None)
    if op is ReduceOp.AVERAGE:
        out = out * f32_recip(n)
    if postscale != 1.0:
        out = out * postscale
    return out.to(x.dtype)


def allreduce(x: torch.Tensor, op, mode: str, group, n: int, *,
              block: int = 512, prescale: float = 1.0,
              postscale: float = 1.0) -> torch.Tensor:
    """One allreduce at a cast or quantized wire mode (fp32 callers use
    :func:`.collectives.allreduce_`)."""
    if mode in CAST_MODES:
        return cast_allreduce(x, op, mode, group, n, prescale, postscale)
    if mode in QUANT_MODES:
        return quant_allreduce(x, op, mode, group, n, block, prescale,
                               postscale)
    raise ValueError(f"reduction.allreduce: unexpected mode {mode!r}")


def decomposed_allreduce(x: torch.Tensor, algebra: ReductionAlgebra,
                         group, n: int) -> torch.Tensor:
    """Generic reduce-scatter -> combine -> allgather with a pluggable
    combine (reference ``build_decomposed_allreduce``): an
    ``all_to_all_single`` hands this rank shard *me* of every rank's
    vector, ``algebra.combine`` folds the n of them (with the group for
    any cross-shard scalars, e.g. Adasum's), and an ``all_gather``
    rebuilds the whole result.  The reference's only caller, Adasum,
    keeps a full-precision wire, and so does this: the algebra's wire
    carries no scales."""
    dist = _dist()
    numel = x.numel()
    plen = max(1, math.ceil(numel / n)) * n
    xs = _pad(x.reshape(-1), plen).view(n, plen // n)
    wire = algebra.wire_encode(xs)[0].contiguous()
    parts = torch.empty_like(wire)
    dist.all_to_all_single(parts, wire, group=group)
    acc = algebra.combine(parts, group).contiguous()
    g = acc.new_empty(plen)
    all_gather_flat(g, acc, group)
    return g[:numel].view(x.shape).to(x.dtype)


def in_context_allreduce(x: torch.Tensor, group, mode: str, average: bool,
                         block: int = 512) -> torch.Tensor:
    """Allreduce of one tensor in the psum form (reference
    ``in_context_allreduce``): for quantized modes the shared scales, then
    one ``all_reduce`` of the container, no scatter phase and no
    requantization.  A new tensor of ``x``'s dtype."""
    dist = _dist()
    n = dist.get_world_size(group)
    if mode in QUANT_MODES and n > (256 if mode == "int8" else 146):
        mode = "fp32"
    if mode == "fp32" or n <= 1:
        red = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(red, group=group)
        return red * f32_recip(n) if average else red
    alg = algebra_for(mode)
    if mode in CAST_MODES:
        wire = alg.wire_encode(x)[0].contiguous()
        dist.all_reduce(wire, group=group)
        red = alg.wire_decode(wire, None)
        red = red * f32_recip(n) if average else red
        return red.to(x.dtype)
    numel = x.numel()
    xf = _pad(x.float().reshape(-1), max(1, math.ceil(numel / block)) * block)
    blocks = xf.view(-1, block)
    amax = alg.block_absmax(blocks)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    shared = alg.scale_from_absmax(amax)
    q, _ = alg.wire_encode(blocks, shared_scale=shared)
    acc = q.to(container_dtype(mode, n))
    dist.all_reduce(acc, group=group)
    out = alg.wire_decode(acc, shared).view(-1)[:numel]
    if average:
        out = out * f32_recip(n)
    return out.view(x.shape).to(x.dtype)

"""Adasum: scale-invariant gradient combination.

The port of ``horovod_tpu/ops/adasum.py`` († ``horovod/common/ops/adasum``;
Maleki et al., arXiv:2006.02924).  A pair combines as

    adasum(a, b) = (1 - (a.b) / (2 |a|^2)) a  +  (1 - (a.b) / (2 |b|^2)) b

and n ranks reduce by recursive pairwise combination.  As in the
reference, one allreduce is the decomposed pipeline of
:func:`.reduction.decomposed_allreduce` with
:class:`.reduction.AdasumAlgebra` as its combine: an ``all_to_all``
hands each rank shard *i* of every rank's vector, the pairwise tree runs
over shards with each pair's dot and norms summed across the group, and
an ``all_gather`` rebuilds the result — O(numel) memory a rank.  The wire
stays full precision (``resolve_precision`` never quantizes Adasum), and
the projection is not elementwise, so the engine never fuses two Adasum
tensors into one dispatch.
"""

from __future__ import annotations

import torch

from .reduction import AdasumAlgebra, decomposed_allreduce

_ALGEBRA = AdasumAlgebra()


def adasum_allreduce(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Adasum-reduce this rank's ``x`` over ``group`` of ``n`` ranks; a
    new tensor of ``x``'s shape and dtype."""
    return decomposed_allreduce(x, _ALGEBRA, group, n)

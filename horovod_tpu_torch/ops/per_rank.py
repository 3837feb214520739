"""Per-rank tensors for a process that holds one rank.

The port of the host helpers of ``horovod_tpu/ops/collectives.py``
(``per_rank`` :131, ``per_rank_from_fn`` :155, ``to_numpy`` :181,
``from_local`` :186, ``replicate_local`` :212, ``to_local`` :232).  There
one process drives every device of a host, and a per-rank tensor is one
global ``[num_ranks, *shape]`` array whose row ``i`` is rank ``i``'s
tensor.  Here, as in upstream Horovod, a process is one rank and its
per-rank tensor is its own row: a tensor of ``shape`` on the runtime's
device.  So each helper keeps the reference's checks and gives this rank
its row; the rows of every rank, in rank order, are the reference's
array.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from .. import context


def _as_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(context.device())
    return torch.as_tensor(np.asarray(value), device=context.device())


def per_rank(values: Sequence[Any], process_set=None) -> torch.Tensor:
    """This rank's tensor from one value a rank (``values[i]`` is rank
    ``i``'s), on the runtime's device, after the reference's check: one
    value a rank of the set, all of one shape and dtype (its controller's
    shape-consistency check)."""
    n = context.size() if process_set is None else process_set.size()
    if len(values) != n:
        raise ValueError(f"expected {n} per-rank values, got {len(values)}")
    arrs = [np.asarray(v) for v in values]
    shapes = {a.shape for a in arrs}
    dtypes = {a.dtype for a in arrs}
    if len(shapes) != 1 or len(dtypes) != 1:
        raise ValueError(
            "mismatched shapes/dtypes across ranks: "
            f"{sorted(map(str, shapes))} / {sorted(map(str, dtypes))} "
            "(reference parity: coordinator shape-consistency check)")
    me = context.rank() if process_set is None \
        else process_set.rank_of(context.rank())
    return _as_tensor(arrs[me])


def per_rank_from_fn(fn: Callable[[int], Any],
                     process_set=None) -> torch.Tensor:
    """``per_rank([fn(0), fn(1), ...])``: ``fn`` is called for every rank,
    so the check sees every rank's value."""
    n = context.size() if process_set is None else process_set.size()
    return per_rank([fn(i) for i in range(n)], process_set=process_set)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """A result in host memory; bfloat16 comes back as float32 (numpy has
    no bfloat16)."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def from_local(x: Any, process_set=None) -> torch.Tensor:
    """This process's rows, ``[local_ranks, *shape]`` with one row a rank
    it drives (one here), as its per-rank tensor on the runtime's device:
    row 0."""
    x = np.asarray(x)
    if x.ndim < 1 or x.shape[0] != 1:
        raise ValueError(f"expected 1 local rows, got "
                         f"{x.shape[0] if x.ndim else 0}")
    return _as_tensor(x[0])


def replicate_local(value: Any, process_set=None) -> torch.Tensor:
    """The per-rank tensor in which every rank this process drives holds
    ``value``: ``value`` on the runtime's device, one host-to-device
    copy."""
    return _as_tensor(value)


def to_local(x: torch.Tensor) -> np.ndarray:
    """The rows of a per-rank result that this process's ranks own, in
    host memory: ``[1, *shape]``, this rank's row."""
    return to_numpy(x)[None]

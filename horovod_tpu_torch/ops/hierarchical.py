"""Hierarchical (two-tier) allreduce: within a node, then across nodes.

The port of ``horovod_tpu/ops/hierarchical.py``.  † ``nccl_operations.cc``
``HOROVOD_HIERARCHICAL_ALLREDUCE`` splits an allreduce into a
reduce-scatter within the node, an allreduce across nodes on the
scattered shards and an allgather back, because NVLink inside a node is
an order of magnitude faster than the fabric between nodes:

    reduce_scatter over 'local' (NVLink)       # bytes a rank: B
    allreduce     over 'cross' (the fabric)    # bytes a rank: B / n_local
    all_gather    over 'local' (NVLink)        # bytes a rank: B

The tiers are a 2-D ``(cross, local)`` layout of the ranks, row-major as
the reference's ``_hier_mesh`` builds it: rank ``c * n_local + l`` is
local index ``l`` of node ``c``; its local group is the ranks
``[c*n_local, (c+1)*n_local)``, its cross group local index ``l`` of
every node.  Any other layout changes the fp32 sums' order.

Enabled by ``HVDTPU_HIERARCHICAL_ALLREDUCE`` (with
``HVDTPU_HIERARCHICAL_LOCAL_SIZE``, else the launcher's local size): the engine's monolithic fp32 allreduce,
fused or not, rides :func:`hierarchical_allreduce_` for SUM and float
AVERAGE when the split is valid (:func:`.collectives._hier_split`), and a
decomposed request upgrades to the chunked ``hier:<n_local>:<k>``
executor schedule (:mod:`.sched.executor`).  The tier groups are created
by :func:`tier_groups` — collectively, on every rank in the same order —
when ``init`` sees a valid split; the engine's thread only looks them
up, never creates them (a ``new_group`` there would race other groups'
collectives).
"""

from __future__ import annotations

import time
from functools import lru_cache

import torch

HIER_AXES = ("hvd_cross", "hvd_local")


@lru_cache(maxsize=None)
def hierarchical_schedule(local_axis: str, cross_axis: str):
    """The two-tier IR schedule for an axis pair (cached: lowering is a
    pure function of the axis names)."""
    from .sched import lower_hierarchical
    return lower_hierarchical(local_axis, cross_axis)


def tier_groups(n_cross: int, n_local: int) -> dict:
    """This rank's tier groups of the ``(n_cross, n_local)`` split of the
    runtime's ranks, ``{"hvd_local": (group, n_local), "hvd_cross":
    (group, n_cross)}``, created on first use and kept until shutdown.
    Creating them is collective: every rank calls this for the same
    split, in the same order, outside the engine's thread."""
    from .. import context
    from ..parallel.mesh import _device_type
    state = context.global_state()
    key = (n_cross, n_local)
    groups = state.tier_groups.get(key)
    if groups is None:
        from torch.distributed.device_mesh import init_device_mesh
        if n_cross * n_local != state.size:
            raise ValueError(f"tiers {n_cross} x {n_local} do not cover "
                             f"{state.size} ranks")
        mesh = init_device_mesh(_device_type(), (n_cross, n_local),
                                mesh_dim_names=HIER_AXES)
        groups = {"hvd_local": (mesh.get_group("hvd_local"), n_local),
                  "hvd_cross": (mesh.get_group("hvd_cross"), n_cross)}
        state.tier_groups[key] = groups
    return groups


def created_tier_groups(n_cross: int, n_local: int) -> dict:
    """The groups :func:`tier_groups` made for this split; raises when it
    was never called (the engine's thread must not create them)."""
    from .. import context
    groups = context.global_state().tier_groups.get((n_cross, n_local))
    if groups is None:
        raise RuntimeError(
            f"the {n_cross} x {n_local} tier groups were never created: set "
            "hierarchical_allreduce (and hierarchical_local_size) before "
            "init, or call ops.hierarchical.tier_groups"
            f"({n_cross}, {n_local}) on every rank first")
    return groups


def hierarchical_allreduce_local(v: torch.Tensor, groups: dict, *,
                                 local_axis: str = "hvd_local",
                                 cross_axis: str = "hvd_cross",
                                 average: bool = False) -> torch.Tensor:
    """Two-tier allreduce of this rank's ``v`` over ``groups`` (axis name
    -> (group, size)): the global sum (or mean), the cross hop carrying
    1/n_local of the bytes.  Lowered through the schedule IR, as in the
    reference: reduce-scatter over the local tier, allreduce of the shard
    over the cross tier, the AVERAGE's division, allgather back."""
    from .sched import run_in_context
    return run_in_context(hierarchical_schedule(local_axis, cross_axis),
                          v, groups, average=average)


def hierarchical_allreduce_(buf: torch.Tensor, op, n_cross: int,
                            n_local: int, *, prescale: float = 1.0,
                            postscale: float = 1.0) -> None:
    """The engine's monolithic two-tier route (reference
    ``_build_hier_allreduce``): ``buf`` (contiguous, this rank's whole
    payload, fused or not) becomes the SUM or AVERAGE over the split's
    ranks, pre- and postscaled in its dtype."""
    from .collectives import ReduceOp
    from .sched.executor import _scaled
    groups = created_tier_groups(n_cross, n_local)
    out = hierarchical_allreduce_local(
        _scaled(buf, prescale), groups, average=op is ReduceOp.AVERAGE)
    buf.copy_(_scaled(out, postscale))


def hierarchical_allreduce(x: torch.Tensor, mesh, *,
                           local_axis: str = "tp", cross_axis: str = "dp",
                           average: bool = False) -> torch.Tensor:
    """Standalone entry: this rank's tensor over a 2-D ``DeviceMesh``
    (:func:`~horovod_tpu_torch.parallel.mesh.build_mesh`, or any mesh
    with the two axes); every rank gets the full reduction.

    The tier groups are resolved, and one call of this shape warmed,
    before the timing window opens, so the first observation fed to
    ``observe_tiers`` holds no set-up time (the reference compiles
    outside its window for the same reason)."""
    from ..obs import perfmodel as _perf
    groups = {a: (mesh.get_group(a), mesh.size(mesh.mesh_dim_names.index(a)))
              for a in (local_axis, cross_axis)}
    key = (id(mesh), local_axis, cross_axis, average, tuple(x.shape),
           x.dtype)
    if key not in _WARMED:
        hierarchical_allreduce_local(x, groups, local_axis=local_axis,
                                     cross_axis=cross_axis, average=average)
        _WARMED.add(key)
    t0 = time.monotonic()
    out = hierarchical_allreduce_local(x, groups, local_axis=local_axis,
                                       cross_axis=cross_axis,
                                       average=average)
    if out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()
    n_local, n_cross = groups[local_axis][1], groups[cross_axis][1]
    _perf.MODEL.observe_tiers(x.numel() * x.element_size(), n_local,
                              n_cross, time.monotonic() - t0)
    return out


# Shapes hierarchical_allreduce has run once (its groups resolved, its
# first-call allocations made) before a timed call.
_WARMED: set = set()


def hierarchical_allgather_local(v: torch.Tensor, groups: dict, *,
                                 local_axis: str = "hvd_local",
                                 cross_axis: str = "hvd_cross"
                                 ) -> torch.Tensor:
    """† ``HOROVOD_HIERARCHICAL_ALLGATHER``: gather over the local tier
    first, then exchange the (bigger, but fewer) blocks across the cross
    tier; rows in rank order of the 2-D layout (cross-major)."""
    from .reduction import all_gather_flat
    out = v.contiguous()
    for axis in (local_axis, cross_axis):
        group, n = groups[axis]
        g = out.new_empty((n * out.shape[0],) + tuple(out.shape[1:]))
        all_gather_flat(g, out, group)
        out = g
    return out

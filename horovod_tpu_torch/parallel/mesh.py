"""Multi-axis rank mesh construction.

The port of ``horovod_tpu/parallel/mesh.py``.  The axis order is the
reference's, innermost (fastest-varying over the ranks) last::

    ('pp', 'dp', 'fsdp', 'ep', 'sp', 'tp')

- ``tp`` innermost: its activation reductions come every layer, so its
  ranks should share the fastest links (NVLink inside a node);
- ``sp``/``ep`` next: ring exchanges and alltoalls once a layer;
- ``dp``/``fsdp``: one gradient reduction a step;
- ``pp`` outermost: point-to-point hand-offs, the only axis that
  tolerates the inter-node fabric — the hierarchical split the reference
  implements as NCCL within a node and MPI across
  († ``nccl_operations.cc`` HOROVOD_HIERARCHICAL_ALLREDUCE).

Where the reference reshapes devices into a ``jax.sharding.Mesh``, here
:func:`build_mesh` lays the runtime's ranks out row-major in that order
as a ``torch.distributed.device_mesh.DeviceMesh``, which creates one
process group for every slice of every axis; :func:`build_mesh` adds one
for every slice of every set of two or more axes of size > 1 (the batch
axes ``("dp", "fsdp")``, the gradient reductions over several data
axes), kept as the mesh's ``hvd_axis_groups``.  Creating groups is
collective: every rank calls :func:`build_mesh` with the same config, in
the same order relative to its other group creations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each parallelism axis; the product must equal the number
    of ranks."""

    dp: int = 1      # data parallel (batch)
    fsdp: int = 1    # sharded-parameter data parallel (ZeRO-3 style)
    tp: int = 1      # tensor (Megatron) parallel
    sp: int = 1      # sequence/context parallel
    pp: int = 1      # pipeline parallel
    ep: int = 1      # expert parallel (MoE)

    @property
    def total(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.pp * self.ep

    def axis_sizes(self) -> dict[str, int]:
        return {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
                "ep": self.ep, "sp": self.sp, "tp": self.tp}

    @staticmethod
    def auto(n_devices: int) -> "MeshConfig":
        """Factorize ``n_devices`` across axes for a maximal exercise of
        every parallelism style: each prime factor, smallest first, goes
        to the next axis in the priority order tp, dp, pp, sp, ep, fsdp,
        round robin."""
        sizes = {"tp": 1, "dp": 1, "pp": 1, "sp": 1, "ep": 1, "fsdp": 1}
        order = ["tp", "dp", "pp", "sp", "ep", "fsdp"]
        for i, f in enumerate(sorted(_prime_factors(n_devices))):
            sizes[order[i % len(order)]] *= f
        return MeshConfig(**sizes)


def _prime_factors(n: int) -> list[int]:
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def _device_type() -> str:
    """The runtime's device type once ``init`` ran, else that of the
    default process group's backend."""
    import torch.distributed as dist

    from .. import context
    state = context.global_state()
    if state.initialized:
        return state.device.type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_mesh(config: MeshConfig, device_type: Optional[str] = None):
    """The multi-axis mesh over every rank of the default process group,
    axes in :data:`AXES` order, as a ``DeviceMesh`` whose
    ``mesh.get_group(axis)`` is this rank's group along ``axis``.
    ``device_type`` defaults to the runtime's (``"cuda"`` on the card,
    ``"cpu"`` over Gloo).  Collective: every rank calls it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs the process group: call "
                           "horovod_tpu_torch.init() first")
    n = dist.get_world_size()
    if config.total != n:
        raise ValueError(
            f"mesh sizes {config.axis_sizes()} multiply to {config.total} "
            f"but {n} ranks are available")
    shape = tuple(config.axis_sizes()[a] for a in AXES)
    mesh = init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=AXES)
    mesh.hvd_axis_groups = _axis_groups(config)
    return mesh


def _axis_groups(config: MeshConfig) -> dict:
    """A process group over every set of two or more axes of size > 1
    (keyed by the axes in :data:`AXES` order), this rank's.  Each set's
    groups are made in rank order, the sets in a fixed order, on every
    rank; a group's ranks run row-major over its axes, so its rank order
    is the order of the blocks that its axes split (``("dp", "fsdp")``:
    ``dp`` major).  :mod:`.comm` finds them here; a step never makes one."""
    import itertools

    import torch.distributed as dist

    sizes = config.axis_sizes()
    live = [a for a in AXES if sizes[a] > 1]
    me = dist.get_rank()
    coords = list(itertools.product(*(range(sizes[a]) for a in AXES)))
    out = {}
    for k in range(2, len(live) + 1):
        for axes in itertools.combinations(live, k):
            others = [i for i, a in enumerate(AXES) if a not in axes]
            members: dict = {}
            for rank, c in enumerate(coords):
                members.setdefault(tuple(c[i] for i in others), []).append(
                    rank)
            for ranks in members.values():
                group = dist.new_group(ranks)
                if me in ranks:
                    out[axes] = group
    return out


def data_axes() -> tuple[str, ...]:
    """Axes a global batch is sharded over (gradient-reduction axes)."""
    return ("dp", "fsdp")

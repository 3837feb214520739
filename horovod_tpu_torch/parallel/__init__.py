"""Parallelism beyond data parallel: the rank mesh and expert parallelism.

The port of ``horovod_tpu/parallel``, the pieces this slice needs:

- :mod:`.mesh` — the multi-axis rank mesh (``pp, dp, fsdp, ep, sp, tp``)
  as a ``torch.distributed.device_mesh.DeviceMesh`` over the runtime's
  ranks, one process group an axis slice;
- :mod:`.moe` — Switch-style top-1 MoE: the routing masks, the expert
  layer over an ``ep`` group's ``all_to_all`` and the job-scale layer
  over the engine's ``alltoall`` verb.

Logical sharding rules (``sharding.py``), tensor, sequence and pipeline
parallelism wait for ROADMAP section A 'Parallel strategies, and what
needs them'.
"""

from .mesh import AXES, MeshConfig, build_mesh, data_axes  # noqa: F401

"""Parallelism beyond data parallel: the rank mesh, logical sharding,
tensor, sequence, expert and pipeline parallelism.

The port of ``horovod_tpu/parallel``:

- :mod:`.mesh` — the multi-axis rank mesh (``pp, dp, fsdp, ep, sp, tp``)
  as a ``torch.distributed.device_mesh.DeviceMesh`` over the runtime's
  ranks, one process group an axis slice, and one a slice of every set
  of several axes;
- :mod:`.sharding` — the logical-axis rules as data (``DEFAULT_RULES``,
  ``spec_for``, ``fitted_rules``, ``spec_axes``) and a rank's block of a
  tensor (``shard``, ``unshard``, ``constrain``);
- :mod:`.comm` — collectives over mesh axes with Megatron's gradients
  (copy-to and reduce-from a region, all-gather, scatter, all-to-all);
- :mod:`.ring_attention` — ring and Ulysses attention over an ``sp``
  group;
- :mod:`.moe` — Switch-style top-1 MoE: the routing masks, the expert
  layer over an ``ep`` group's ``all_to_all`` and the job-scale layer
  over the engine's ``alltoall`` verb;
- :mod:`.pipeline` — GPipe and 1F1B microbatch schedules over the ``pp``
  group (point-to-point handoffs), with a one-process driver that runs
  every stage in memory, and generation's stage-to-stage chain.
"""

from .mesh import (  # noqa: F401
    AXES,
    MeshConfig,
    build_mesh,
    data_axes,
)

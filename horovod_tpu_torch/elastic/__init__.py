"""Elastic training: fault-tolerant loops with dynamic membership.

The port of ``horovod_tpu/elastic`` and of the reference's torch binding
(``horovod_tpu/torch/elastic.py``).  † ``horovod/common/elastic.py``
(``run`` decorator, ``State``, ``ObjectState``),
``horovod/torch/elastic/state.py`` (``TorchState``),
``horovod/runner/elastic/`` (the driver side:
:mod:`horovod_tpu_torch.runner.elastic`).

Protocol (†3.5): the user wraps the train loop in ``@hvd.elastic.run``
with a ``State``; on ``HorovodInternalError`` (a collective failed) the
loop restores the last committed snapshot, re-initializes the runtime
(a new process group and engine in this process) and retries; on
``HostsUpdatedInterrupt`` (the driver pushed a membership change) it
syncs state from rank 0 and continues; ``state.commit()`` snapshots at
batch boundaries.  Under the elastic driver (``HVDTPU_ELASTIC=1``) both
exit instead, with the reserved codes, and the driver relaunches the job
on the new assignment from durable state (``FileBackedState``,
:class:`~horovod_tpu_torch.utils.checkpoint.Checkpointer`).
"""

from .state import (  # noqa: F401
    FileBackedState,
    ObjectState,
    State,
    TorchState,
)
from .sampler import ElasticSampler  # noqa: F401
from .runner import (  # noqa: F401
    HostsUpdatedInterrupt,
    WorkerNotificationClient,
    run,
)
from ..context import HorovodInternalError  # noqa: F401

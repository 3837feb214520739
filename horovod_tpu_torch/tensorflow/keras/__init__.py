"""† ``horovod/tensorflow/keras/``: the tf.keras-flavoured surface of the
port.

Re-exports the Keras callbacks (shared with :mod:`horovod_tpu_torch.keras`,
as the reference shares ``horovod/_keras/``) with the TF binding's
``DistributedOptimizer``, ``broadcast_variables`` and basics.
"""

from horovod_tpu_torch.keras import (  # noqa: F401
    BroadcastGlobalVariablesCallback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
)
from horovod_tpu_torch.tensorflow import (  # noqa: F401
    Adasum,
    Average,
    Compression,
    DistributedOptimizer,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
    allgather,
    allreduce,
    broadcast,
    broadcast_object,
    broadcast_variables,
    cross_rank,
    cross_size,
    init,
    is_initialized,
    join,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)

# † the horovod.keras callbacks module alias (hvd.callbacks.*)
from horovod_tpu_torch import keras as callbacks  # noqa: E402,F401

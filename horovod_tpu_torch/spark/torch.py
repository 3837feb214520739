"""† ``horovod.spark.torch``: upstream users import the PyTorch estimator
as ``from horovod.spark.torch import TorchEstimator``.  The implementation
lives in ``horovod_tpu_torch/estimator``; this module is the
upstream-shaped import path for it (the JAX package's ``spark/jax.py``
holds its place there).
"""

from ..estimator import TorchEstimator, TorchModel
from ..estimator.store import LocalStore

__all__ = ["TorchEstimator", "TorchModel", "LocalStore"]

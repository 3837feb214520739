"""† ``horovod.spark.keras``: upstream users import the Keras estimator as
``from horovod.spark.keras import KerasEstimator``.  The implementation
lives in ``horovod_tpu_torch/estimator``; this module is the
upstream-shaped import path for it.
"""

from ..estimator import KerasEstimator, KerasModel
from ..estimator.store import LocalStore

__all__ = ["KerasEstimator", "KerasModel", "LocalStore"]

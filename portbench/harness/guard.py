"""The run's guard against the JAX package: the process that prints the
result may hold none of these top-level modules once the window has
closed.  Names are compared whole (the part before the first dot), since
the port's package name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "horovod_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))

"""Leveled logging († ``horovod/common/logging.cc``: ``LOG(INFO)`` macros,
``HOROVOD_LOG_LEVEL``, ``HOROVOD_LOG_HIDE_TIME``).

Python's stdlib logging already provides the mechanism; this module maps the
reference's level names (including ``trace`` and ``fatal``) onto it and
applies the env-driven configuration **at import**: setting
``HVDTPU_LOG_LEVEL`` / ``HOROVOD_TPU_LOG_LEVEL`` / ``HOROVOD_LOG_LEVEL``
(first set wins) and ``..._LOG_HIDE_TIME`` configures the logger before any
code runs — matching the reference, where the env vars take effect at
process start.  The port reads the same knobs as the JAX package.
"""

from __future__ import annotations

import logging
import os

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_LOGGER_NAME = "horovod_tpu_torch"

# Native name wins over the reference-compat one, in the JAX package's
# precedence order; logging is the bottom of the dependency stack, so the
# prefixes live here rather than in a config module.
_ENV_PREFIXES = ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_")


def _env(suffix: str):
    for prefix in _ENV_PREFIXES:
        v = os.environ.get(prefix + suffix)
        if v is not None:
            return v
    return None


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def configure(level: str, *, hide_timestamp: bool = False) -> None:
    logger = get_logger()
    logger.setLevel(_LEVELS.get(level.lower(), logging.WARNING))
    if not logger.handlers:
        handler = logging.StreamHandler()
        logger.addHandler(handler)
        logger.propagate = False
    fmt = "[%(levelname)s] %(name)s: %(message)s" if hide_timestamp else \
        "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
    for handler in logger.handlers:
        handler.setFormatter(logging.Formatter(fmt))


def _configure_from_env() -> None:
    """Apply the env knobs at import (the docstring's promise)."""
    level = _env("LOG_LEVEL")
    hide = _env("LOG_HIDE_TIME")
    if level is None and hide is None:
        return
    configure(level or "warning",
              hide_timestamp=(hide or "").strip().lower()
              in ("1", "true", "yes", "on"))


_configure_from_env()

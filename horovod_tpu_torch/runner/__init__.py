"""The port's launcher: the ``horovodrun`` equivalent, ``hvdrun``.

    python -m horovod_tpu_torch.runner -np 2 -- python train.py

† ``horovod/runner/`` — CLI (``launch.py``), host parsing, rendezvous
server, per-rank env injection, ssh fan-out, monitor/kill.  Public API parity:
``horovod_tpu_torch.runner.run(command, np=...)`` mirrors ``horovod.run``
for a command, and ``run_func(fn, np=...)`` for a Python function.
"""

from .api import run_func  # noqa: F401
from .hosts import HostSlots, parse_hosts  # noqa: F401
from .launch import main, run  # noqa: F401

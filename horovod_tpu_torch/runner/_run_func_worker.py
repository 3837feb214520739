"""Worker entry for :func:`horovod_tpu_torch.runner.api.run_func` jobs.

Launched by the driver as
``python -m horovod_tpu_torch.runner._run_func_worker`` on every rank († the role of ``horovod/runner/run_task.py``): fetch the
pickled function from the job KV store, execute it, publish the result.
(Underscore-named so the module never shadows the ``run_func`` function
re-exported on the ``horovod_tpu_torch.runner`` package.)
"""

import sys

from .api import worker_main

if __name__ == "__main__":
    sys.exit(worker_main())

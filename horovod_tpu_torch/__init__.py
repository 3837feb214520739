"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu, for NVIDIA Hopper.

The port is built slice by slice beside the JAX package ``horovod_tpu``,
which stays as it is and is the reference.  On one H100 it serves and
trains Llama-family models end to end:

- ``serving.serve()`` over a continuous-batching engine with a block-paged
  KV cache, decode attention in ``csrc/paged_decode.cu``;
- ``models.llama.make_train_step`` (Adam steps on full-width Llama-2-7B
  with per-layer recompute), attention forward and backward in
  ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` behind a
  ``torch.autograd.Function``.

Every kernel is hand-written CUDA C++ for ``sm_90a``, built with ``nvcc``
at first use and bound with ctypes.

Ground rules:

- **Imports.** The port imports ``torch``, never ``jax``, and nothing of
  ``horovod_tpu`` — not even its JAX-free modules, since importing any
  ``horovod_tpu.*`` module runs ``horovod_tpu/__init__.py``, which imports
  jax.  What the port needs from those modules is copied into it
  (``utils/logging.py``, ``utils/timeline.py``, ``obs/``, ``chaos/``, the
  serving pager and scheduler).
- **Device.** Entry points run on ``cuda:<local_rank>`` unless the caller
  passes ``device="cpu"``, as the tests do.  Without a card and without
  ``device="cpu"`` they raise; they never carry on quietly on the CPU.
- **No fallback.** Every kernel has a plain PyTorch version beside it.  A
  wrapper runs the plain version only for tensors on the CPU; for a CUDA
  tensor it launches the kernel or raises.
- **Layouts.** Public functions keep the JAX package's layouts (stacked
  layer weights ``[L, D, H, Dh]``, q ``[B, H, Dh]``, pools
  ``[L, NB, BS, KV, Dh]``), so parameters move across with
  :func:`~horovod_tpu_torch.models.llama.params_from_jax` and the tests
  compare the two packages on the same inputs.

Not yet ported, and raising ``NotImplementedError`` where a caller could
reach them: sharded models (``mesh=``) for serving and training, MoE
configs, ``remat="dots"``, the blockwise cross-entropy
(``blockwise_ce=True``; ``ops/losses.py``), the prefix cache, speculative
decoding, KV migration, and the elastic rejoin after a collective
failure.  Horovod's runtime (``init`` with collectives, the eager verbs,
the negotiating engine, ``DistributedOptimizer``) and the launcher are
later slices.
"""

from .context import (  # noqa: F401
    component_health,
    device,
    global_state,
    init,
    is_initialized,
    local_rank,
    rank,
    set_component_health,
    shutdown,
    size,
)

__version__ = "0.1.0"

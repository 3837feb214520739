"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu, for NVIDIA Hopper.

The port is built slice by slice beside the JAX package ``horovod_tpu``,
which stays as it is and is the reference.  This slice serves Llama-family
models end to end on one H100: ``serve()`` over a continuous-batching
engine with a block-paged KV cache, with decode attention in a
hand-written CUDA kernel (``csrc/paged_decode.cu``, built with ``nvcc``
for ``sm_90a`` at first use).

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
reach them: sharded serving (``mesh=``), the prefix cache, speculative
decoding, KV migration, MoE configs, and the elastic rejoin after a
collective failure; training, collectives and the launcher are later
slices.
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

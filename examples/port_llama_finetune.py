"""Llama fine-tune with the PyTorch/CUDA port (``horovod_tpu_torch``): the
JAX package's ``examples/llama_finetune.py`` at its own config.

The tiny Llama (d_model 128, 4 layers, 8 heads over 4 kv heads, head dim
16, fp32) on a mesh of every rank: dp x sp x tp = 2 x 2 x 2 at eight
ranks, else ``MeshConfig.auto``.  AdamW (lr 3e-4, weight decay 0.01), a
global batch of 8 sequences of 64 tokens, 10 steps, then a checkpoint of
each rank's parameter blocks.  On the card the attention runs the fp32
flash kernels (``csrc/flash_simple.cu``).

    python -m horovod_tpu_torch.runner -np 2 -- \\
        python examples/port_llama_finetune.py
    (add --platform cpu to both on a machine without a card)
"""

import argparse
import math
import os
import shutil
import tempfile

import numpy as np
import torch


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--platform", choices=("gpu", "cpu"), default=None,
                   help="the runtime's platform (default: the card)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8,
                   help="global batch, in sequences")
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--checkpoint-dir", default=None,
                   help="where each rank saves its parameter blocks "
                   "(default: a temporary directory, removed at the end)")
    args = p.parse_args()
    if args.platform:
        os.environ["HVDTPU_PLATFORM"] = args.platform

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh
    from horovod_tpu_torch.utils.checkpoint import Checkpointer

    hvd.init()
    n = hvd.size()
    # Demo mesh: dp x sp x tp (swap for your topology).
    mesh_cfg = MeshConfig(dp=2, sp=2, tp=2) if n == 8 else MeshConfig.auto(n)
    mesh = build_mesh(mesh_cfg)
    dev = hvd.device()
    if hvd.rank() == 0:
        print("mesh:", mesh_cfg.axis_sizes(), flush=True)

    cfg = llama.LlamaConfig.tiny(d_model=128, n_layers=4, n_heads=8,
                                 n_kv_heads=4, d_ff=256)
    # Real runs: llama.LlamaConfig.llama2_7b()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(cfg, gen, dev, mesh=mesh)
    opt = torch.optim.AdamW(llama.trainable(params), lr=args.lr,
                            weight_decay=0.01)
    step = llama.make_train_step(cfg, opt, mesh=mesh)

    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(args.batch_size, args.seq_len + 1))
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}

    losses = []
    for i in range(args.steps):
        losses.append(step(params, batch).item())
        if hvd.rank() == 0:
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    assert all(math.isfinite(x) for x in losses), losses

    root = args.checkpoint_dir or tempfile.mkdtemp(prefix="llama_ckpt-")
    ckpt = Checkpointer(os.path.join(root, f"rank{hvd.rank()}"),
                        single_process=True)
    ckpt.save(args.steps, {"params": params})
    saved = ckpt.latest_step()
    if args.checkpoint_dir is None:
        shutil.rmtree(root, ignore_errors=True)
    if hvd.rank() == 0:
        print("checkpoint saved at step", saved, flush=True)
        print(f"DONE llama_finetune first={losses[0]:.4f} "
              f"last={losses[-1]:.4f} size={n} device={dev} "
              f"flash_launches={FA.KERNEL_LAUNCHES}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()

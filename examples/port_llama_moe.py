"""Mixture-of-experts Llama training with the PyTorch/CUDA port
(``horovod_tpu_torch``): the JAX package's ``examples/llama_moe.py`` at its
own config.

``LlamaConfig(use_moe=True)`` replaces every MLP with a Switch layer
(top-1 routing, static capacity, the load-balancing loss), and
``MeshConfig(ep=...)`` shards the experts: 4 experts on an ep axis of 2
where the world size is even, the rest data parallel.  The tiny model
(d_model 64, 2 layers, 4 heads of 16, fp32), AdamW (lr 3e-4, weight
decay 0.01), 2 sequences of 32 tokens a data shard, 5 steps; the loss
must fall.  On the card the attention runs the fp32 flash kernels
(``csrc/flash_simple.cu``).

    python -m horovod_tpu_torch.runner -np 2 -- \\
        python examples/port_llama_moe.py
    (add --platform cpu to both on a machine without a card)
"""

import argparse
import math
import os

import numpy as np
import torch


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--platform", choices=("gpu", "cpu"), default=None,
                   help="the runtime's platform (default: the card)")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--lr", type=float, default=3e-4)
    args = p.parse_args()
    if args.platform:
        os.environ["HVDTPU_PLATFORM"] = args.platform

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh

    hvd.init()
    n = hvd.size()
    # Experts want an ep axis when there is room; n_experts must divide
    # across it.
    ep = 2 if n % 2 == 0 and n >= 2 else 1
    mesh_cfg = MeshConfig(dp=n // ep, ep=ep)
    mesh = build_mesh(mesh_cfg)
    dev = hvd.device()
    if hvd.rank() == 0:
        print("mesh:", mesh_cfg.axis_sizes(), flush=True)

    cfg = llama.LlamaConfig.tiny(d_model=64, n_layers=2, n_heads=4,
                                 n_kv_heads=4, d_ff=128, use_moe=True,
                                 n_experts=4, capacity_factor=1.25)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(cfg, gen, dev, mesh=mesh)
    opt = torch.optim.AdamW(llama.trainable(params), lr=args.lr,
                            weight_decay=0.01)
    step = llama.make_train_step(cfg, opt, mesh=mesh)

    B, S = 2 * (n // ep), 32   # 2 sequences per dp shard
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                              size=(B, S + 1))
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}

    losses = []
    for i in range(args.steps):
        losses.append(step(params, batch).item())
        if hvd.rank() == 0:
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], ("MoE loss did not improve", losses)
    if hvd.rank() == 0:
        print(f"DONE moe first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"size={n} ep={ep} device={dev} "
              f"flash_launches={FA.KERNEL_LAUNCHES}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()

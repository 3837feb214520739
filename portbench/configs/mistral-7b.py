"""Mistral-7B-v0.3 trained through the port: ``LlamaConfig`` at the
configuration's widths (bf16, per-layer recompute), the weights the
benchmark makes from the seed, ``broadcast_parameters``,
``DistributedOptimizer(torch.optim.Adam(fused=True))`` and the step of
``models/llama.py`` ``make_train_step``.  Each step trains on the
rank's next row of the traffic's token rows."""

from __future__ import annotations

import torch

RATE_METRIC = "train_tokens_per_s"
# The port's RMSNorm epsilon (``models/llama.py``), fixed in the program.
PORT_RMS_EPS = 1e-5


class Program:
    def __init__(self, cell, seed: int, device, hvd):
        from horovod_tpu_torch.models import llama

        c, tr = cell.config, cell.traffic
        if c["rms_norm_eps"] != PORT_RMS_EPS or c.get("sliding_window"):
            raise ValueError("the port's Llama path takes RMSNorm eps 1e-5 "
                             "and no sliding window")
        self.ref = cell.reference()
        self.config, self.seed, self.device = c, seed, device
        cfg = llama.LlamaConfig(
            vocab_size=c["vocab_size"], d_model=c["hidden_size"],
            n_layers=c["num_hidden_layers"],
            n_heads=c["num_attention_heads"],
            n_kv_heads=c["num_key_value_heads"],
            d_ff=c["intermediate_size"], rope_theta=c["rope_theta"],
            dtype=getattr(torch, c["torch_dtype"]), remat=True,
            blockwise_ce=bool(tr.get("blockwise_ce", False)))
        self.params = self.ref.make_weights(c, seed, device)
        self.named = llama.named_trainable(self.params)
        hvd.broadcast_parameters(self.named, root_rank=0)
        o = tr["optimizer"]
        self.opt = hvd.DistributedOptimizer(
            torch.optim.Adam([t for _, t in self.named], lr=o["lr"],
                             betas=tuple(o["betas"]), eps=o["eps"],
                             fused=True),
            named_parameters=self.named)
        self.beta1 = o["betas"][0]
        self.train_step = llama.make_train_step(cfg, self.opt)
        self.rows = self.ref.make_rows(c, tr, seed, device)[hvd.rank()]
        self.work_per_step = tr["batch"] * tr["seq"]

    def step(self, i: int) -> torch.Tensor:
        return self.train_step(self.params,
                               {"tokens": self.rows[i % len(self.rows)]})

    def read_grad1(self) -> dict:
        """After one Adam step the first moment is (1 - beta1) g (a leaf
        the optimizer never stepped reads 0)."""
        out = {}
        for n, t in self.named:
            m = self.opt.state.get(t, {}).get("exp_avg")
            out[n] = 0.0 if m is None else torch.linalg.vector_norm(
                m, dtype=torch.float32).item() / (1 - self.beta1)
        return out

    def read_change(self) -> dict:
        """Each leaf's ``|p - p0|``, the initial weights made again from
        the seed one stack at a time (the gradients freed first, as the
        next step would)."""
        self.opt.zero_grad(set_to_none=True)
        out = {}

        def visit(key, p0):
            if key.startswith("layers."):
                k = key[len("layers."):]
                cur = self.params["layers"][k]
                for i in range(cur.shape[0]):
                    out[f"layers.{k}.{i}"] = torch.linalg.vector_norm(
                        cur[i].float() - p0[i].float()).item()
            else:
                out[key] = torch.linalg.vector_norm(
                    self.params[key].detach().float() - p0.float()).item()

        self.ref.make_weights(self.config, self.seed, self.device,
                              visit=visit)
        return out

    def free(self) -> None:
        self.params = self.named = self.opt = self.train_step = None

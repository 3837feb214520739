"""Mistral-7B-v0.3's training step in plain PyTorch: the benchmark's
inputs (weights and token rows, made from the seed) and the reference
that the program's first steps are held against.

The reference follows the published architecture (Hugging Face's
``MistralForCausalLM`` at ``sliding_window: null``): token embedding,
``num_hidden_layers`` pre-norm blocks of RMSNorm -> q/k/v projections ->
half-split RoPE -> causal grouped-query attention -> output projection,
residual, RMSNorm -> SwiGLU MLP, residual; final RMSNorm, an untied head,
and the mean next-token cross-entropy; Adam with bias correction.

It computes in float32 with TF32 off, one layer at a time so that it
fits one card beside its state: a forward pass keeps each layer's input,
then the backward recomputes one layer at a time (attention a few heads
at a time under recompute) and hands each leaf's gradient on as soon as
it is known.  Data-parallel ranks average each gradient over a process
group of their own.  It keeps the gradients of all but the last checked
step (float32) and works the weights of step t out of the initial ones
and those gradients, so its memory is the initial weights (bf16, as
made) plus one float32 copy of the model per kept step.

It imports nothing of the program.  ``precision="fp8"`` is the control:
every product's operands rounded to fp8 (e4m3 forward, e5m2 backward,
one scale a tensor), as a program that stepped down from bf16 would
compute.  ``fault`` plants one of the faults a training cell can have
(``half_batch``, ``no_exchange``) in the reference put in the program's
place."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.harness.fp8 import operand

# Weights of the layer stacks, in the order they are drawn and named.
LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")
# KV heads whose attention is computed together in the backward.
KV_CHUNK = 2


def dims(c: dict) -> dict:
    D, H = c["hidden_size"], c["num_attention_heads"]
    return dict(V=c["vocab_size"], D=D, L=c["num_hidden_layers"], H=H,
                KV=c["num_key_value_heads"], Dh=c.get("head_dim") or D // H,
                F=c["intermediate_size"])


# -- the benchmark's inputs ------------------------------------------------

def make_weights(c: dict, seed: int, device,
                 visit: Optional[Callable] = None) -> dict:
    """The model's weights from ``seed``, on ``device``, in the layout the
    port keeps (layer weights stacked over a leading layer axis): each
    matrix ``N(0, 1)`` drawn in the configuration's ``torch_dtype`` (the
    type it is served in) in one call per stack and
    scaled by ``1 / sqrt(fan_in)``; norm weights float32 ones.  With
    ``visit(key, tensor)`` each piece is handed over as it is drawn and
    not kept (``key`` is ``embed``, ``final_norm``, ``lm_head`` or
    ``layers.<weight>``), so the whole model is never held twice."""
    d = dims(c)
    V, D, L, H, KV, Dh, Fd = (d[k] for k in ("V", "D", "L", "H", "KV",
                                             "Dh", "F"))
    dtype = getattr(torch, c["torch_dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def mat(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return w.mul_(1.0 / math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    makers = {
        "attn_norm": lambda: ones((L, D)),
        "wq": lambda: mat((L, D, H, Dh), D),
        "wk": lambda: mat((L, D, KV, Dh), D),
        "wv": lambda: mat((L, D, KV, Dh), D),
        "wo": lambda: mat((L, H, Dh, D), H * Dh),
        "mlp_norm": lambda: ones((L, D)),
        "w_gate": lambda: mat((L, D, Fd), D),
        "w_up": lambda: mat((L, D, Fd), D),
        "w_down": lambda: mat((L, Fd, D), Fd),
    }
    out = {"layers": {}}
    order = [("embed", lambda: mat((V, D), D))] + \
        [(f"layers.{k}", makers[k]) for k in LAYER_KEYS] + \
        [("final_norm", lambda: ones((D,))),
         ("lm_head", lambda: mat((D, V), D))]
    for key, make in order:
        t = make()
        if visit is not None:
            visit(key, t)
            del t
        elif key.startswith("layers."):
            out["layers"][key[len("layers."):]] = t
        else:
            out[key] = t
    return out


def leaf_names(c: dict) -> list:
    """The optimizer's leaves by name: one a layer of each stacked
    weight (``layers.wq.3``), then the embedding, final norm and head."""
    L = dims(c)["L"]
    return [f"layers.{k}.{i}" for k in LAYER_KEYS for i in range(L)] + \
        ["embed", "final_norm", "lm_head"]


def make_rows(c: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """Token rows ``[ranks, rows, batch, seq + 1]`` drawn uniformly from
    the vocabulary with the seed's own generator: every row differs, and
    each rank steps through its own."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ 0x5DEECE66D)
    shape = (traffic["ranks"], traffic["rows"], traffic["batch"],
             traffic["seq"] + 1)
    return torch.randint(0, c["vocab_size"], shape, generator=gen,
                         device=device)


# -- the model -----------------------------------------------------------------

def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope_tables(S: int, Dh: int, theta: float, device):
    half = Dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] \
        * freqs
    return torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]


def rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(q, k, v, precision):
    """Causal attention of a few kv heads and their query heads."""
    B, S, Hc, Dh = q.shape
    KVc = k.shape[2]
    qg = q.reshape(B, S, KVc, Hc // KVc, Dh)
    s = torch.einsum("bqgrd,bkgd->bgrqk", operand(qg, precision),
                     operand(k, precision)) / math.sqrt(Dh)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~keep, -math.inf), dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", operand(p, precision),
                     operand(v, precision))
    return o.reshape(B, S, Hc, Dh)


def attention(q, k, v, precision):
    H, KV = q.shape[2], k.shape[2]
    rep = H // KV
    outs = []
    for g in range(0, KV, KV_CHUNK):
        args = (q[:, :, g * rep:(g + KV_CHUNK) * rep],
                k[:, :, g:g + KV_CHUNK], v[:, :, g:g + KV_CHUNK])
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend, *args, precision,
                                   use_reentrant=False))
        else:
            outs.append(_attend(*args, precision))
    return torch.cat(outs, dim=2)


def mm(a, b, precision):
    return operand(a, precision) @ operand(b, precision)


def layer(h, w: dict, c: dict, tables, precision: str):
    d = dims(c)
    B, S, D = h.shape
    eps = c["rms_norm_eps"]
    x = rmsnorm(h, w["attn_norm"], eps)
    q = mm(x, w["wq"].reshape(D, -1), precision).reshape(B, S, d["H"], -1)
    k = mm(x, w["wk"].reshape(D, -1), precision).reshape(B, S, d["KV"], -1)
    v = mm(x, w["wv"].reshape(D, -1), precision).reshape(B, S, d["KV"], -1)
    q, k = rope(q, *tables), rope(k, *tables)
    o = attention(q, k, v, precision).reshape(B, S, -1)
    h = h + mm(o, w["wo"].reshape(-1, D), precision)
    x = rmsnorm(h, w["mlp_norm"], eps)
    a = F.silu(mm(x, w["w_gate"], precision)) * mm(x, w["w_up"], precision)
    return h + mm(a, w["w_down"], precision)


def head_nll(h, final_norm, lm_head, targets, c, precision):
    x = rmsnorm(h, final_norm, c["rms_norm_eps"])
    logits = mm(x, lm_head, precision)
    return torch.logsumexp(logits, -1) - \
        logits.gather(-1, targets[..., None])[..., 0]


# -- Adam ----------------------------------------------------------------------

def adam(p0: torch.Tensor, grads: list, opt: dict) -> torch.Tensor:
    """``p0`` after one Adam step per gradient (``torch.optim.Adam``'s
    update: bias-corrected moments, ``eps`` outside the root)."""
    b1, b2 = opt["betas"]
    p = p0.clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for t, g in enumerate(grads, 1):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(opt["eps"])
        p.addcdiv_(m, denom, value=-opt["lr"] / (1 - b1 ** t))
    return p


# -- the reference's steps -------------------------------------------------------

def readings(c: dict, traffic: dict, seed: int, device, *, rank: int = 0,
             world: int = 1, group=None, precision: str = "fp32",
             fault: Optional[str] = None) -> dict:
    """The reference's readings over ``traffic["check_steps"]`` steps on
    this rank's rows: ``loss`` (this rank's), ``grad1``, ``change`` and
    ``gmax`` by leaf (see ``harness/judge.py``).  ``group``: the process
    group the ranks average their gradients over (None at one rank)."""
    import torch.distributed as dist

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        d = dims(c)
        steps, opt = traffic["check_steps"], traffic["optimizer"]
        p0 = make_weights(c, seed, device)
        rows = make_rows(c, traffic, seed, device)[rank]
        kept = {n: [] for n in leaf_names(c)}        # g_1 .. g_{steps-1}
        out = {"loss": [], "grad1": {}, "change": {}, "gmax": {}}

        def initial(name):
            if name.startswith("layers."):
                _, k, i = name.split(".")
                return p0["layers"][k][int(i)].float()
            return p0[name].float()

        def weight(name, t):
            return adam(initial(name), kept[name][:t], opt) if t \
                else initial(name)

        def layer_weights(i, t):
            return {k: weight(f"layers.{k}.{i}", t) for k in LAYER_KEYS}

        def take(name, g, t):
            g = g.detach()
            if world > 1:
                share = world
                if fault == "half_batch":
                    share = world // 2
                    if rank >= share:
                        g = torch.zeros_like(g)
                if fault != "no_exchange":
                    dist.all_reduce(g, group=group)
                    g = g / share
            norm = torch.linalg.vector_norm(g).item()
            out["gmax"][name] = max(out["gmax"].get(name, 0.0), norm)
            if t == 0:
                out["grad1"][name] = norm
            if t < steps - 1:
                kept[name].append(g)
            else:
                p0f = initial(name)
                out["change"][name] = torch.linalg.vector_norm(
                    adam(p0f, kept[name] + [g], opt) - p0f).item()
                kept[name] = []

        tables = rope_tables(traffic["seq"], d["Dh"], c["rope_theta"],
                             device)
        for t in range(steps):
            tokens = rows[t]
            inputs, targets = tokens[:, :-1], tokens[:, 1:]
            with torch.no_grad():
                h = weight("embed", t)[inputs]
                hs = [h]
                for i in range(d["L"]):
                    h = layer(h, layer_weights(i, t), c, tables, precision)
                    hs.append(h)
            top = hs[-1].requires_grad_()
            fn = weight("final_norm", t).requires_grad_()
            lm = weight("lm_head", t).requires_grad_()
            nll = head_nll(top, fn, lm, targets, c, precision)
            B, S = nll.shape
            if fault == "half_batch" and world == 1:
                nll = nll[:B // 2] if B > 1 else nll[:, :S // 2]
            loss = nll.mean()
            out["loss"].append(loss.item())
            dh, dfn, dlm = torch.autograd.grad(loss, (top, fn, lm))
            take("final_norm", dfn, t)
            take("lm_head", dlm, t)
            del top, fn, lm, nll, loss, dfn, dlm
            for i in reversed(range(d["L"])):
                x = hs[i].requires_grad_()
                w = {k: v.requires_grad_()
                     for k, v in layer_weights(i, t).items()}
                y = layer(x, w, c, tables, precision)
                got = torch.autograd.grad(y, (x, *w.values()), dh)
                dh = got[0]
                for k, g in zip(w, got[1:]):
                    take(f"layers.{k}.{i}", g, t)
                hs[i + 1] = None
                del x, w, y, got
            emb = torch.zeros(d["V"], d["D"], dtype=torch.float32,
                              device=device)
            emb.index_add_(0, inputs.reshape(-1),
                           dh.reshape(-1, d["D"]))
            take("embed", emb, t)
            del emb, dh, hs
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]

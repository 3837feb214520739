"""The yardstick: the card's published peaks and the operations and bytes
of the work, computed from shapes.  Kept with the benchmark so that a
change to the program cannot move it.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at
the 700 W limit.  Operation counts follow the convention of the port's
smoke script: a training token costs ``6 N + 12 L D S`` (forward and
backward of the dense parameters, plus the attention products; no
recompute counted), a ResNet image ``3 x 2 x`` its forward
multiply-adds.  A flash kernel's operations count only the score blocks
under the causal diagonal; its bytes count each input read once and each
output written once."""

from __future__ import annotations

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


# -- Llama-family (Mistral) training ----------------------------------------

def llama_params(c: dict) -> int:
    """Trainable parameters of a Llama-family model with untied embedding
    and head, from a Hugging Face style config (``hidden_size``,
    ``intermediate_size``, ``num_hidden_layers``, ``num_attention_heads``,
    ``num_key_value_heads``, ``head_dim``, ``vocab_size``)."""
    D, F, L = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    H, KV, V = (c["num_attention_heads"], c["num_key_value_heads"],
                c["vocab_size"])
    Dh = c.get("head_dim") or D // H
    layer = D * H * Dh * 2 + D * KV * Dh * 2 + 3 * D * F + 2 * D
    return L * layer + 2 * V * D + D


def llama_flops_per_token(c: dict, seq: int) -> int:
    """``6 N + 12 L D S``: forward and backward of every parameter, plus
    the attention score and value products at sequence ``seq``."""
    return 6 * llama_params(c) + 12 * c["num_hidden_layers"] \
        * c["hidden_size"] * seq


# -- flash attention kernels -------------------------------------------------

def flash_flops(B: int, S: int, H: int, D: int, causal: bool,
                products: int) -> int:
    """Operations of a flash kernel whose inner loop runs ``products``
    S x S x D products a head (2 forward, 3 dQ, 4 dK/dV), 2 a
    multiply-add, only the score blocks the causal mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 2 * products * B * H * pairs * D


def flash_bytes(B: int, S: int, H: int, KV: int, D: int, kind: str,
                elt: int = 2) -> int:
    """Bytes a flash kernel must move at least: q, k and v read once, its
    outputs written once, and its fp32 row statistics (the forward
    writes lse; the backward reads lse and delta)."""
    q = B * S * H * D * elt
    kv = B * S * KV * D * elt
    rows = B * H * S * 4
    if kind == "fwd":                       # q, k, v in; o, lse out
        return q + 2 * kv + q + rows
    if kind == "dq":                        # q, k, v, do in; dq out
        return q + 2 * kv + q + q + 2 * rows
    if kind == "dkv":                       # q, k, v, do in; dk, dv out
        return q + 2 * kv + q + 2 * kv + 2 * rows
    raise ValueError(f"unknown flash kernel kind {kind!r}")


def bound_s(nbytes: int, flops: int, flops_per_s: float = BF16_FLOPS
            ) -> float:
    """The least time the card could take: the larger of the operations
    at the peak rate and the bytes at the memory's rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


# -- ResNet-v1.5 ---------------------------------------------------------------

def _out(n: int, s: int) -> int:
    return -(-n // s)                       # "SAME" padding


def resnet_forward_macs(stage_sizes, width: int, classes: int,
                        image: int) -> int:
    """Multiply-adds of one image's forward through ResNet-v1.5's
    convolutions and head (norms, pools and adds not counted): a 7x7/2
    stem and a 3x3/2 pool, then bottleneck blocks 1x1 -> 3x3 (stride
    here) -> 1x1 (x4), a 1x1 projection on each stage's first block."""
    macs = 0
    size = _out(image, 2)
    macs += size * size * width * 3 * 7 * 7
    size = _out(size, 2)                    # the stem's pool
    cin = width
    for i, n in enumerate(stage_sizes):
        f = width * 2 ** i
        for j in range(n):
            s = 2 if j == 0 and i > 0 else 1
            y = _out(size, s)
            macs += size * size * f * cin            # 1x1
            macs += y * y * f * f * 9                # 3x3, stride s
            macs += y * y * f * 4 * f                # 1x1 (x4)
            if j == 0:
                macs += y * y * f * 4 * cin          # projection
            cin, size = f * 4, y
    return macs + cin * classes

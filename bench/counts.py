"""The benchmark's frozen operation and byte counts, from shapes and
token counts alone, so they read the same whatever implements the work.

Model FLOPs count 2 per multiply-add of every product the model's
equations hold, binary (±1) ones included: each layer's own products
(the model module's ``sz["layers"][i]["macs"]``: attention projections,
the router, the ``top_k`` routed experts of each token and never the
ones it skips, the dense SwiGLU), attention over the real causal context
(QK^T and PV) in the layers that attend, and the head once per position
whose logits are used. No recompute, no padding, no capacity buffer.

The fused BitLinear's bytes count each operand once per call: the
activations (bf16), the packed weight words (32 signs per int32), the
per-column alpha and per-row beta (fp32) and the fp32 output. Its
operation term is left out of the roofline: NVIDIA publishes no b1 rate
for the H100, so only the byte bound is stated.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def forward_flops(sz: dict, tokens: int, context_sum: int, head_rows: int) -> float:
    """FLOPs of a forward over ``tokens`` positions whose attention spans
    ``context_sum`` keys in all, with logits at ``head_rows`` positions."""
    macs = 0
    for layer in sz["layers"]:  # a layer that does not attend has 0 heads
        macs += layer["macs"] * tokens + 2 * layer["attn_heads"] * layer["attn_hd"] * context_sum
    macs += sz["d_model"] * sz["vocab_size"] * head_rows
    return 2.0 * macs


def prefill_flops(sz: dict, rows: int, prefix: int = 0) -> float:
    """One sequence's prefill: ``rows`` new positions after ``prefix``
    prepended ones (a VLM's patches count among the rows), logits at the
    last."""
    return forward_flops(sz, rows, sum(range(prefix + 1, prefix + rows + 1)), 1)


def decode_flops(sz: dict, context: int) -> float:
    """One decoded token attending over ``context`` keys (itself included)."""
    return forward_flops(sz, 1, context, 1)


def fused_window(sz: dict, calls: int, rows: int) -> tuple[int, float]:
    """Launches and bytes of ``calls`` model calls over ``rows`` rows in
    all. Each call makes every layer's fused launches (``sz["layers"][i]
    ["fused"]``) once, and a launch over r rows moves x (r * m bf16), the
    words (ceil(m / 32) * n int32), alpha (n fp32), beta (r fp32) and the
    output (r * n fp32)."""
    launches, total = 0, 0
    for layer in sz["layers"]:
        launches += calls * len(layer["fused"])
        for m, n in layer["fused"]:
            words_alpha = -(-m // 32) * n * 4 + n * 4
            total += calls * words_alpha + rows * (m * 2 + 4 + n * 4)
    return launches, float(total)

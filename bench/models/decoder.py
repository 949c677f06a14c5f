"""The decoder LMs: every layer is GQA attention with RoPE, then an MoE
(softmax top-k with a capacity bound) or a dense SwiGLU; q/k/v/o and a
dense FFN's w1/w3/w2 are BitLinear projections. A configuration file
names this module with ``"model": "decoder"``; its plain reference is
``bench/reference/decoder.py``.
"""

from __future__ import annotations

import math

from bench.reference.decoder import Decoder as Reference  # noqa: F401 (the check's reference)


def sizes(cfg) -> dict:
    """The plain numbers the weights, the reference and the counts read,
    from the system's configuration object."""
    return with_layers({
        "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "hd": cfg.hd, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "padded_vocab": cfg.padded_vocab, "n_layers": cfg.n_layers,
        "moe_experts": cfg.moe_experts, "moe_top_k": cfg.moe_top_k,
        "moe_capacity_factor": cfg.moe_capacity_factor, "qkv_bias": cfg.qkv_bias,
        "tie_embeddings": cfg.tie_embeddings, "rope_theta": cfg.rope_theta,
        "norm_eps": cfg.norm_eps, "frontend_len": cfg.frontend_len,
    })


def with_layers(sz: dict) -> dict:
    """``sz`` with ``layers``: ``n_layers`` alike, each attending with all
    its query heads. A layer's ``macs`` are one token's multiply-adds
    with the attention scores left out: q|k|v and o, then the router and
    the ``top_k`` routed SwiGLUs, or the dense SwiGLU. Its ``fused`` are
    the ``(m, n)`` of its fused BitLinear launches: the [q|k|v] artifact
    and o, then w1, w3, w2 of a dense FFN (the experts are not
    binarized)."""
    d, h, kv, hd, f = sz["d_model"], sz["n_heads"], sz["n_kv_heads"], sz["hd"], sz["d_ff"]
    macs = d * (h + 2 * kv) * hd + h * hd * d
    fused = [(d, (h + 2 * kv) * hd), (h * hd, d)]
    if sz["moe_experts"]:
        macs += d * sz["moe_experts"] + sz["moe_top_k"] * 3 * d * f
    else:
        macs += 3 * d * f
        fused += [(d, f), (d, f), (f, d)]
    layer = {"macs": macs, "attn_heads": h, "attn_hd": hd, "fused": fused}
    return {**sz, "layers": [layer] * sz["n_layers"]}


def layout(sz: dict, wcfg: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """``(name, shape, kind, std)`` of every tensor, in draw order."""
    d, h, kv, hd = sz["d_model"], sz["n_heads"], sz["n_kv_heads"], sz["hd"]
    vp, f = sz["padded_vocab"], sz["d_ff"]
    out = [("embed", (vp, d), "normal", wcfg["embed_std"])]
    if not sz["tie_embeddings"]:
        out.append(("head", (d, vp), "normal", 1.0 / math.sqrt(d)))
    out.append(("final_norm", (d,), "scale", wcfg["norm_std"]))
    for i in range(sz["n_layers"]):
        p = f"layers.{i}."
        out += [
            (p + "norm1", (d,), "scale", wcfg["norm_std"]),
            (p + "q", (d, h * hd), "normal", 1.0 / math.sqrt(d)),
            (p + "k", (d, kv * hd), "normal", 1.0 / math.sqrt(d)),
            (p + "v", (d, kv * hd), "normal", 1.0 / math.sqrt(d)),
            (p + "o", (h * hd, d), "normal", 1.0 / math.sqrt(h * hd)),
            (p + "norm2", (d,), "scale", wcfg["norm_std"]),
        ]
        if sz["qkv_bias"]:
            out += [(p + f"{n}_bias", (w,), "normal", wcfg["bias_std"])
                    for n, w in (("q", h * hd), ("k", kv * hd), ("v", kv * hd))]
        if sz["moe_experts"]:
            e = sz["moe_experts"]
            out += [
                (p + "router", (d, e), "normal", 1.0 / math.sqrt(d)),
                (p + "w1", (e, d, f), "normal", 1.0 / math.sqrt(d)),
                (p + "w3", (e, d, f), "normal", 1.0 / math.sqrt(d)),
                (p + "w2", (e, f, d), "normal", 1.0 / math.sqrt(f)),
            ]
        else:
            out += [
                (p + "w1", (d, f), "normal", 1.0 / math.sqrt(d)),
                (p + "w3", (d, f), "normal", 1.0 / math.sqrt(d)),
                (p + "w2", (f, d), "normal", 1.0 / math.sqrt(f)),
            ]
    return out


def build(weights: dict, sz: dict):
    """The system's ``LM`` holding ``weights`` (no copy): its own module
    constructors, fed the benchmark's tensors."""
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import FFN, Attention, BitLinear

    def bias(name):
        return weights.get(name)

    blocks = []
    for i in range(sz["n_layers"]):
        p = f"layers.{i}."
        attn = Attention(
            BitLinear(weights[p + "q"], bias(p + "q_bias")),
            BitLinear(weights[p + "k"], bias(p + "k_bias")),
            BitLinear(weights[p + "v"], bias(p + "v_bias")),
            BitLinear(weights[p + "o"]),
        )
        if sz["moe_experts"]:
            ffn = moe_lib.MoE(weights[p + "router"], weights[p + "w1"], weights[p + "w3"],
                              weights[p + "w2"])
        else:
            ffn = FFN(BitLinear(weights[p + "w1"]), BitLinear(weights[p + "w3"]),
                      BitLinear(weights[p + "w2"]))
        blocks.append(lm_lib.Block(weights[p + "norm1"], attn, weights[p + "norm2"], ffn))
    return lm_lib.LM(weights["embed"], weights["final_norm"], weights.get("head"), blocks,
                     n_slots=1)

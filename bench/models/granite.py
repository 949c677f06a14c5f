"""The hybrid Granite-4.0-H LMs: each layer a Mamba-2 mixer or a NoPE GQA
attention mixer (the configuration's ``pattern``), then an MoE (softmax
top-k with a capacity bound) with a shared SwiGLU expert; Granite's
embedding, residual and logit multipliers; a tied head. q/k/v/o are
BitLinear projections; the Mamba projections, the router and the
experts are real-valued. A configuration file names this module with
``"model": "granite"``; its plain reference is
``bench/reference/hybrid.py``.

Besides the counts every model module gives, each layer gives two byte
floors for ``hbm_roofline.decode``: ``step_bytes``, the layer's weights
read once per decode step at the precision the configuration states
(bf16 Mamba projections, router and experts; 32 signs a word and an fp32
alpha per column for the fused BitLinear artifacts; fp32 vectors), with
the shared expert and ``top_k`` routed experts, the fewest a step
touches; and ``lane_bytes``, the Mamba state (fp32) and conv tails
(bf16) read and written once per lane. ``head_bytes`` is the tied head
in bf16. The attention layer's KV is left out (its context is not in the
work count), so their sum is a floor of what a step moves.
"""

from __future__ import annotations

import math

from bench.reference.hybrid import Hybrid as Reference  # noqa: F401 (the check's reference)


def sizes(cfg) -> dict:
    """The plain numbers the weights, the reference and the counts read,
    from the system's configuration object."""
    sz = {
        "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "hd": cfg.hd, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "padded_vocab": cfg.padded_vocab, "n_layers": cfg.n_layers,
        "moe_experts": cfg.moe_experts, "moe_top_k": cfg.moe_top_k,
        "moe_capacity_factor": cfg.moe_capacity_factor, "moe_shared_ff": cfg.moe_shared_ff,
        "norm_eps": cfg.norm_eps, "attn_scale": cfg.attn_scale,
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier, "logits_scaling": cfg.logits_scaling,
        "d_inner": cfg.d_inner, "ssm_heads": cfg.ssm_heads, "ssm_head_dim": cfg.ssm_head_dim,
        "ssm_state": cfg.ssm_state, "ssm_groups": cfg.ssm_groups, "ssm_conv": cfg.ssm_conv,
        "mixers": [cfg.pattern[i % len(cfg.pattern)].mixer for i in range(cfg.n_layers)],
        "period": len(cfg.pattern),
    }
    sz["layers"] = [_layer(sz, mixer) for mixer in sz["mixers"]]
    sz["head_bytes"] = sz["vocab_size"] * sz["d_model"] * 2
    return sz


def _mamba_shapes(sz: dict) -> dict[str, tuple[int, ...]]:
    d, di, h, k = sz["d_model"], sz["d_inner"], sz["ssm_heads"], sz["ssm_conv"]
    gn = sz["ssm_groups"] * sz["ssm_state"]
    return {
        "z_proj": (d, di), "x_proj": (d, di), "b_proj": (d, gn), "c_proj": (d, gn),
        "dt_proj": (d, h), "conv_x": (k, di), "conv_b": (k, gn), "conv_c": (k, gn),
        "conv_bias_x": (di,), "conv_bias_b": (gn,), "conv_bias_c": (gn,),
        "A_log": (h,), "D": (h,), "dt_bias": (h,), "norm": (di,), "out_proj": (di, d),
    }


def _layer(sz: dict, mixer: str) -> dict:
    """One layer's counts. ``macs``: one token's multiply-adds with the
    attention scores left out: the Mamba projections and ``2 H N P`` for
    its state update and readout, or q|k|v and o; then the router, the
    ``top_k`` routed SwiGLUs and the shared SwiGLU. ``fused``: the
    [q|k|v] and o launches of an attention layer."""
    d, e, f, fs = sz["d_model"], sz["moe_experts"], sz["d_ff"], sz["moe_shared_ff"]
    k = sz["moe_top_k"]
    ffn_macs = d * e + k * 3 * d * f + 3 * d * fs
    ffn_bytes = 2 * (d * e + k * 3 * d * f + 3 * d * fs) + 2 * d * 4  # bf16; norm1, norm2 fp32
    if mixer == "attn":
        h, kv, hd = sz["n_heads"], sz["n_kv_heads"], sz["hd"]
        fused = [(d, (h + 2 * kv) * hd), (h * hd, d)]
        words_alpha = sum(-(-m // 32) * n * 4 + n * 4 for m, n in fused)
        return {"macs": d * (h + 2 * kv) * hd + h * hd * d + ffn_macs, "attn_heads": h,
                "attn_hd": hd, "fused": fused, "step_bytes": words_alpha + ffn_bytes,
                "lane_bytes": 0}
    shapes = _mamba_shapes(sz)
    projections = sum(math.prod(s) for n, s in shapes.items() if n.endswith("_proj"))
    vectors = sum(math.prod(s) for n, s in shapes.items() if not n.endswith("_proj"))
    state = sz["ssm_heads"] * sz["ssm_state"] * sz["ssm_head_dim"]
    tails = (sz["ssm_conv"] - 1) * (sz["d_inner"] + 2 * sz["ssm_groups"] * sz["ssm_state"])
    return {"macs": projections + 2 * state + ffn_macs, "attn_heads": 0, "attn_hd": 0,
            "fused": [], "step_bytes": 2 * projections + 4 * vectors + ffn_bytes,
            "lane_bytes": 2 * (4 * state + 2 * tails)}


def layout(sz: dict, wcfg: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """``(name, shape, kind, std)`` of every tensor, in draw order."""
    d, h, kv, hd = sz["d_model"], sz["n_heads"], sz["n_kv_heads"], sz["hd"]
    e, f, fs = sz["moe_experts"], sz["d_ff"], sz["moe_shared_ff"]
    out = [("embed", (sz["padded_vocab"], d), "normal", wcfg["embed_std"]),
           ("final_norm", (d,), "scale", wcfg["norm_std"])]
    mamba_kind = {
        "conv_bias_x": ("normal", wcfg["bias_std"]), "conv_bias_b": ("normal", wcfg["bias_std"]),
        "conv_bias_c": ("normal", wcfg["bias_std"]), "A_log": ("normal", wcfg["a_log_std"]),
        "D": ("scale", wcfg["d_std"]), "dt_bias": ("normal", wcfg["dt_bias_std"]),
        "norm": ("scale", wcfg["norm_std"]),
    }
    for i, mixer in enumerate(sz["mixers"]):
        p = f"layers.{i}."
        out.append((p + "norm1", (d,), "scale", wcfg["norm_std"]))
        if mixer == "attn":
            out += [
                (p + "q", (d, h * hd), "normal", 1.0 / math.sqrt(d)),
                (p + "k", (d, kv * hd), "normal", 1.0 / math.sqrt(d)),
                (p + "v", (d, kv * hd), "normal", 1.0 / math.sqrt(d)),
                (p + "o", (h * hd, d), "normal", 1.0 / math.sqrt(h * hd)),
            ]
        else:
            for name, shape in _mamba_shapes(sz).items():
                kind, std = mamba_kind.get(name, ("normal", 1.0 / math.sqrt(shape[0])))
                out.append((p + name, shape, kind, std))
        out += [
            (p + "norm2", (d,), "scale", wcfg["norm_std"]),
            (p + "router", (d, e), "normal", 1.0 / math.sqrt(d)),
            (p + "w1", (e, d, f), "normal", 1.0 / math.sqrt(d)),
            (p + "w3", (e, d, f), "normal", 1.0 / math.sqrt(d)),
            (p + "w2", (e, f, d), "normal", 1.0 / math.sqrt(f)),
            (p + "ws1", (d, fs), "normal", 1.0 / math.sqrt(d)),
            (p + "ws3", (d, fs), "normal", 1.0 / math.sqrt(d)),
            (p + "ws2", (fs, d), "normal", 1.0 / math.sqrt(fs)),
        ]
    return out


def build(weights: dict, sz: dict):
    """The system's ``LM`` holding ``weights`` (no copy): its own module
    constructors, fed the benchmark's tensors."""
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.layers import Attention, BitLinear

    blocks = []
    for i, mixer in enumerate(sz["mixers"]):
        p = f"layers.{i}."
        if mixer == "attn":
            mix = Attention(*(BitLinear(weights[p + n]) for n in ("q", "k", "v", "o")))
        else:
            mix = ssm_lib.Mamba(**{n: weights[p + n] for n in _mamba_shapes(sz)})
        ffn = moe_lib.MoE(*(weights[p + n] for n in ("router", "w1", "w3", "w2", "ws1", "ws3",
                                                     "ws2")))
        blocks.append(lm_lib.Block(weights[p + "norm1"], mix, weights[p + "norm2"], ffn))
    return lm_lib.LM(weights["embed"], weights["final_norm"], None, blocks,
                     n_slots=sz["period"])


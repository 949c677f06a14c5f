"""Seeded weights and inputs, made by the benchmark and handed to both
sides: the system under test (through its own module constructors) and
the plain reference (as a dict of tensors).

Every tensor is a slice of one flat buffer drawn by one ``torch.randn``
call on a CUDA generator (the CPU one in the tests), then scaled in
place: the set-up costs one large launch, not one per leaf, and the same
seed gives the same weights on either side.
"""

from __future__ import annotations

import math

import torch


def _layout(cfg: dict, wcfg: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """``(name, shape, kind, std)`` of every tensor of a decoder LM, in
    draw order. ``kind`` is ``normal`` (std * N(0, 1)) or ``scale``
    (1 + std * N(0, 1), a norm's scale)."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["hd"]
    vp, f = cfg["padded_vocab"], cfg["d_ff"]
    out = [("embed", (vp, d), "normal", wcfg["embed_std"])]
    if not cfg["tie_embeddings"]:
        out.append(("head", (d, vp), "normal", 1.0 / math.sqrt(d)))
    out.append(("final_norm", (d,), "scale", wcfg["norm_std"]))
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        out += [
            (p + "norm1", (d,), "scale", wcfg["norm_std"]),
            (p + "q", (d, h * hd), "normal", 1.0 / math.sqrt(d)),
            (p + "k", (d, kv * hd), "normal", 1.0 / math.sqrt(d)),
            (p + "v", (d, kv * hd), "normal", 1.0 / math.sqrt(d)),
            (p + "o", (h * hd, d), "normal", 1.0 / math.sqrt(h * hd)),
            (p + "norm2", (d,), "scale", wcfg["norm_std"]),
        ]
        if cfg["qkv_bias"]:
            out += [(p + f"{n}_bias", (w,), "normal", wcfg["bias_std"])
                    for n, w in (("q", h * hd), ("k", kv * hd), ("v", kv * hd))]
        if cfg["moe_experts"]:
            e = cfg["moe_experts"]
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


def make_weights(cfg: dict, wcfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The model's fp32 weights from ``seed``: one flat draw, sliced."""
    layout = _layout(cfg, wcfg)
    total = sum(math.prod(shape) for _, shape, _, _ in layout)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind, std in layout:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        t.mul_(std)
        if kind == "scale":
            t.add_(1.0)
        out[name] = t
    return out


def draw_normal(shape, seed: int, stream: int, std: float, device, dtype) -> torch.Tensor:
    """Inputs drawn from ``(seed, stream)`` on ``device`` in one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + stream) % (2**63))
    return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std).to(dtype)


def build_port_model(weights: dict[str, torch.Tensor], cfg: dict):
    """The system's ``LM`` holding ``weights`` (no copy): its own module
    constructors, fed the benchmark's tensors."""
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import FFN, Attention, BitLinear

    def bias(name):
        return weights.get(name)

    blocks = []
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        attn = Attention(
            BitLinear(weights[p + "q"], bias(p + "q_bias")),
            BitLinear(weights[p + "k"], bias(p + "k_bias")),
            BitLinear(weights[p + "v"], bias(p + "v_bias")),
            BitLinear(weights[p + "o"]),
        )
        if cfg["moe_experts"]:
            ffn = moe_lib.MoE(weights[p + "router"], weights[p + "w1"], weights[p + "w3"],
                              weights[p + "w2"])
        else:
            ffn = FFN(BitLinear(weights[p + "w1"]), BitLinear(weights[p + "w3"]),
                      BitLinear(weights[p + "w2"]))
        blocks.append(lm_lib.Block(weights[p + "norm1"], attn, weights[p + "norm2"], ffn))
    return lm_lib.LM(weights["embed"], weights["final_norm"], weights.get("head"), blocks,
                     n_slots=1)

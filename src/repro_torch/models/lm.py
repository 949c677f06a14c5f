"""Decoder-only LM for serving (counterpart of ``repro/models/lm.py``).

The reference stacks each pattern slot's parameters over repeats and
scans over them; here the model is a tree of modules, ``LM`` ->
``nn.ModuleList`` of ``Block``s -> ``Attention`` / ``FFN`` ->
``BitLinear``, with layer ``r * P + i`` holding repeat ``r`` of pattern
slot ``i`` (P = ``len(cfg.pattern)``), the order the reference's scan
applies them in. Caches keep the reference's layout,
``{"slot<i>": {"k"/"v": (R, B, T, KV, D)}}``.

Inference consumers reach ``prefill`` / ``prefill_continue`` /
``decode_step`` / ``program_weights`` through
``repro_torch.compiler.compile``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core import bnn
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import rowblock_matmul
from repro_torch.models.config import ModelConfig, require_servable
from repro_torch.models.layers import (
    ACT_DTYPE,
    FFN,
    Attention,
    BitLinear,
    attention_block,
    attention_continue,
    attention_decode_step,
    ffn,
    infer_engine,
    rms_norm,
)


class Block(nn.Module):
    """One attention + SwiGLU layer (pre-norm residual)."""

    def __init__(self, norm1: torch.Tensor, attn: Attention, norm2: torch.Tensor, ffn: FFN):
        super().__init__()
        self.register_buffer("norm1", norm1)
        self.attn = attn
        self.register_buffer("norm2", norm2)
        self.ffn = ffn


class LM(nn.Module):
    """Embedding, the block stack, the final norm and the fp32 head
    (``head`` is ``None`` with tied embeddings: the head is ``embed.T``)."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 head: torch.Tensor | None, blocks: list[Block]):
        super().__init__()
        self.register_buffer("embed", embed)
        self.register_buffer("final_norm", final_norm)
        self.register_buffer("head", head)
        self.blocks = nn.ModuleList(blocks)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> LM:
    """Random parameters with the reference's shapes and distributions:
    N(0, 0.02^2) embeddings, N(0, 1/d_in) projections and head, zero
    biases, unit norm scales. Drawn from ``gen`` on its device, then
    placed on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    require_servable(cfg)

    def normal(shape, std: float) -> torch.Tensor:
        x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        return (x * std).to(dev)

    def ones(n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=torch.float32, device=dev)

    def proj(d_in: int, d_out: int, bias: bool = False) -> BitLinear:
        b = torch.zeros((d_out,), dtype=torch.float32, device=dev) if bias else None
        return BitLinear(normal((d_in, d_out), 1.0 / math.sqrt(d_in)), b)

    d, hd, vp = cfg.d_model, cfg.hd, cfg.padded_vocab
    embed = normal((vp, d), 0.02)
    head = None if cfg.tie_embeddings else normal((d, vp), 1.0 / math.sqrt(d))
    blocks = []
    for _ in range(cfg.n_layers):
        attn = Attention(
            proj(d, cfg.n_heads * hd, cfg.qkv_bias),
            proj(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
            proj(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
            proj(cfg.n_heads * hd, d),
        )
        f = FFN(proj(d, cfg.d_ff), proj(d, cfg.d_ff), proj(cfg.d_ff, d))
        blocks.append(Block(ones(d), attn, ones(d), f))
    return LM(embed, ones(d), head, blocks)


# ---------------------------------------------------------------------------
# Programming (the one-time crossbar write)
# ---------------------------------------------------------------------------

# The binarized projection tensors of the LM spine: the weights a
# crossbar holds resident.
BINARIZED_PROJECTIONS = {"attn": ("q", "k", "v", "o"), "ffn": ("w1", "w3", "w2")}


def _program(p: BitLinear, base) -> BitLinear:
    w = p.w
    return BitLinear(
        b=p.b,
        prepared=base.prepare(bnn.binarize_ste(w)),
        alpha=w.abs().mean().to(torch.float32),
    )


def _fused_qkv_artifact(attn: Attention, base) -> BitLinear | None:
    """The shared-activation [q|k|v] artifact for fused-dense engines:
    the three sign matrices concatenated along the output axis and
    programmed once, with a per-column alpha repeating each projection's
    ``mean|w|``. Packing is column-independent, so its columns are
    bit-identical to the three per-projection artifacts."""
    parts = (attn.q.w, attn.k.w, attn.v.w)
    if any(w is None for w in parts):
        return None
    alpha = torch.cat([w.abs().mean().to(torch.float32).expand(w.shape[1]) for w in parts])
    return BitLinear(
        prepared=base.prepare(bnn.binarize_ste(torch.cat(parts, dim=1))),
        alpha=alpha.contiguous(),
    )


def program_weights(model: LM, cfg: ModelConfig, engine) -> tuple[LM, int]:
    """Program every binarized projection into ``engine``'s resident
    form once, before serving: each attn q/k/v/o and FFN w1/w3/w2
    ``BitLinear`` is replaced by one holding the prepared artifact and
    its ``alpha`` (the latent weight is dropped, as the hardware holds
    only cell states), plus the fused [q|k|v] artifact for fused
    engines. Returns ``(programmed_model, n_programmed)``; the input
    model is not mutated (unchanged tensors are shared). No-op unless
    ``cfg.quant == "bnn"`` and an engine is bound."""
    if cfg.quant != "bnn" or engine is None:
        return model, 0
    base = getattr(engine, "base", engine)  # unwrap a GroupedEngine
    if not hasattr(base, "prepare"):
        return model, 0
    fused = getattr(base, "supports_fused_dense", False)
    blocks, n = [], 0
    for blk in model.blocks:
        a = blk.attn
        attn = Attention(
            *(_program(getattr(a, name), base) for name in BINARIZED_PROJECTIONS["attn"]),
            qkv=_fused_qkv_artifact(a, base) if fused else None,
        )
        f = FFN(*(_program(getattr(blk.ffn, name), base) for name in BINARIZED_PROJECTIONS["ffn"]))
        blocks.append(Block(blk.norm1, attn, blk.norm2, f))
        n += 7
    return LM(model.embed, model.final_norm, model.head, blocks), n


def programmed_projections(model: LM):
    """``(name, BitLinear)`` for every programmed projection, block by
    block: attn q/k/v/o, the fused [q|k|v] when present, FFN w1/w3/w2
    (``name`` is ``"<layer>.<part>.<proj>"``)."""
    for layer, blk in enumerate(model.blocks):
        for part, names in (("attn", (*BINARIZED_PROJECTIONS["attn"], "qkv")),
                            ("ffn", BINARIZED_PROJECTIONS["ffn"])):
            for name in names:
                p = getattr(getattr(blk, part), name)
                if p is not None and p.prepared is not None:
                    yield f"{layer}.{part}.{name}", p


def map_prepared(model: LM, fn) -> LM:
    """A new ``LM`` whose programmed projections hold ``fn(artifact)``
    in place of their artifact (biases and alphas kept; the input model
    is not mutated). The fault-refresh step of ``CompiledModel``."""

    def one(p: BitLinear | None) -> BitLinear | None:
        if p is None or p.prepared is None:
            return p
        return BitLinear(b=p.b, prepared=fn(p.prepared), alpha=p.alpha)

    blocks = []
    for blk in model.blocks:
        a, f = blk.attn, blk.ffn
        attn = Attention(*(one(getattr(a, n)) for n in BINARIZED_PROJECTIONS["attn"]),
                         qkv=one(a.qkv))
        ffn_ = FFN(*(one(getattr(f, n)) for n in BINARIZED_PROJECTIONS["ffn"]))
        blocks.append(Block(blk.norm1, attn, blk.norm2, ffn_))
    return LM(model.embed, model.final_norm, model.head, blocks)


# ---------------------------------------------------------------------------
# Prefill / decode (serving)
# ---------------------------------------------------------------------------


def _head_weights(model: LM, cfg: ModelConfig) -> torch.Tensor:
    return model.embed.T if cfg.tie_embeddings else model.head


def _mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-1e30 on the padding columns (see ModelConfig.padded_vocab)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    valid = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits, -1e30)


def _logits(model: LM, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Last-position fp32 logits. The head runs in blocks of
    ``ROW_BLOCK`` rows, so a row's logits do not depend on how many
    sequences share the call (a GEMM picks its algorithm by shape)."""
    h = rms_norm(h, model.final_norm, cfg.norm_eps)
    logits = rowblock_matmul(h[:, -1, :].to(torch.float32), _head_weights(model, cfg), 0)
    return _mask_padded_vocab(logits, cfg)


def _ffn_residual(blk: Block, h: torch.Tensor, cfg: ModelConfig, eng) -> torch.Tensor:
    hn = rms_norm(h, blk.norm2, cfg.norm_eps)
    return h + ffn(blk.ffn, hn, cfg.quant, eng)


def prefill(model: LM, tokens: torch.Tensor, cfg: ModelConfig, engine=None):
    """Forward over (B, S) prompt tokens. Returns last-position logits
    (B, V) fp32 and the prompt caches ``{"slot<i>": {"k"/"v":
    (R, B, S, KV, D)}}`` in bf16. ``engine`` overrides ``cfg.bnn_engine``
    for the binarized projections (serving passes its K-group
    ``GroupedEngine``)."""
    require_servable(cfg)
    tokens = tokens.to(device=model.embed.device, dtype=torch.int64)
    h = model.embed[tokens].to(ACT_DTYPE)
    positions = torch.arange(tokens.shape[1], device=h.device)
    eng = engine if engine is not None else infer_engine(cfg)
    n_slots = len(cfg.pattern)
    ks: list[list[torch.Tensor]] = [[] for _ in range(n_slots)]
    vs: list[list[torch.Tensor]] = [[] for _ in range(n_slots)]
    for layer, blk in enumerate(model.blocks):
        hn = rms_norm(h, blk.norm1, cfg.norm_eps)
        mix, (k, v) = attention_block(blk.attn, hn, positions, cfg, quant=cfg.quant, engine=eng)
        ks[layer % n_slots].append(k.to(ACT_DTYPE))
        vs[layer % n_slots].append(v.to(ACT_DTYPE))
        h = _ffn_residual(blk, h + mix, cfg, eng)
    caches = {
        f"slot{i}": {"k": torch.stack(ks[i]), "v": torch.stack(vs[i])}
        for i in range(n_slots)
    }
    return _logits(model, h, cfg), caches


class PrefixContinuationError(ValueError):
    """``prefill_continue`` was asked to continue a stack it cannot slice
    at a prefix boundary (SSM/hybrid mixers carry recurrent state, not
    per-position KV rows)."""


def prefill_continue(model: LM, tokens: torch.Tensor, prefix_caches: dict, cfg: ModelConfig,
                     engine=None):
    """Prefill only the suffix of a prompt whose prefix KV is cached.

    ``tokens`` (B, S) are the prompt positions after the shared prefix;
    ``prefix_caches`` is prefill-shaped (``{"slot<i>": {"k"/"v": (R, B,
    Lp, KV, D)}}``) and covers positions ``[0, Lp)`` of the same token
    prefix, typically sliced from an earlier :func:`prefill`. Returns
    ``(logits, caches)`` as :func:`prefill` over the full prompt would:
    last-position logits and full-prompt caches (prefix rows
    concatenated back in), bit for bit
    (:func:`~repro_torch.models.layers.attention_continue`).
    Attention-only stacks: anything else raises
    :class:`PrefixContinuationError`.
    """
    bad = [f"slot{i}" for i, kind in enumerate(cfg.pattern) if kind.mixer != "attn"]
    if bad:
        raise PrefixContinuationError(
            f"prefix continuation needs per-position KV rows; {cfg.name} has "
            f"non-attention mixer(s) at {', '.join(bad)} whose recurrent state "
            "cannot be sliced at a prefix boundary"
        )
    require_servable(cfg)
    tokens = tokens.to(device=model.embed.device, dtype=torch.int64)
    start = next(iter(prefix_caches.values()))["k"].shape[2]
    h = model.embed[tokens].to(ACT_DTYPE)
    positions = torch.arange(start, start + tokens.shape[1], device=h.device)
    eng = engine if engine is not None else infer_engine(cfg)
    n_slots = len(cfg.pattern)
    ks: list[list[torch.Tensor]] = [[] for _ in range(n_slots)]
    vs: list[list[torch.Tensor]] = [[] for _ in range(n_slots)]
    for layer, blk in enumerate(model.blocks):
        pre = prefix_caches[f"slot{layer % n_slots}"]
        r = layer // n_slots
        pk, pv = pre["k"][r], pre["v"][r]
        hn = rms_norm(h, blk.norm1, cfg.norm_eps)
        mix, (k, v) = attention_continue(
            blk.attn, hn, positions, pk, pv, cfg, quant=cfg.quant, engine=eng
        )
        ks[layer % n_slots].append(torch.cat([pk, k.to(ACT_DTYPE)], dim=1))
        vs[layer % n_slots].append(torch.cat([pv, v.to(ACT_DTYPE)], dim=1))
        h = _ffn_residual(blk, h + mix, cfg, eng)
    caches = {
        f"slot{i}": {"k": torch.stack(ks[i]), "v": torch.stack(vs[i])}
        for i in range(n_slots)
    }
    return _logits(model, h, cfg), caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=ACT_DTYPE, *, device) -> dict:
    """Zero decode caches (stacked over repeats) on ``device``."""
    require_servable(cfg)
    shape = (cfg.n_repeats, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        f"slot{i}": {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
        for i in range(len(cfg.pattern))
    }


def decode_step(model: LM, token: torch.Tensor, pos, caches: dict, cfg: ModelConfig, engine=None):
    """One serving step: token (B,), pos a scalar or (B,) per-slot
    positions, caches from ``init_cache``/``prefill``. Writes the new K/V
    rows into ``caches`` IN PLACE (the reference donates its caches to
    the same effect) and returns (logits (B, V), caches)."""
    token = token.to(device=model.embed.device, dtype=torch.int64)
    h = model.embed[token[:, None]].to(ACT_DTYPE)  # (B, 1, d)
    eng = engine if engine is not None else infer_engine(cfg)
    n_slots = len(cfg.pattern)
    for layer, blk in enumerate(model.blocks):
        c = caches[f"slot{layer % n_slots}"]
        r = layer // n_slots
        hn = rms_norm(h, blk.norm1, cfg.norm_eps)
        mix, _, _ = attention_decode_step(
            blk.attn, hn, pos, c["k"][r], c["v"][r], cfg, quant=cfg.quant, engine=eng
        )
        h = _ffn_residual(blk, h + mix, cfg, eng)
    return _logits(model, h, cfg), caches

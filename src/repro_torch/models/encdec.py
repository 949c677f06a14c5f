"""Encoder-decoder transformer (seamless-m4t style), serving half
(counterpart of ``repro/models/encdec.py``): a bidirectional encoder
over frontend embeddings (audio frames; the frontend itself is a stub
in the reference too, ``data.frontend_embeds``), and a causal decoder
whose layers add cross-attention over the encoder output.

The model is a tree of modules: ``EncDec`` -> ``enc_blocks`` of
:class:`EncoderLayer` (norm1, attn, norm2, ffn) and ``dec_blocks`` of
:class:`DecoderLayer` (norm1, self_attn, norm_x, cross_attn, norm2,
ffn), each projection a ``layers.BitLinear``. Caches keep the
reference's layout: ``self_k`` / ``self_v`` (L, B, T, KV, D) and
``cross_k`` / ``cross_v`` (L, B, Ss, KV, D), bf16.

Enc-dec models are not compiled onto a hardware target (``compile()``
refuses any engine but ``reference``, as the reference does): every
binarized projection runs through ``layers.dense`` on the engine that
``cfg.bnn_engine`` names (``layers.infer_engine``), from its latent
weights. On ``packed`` that is ``PackedEngine.binary_vmm``, the Hamming
kernel, behind the engine's bounded weight cache. The reference's
``encode`` and ``_cross_kv`` call ``dense`` without an engine (the
plain ±1 product); here they take the engine too, which gives the same
values (the ±1 sums are exact integers either way) and puts the encoder
on the kernel.

Training (``loss_fn``) takes the reference's plain path: no engine, the
straight-through estimator on every binarized projection, each encoder
and decoder layer checkpointed under ``cfg.remat`` (saving only its
bf16 input, as ``models/scan.py`` does for the LM), and the LM's
chunked fp32 loss over the untied head. :func:`param_tree`,
:func:`take_grad_tree`, :func:`load_param_tree_` and
:func:`update_params_` give and take the parameters and gradients in the
reference's tree, ``enc_blocks`` / ``dec_blocks`` stacked over layers,
the layout the optimizer, the checkpoints and ``convert`` work in.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch import tree as tree_lib
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ACT_DTYPE,
    FFN,
    Attention,
    BitLinear,
    attention_block,
    attention_decode_step,
    cross_attention_block,
    decode_attention,
    dense,
    embed_rows,
    ffn,
    frozen_parameter,
    hinted,
    infer_engine,
    merge_heads,
    rms_norm,
    split_heads,
)
from repro_torch.models.lm import _logits, _proj_leaves, lm_loss, update_stacked_
from repro_torch.models.scan import remat_scan

# the cache entries: decoder self-attention rows by position, and the
# cross-attention K/V over the whole encoder output (read-only in decode)
SELF_KEYS = ("self_k", "self_v")
CROSS_KEYS = ("cross_k", "cross_v")


class EncoderLayer(nn.Module):
    """Pre-norm bidirectional self-attention and SwiGLU FFN."""

    def __init__(self, norm1: torch.Tensor, attn: Attention, norm2: torch.Tensor, ffn: FFN):
        super().__init__()
        self.norm1 = frozen_parameter(norm1)
        self.attn = attn
        self.norm2 = frozen_parameter(norm2)
        self.ffn = ffn


class DecoderLayer(nn.Module):
    """Pre-norm causal self-attention, cross-attention over the encoder
    output (``norm_x`` before it) and SwiGLU FFN."""

    def __init__(self, norm1: torch.Tensor, self_attn: Attention, norm_x: torch.Tensor,
                 cross_attn: Attention, norm2: torch.Tensor, ffn: FFN):
        super().__init__()
        self.norm1 = frozen_parameter(norm1)
        self.self_attn = self_attn
        self.norm_x = frozen_parameter(norm_x)
        self.cross_attn = cross_attn
        self.norm2 = frozen_parameter(norm2)
        self.ffn = ffn


class EncDec(nn.Module):
    """Embedding, the encoder and decoder stacks, their final norms and
    the untied fp32 head (``embed`` (Vp, d), ``head`` (d, Vp), padded to
    ``cfg.padded_vocab``)."""

    def __init__(self, embed: torch.Tensor, head: torch.Tensor, enc_blocks: list[EncoderLayer],
                 enc_norm: torch.Tensor, dec_blocks: list[DecoderLayer],
                 final_norm: torch.Tensor):
        super().__init__()
        self.embed = frozen_parameter(embed)
        self.head = frozen_parameter(head)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_norm = frozen_parameter(enc_norm)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.final_norm = frozen_parameter(final_norm)


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> EncDec:
    """Random parameters with the reference's shapes and distributions:
    N(0, 0.02^2) embedding, N(0, 1/d_in) projections and head, unit norm
    scales, zero biases. Drawn from ``gen`` on its device, then placed on
    ``device`` (default ``cuda``; ``"meta"`` draws nothing)."""
    dev = resolve_device(device, meta=True)

    def normal(shape, std: float) -> torch.Tensor:
        if dev.type == "meta":  # shapes only: nothing drawn, nothing allocated
            return torch.empty(shape, dtype=torch.float32, device=dev)
        x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        return (x * std).to(dev)

    def ones() -> torch.Tensor:
        return torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)

    def proj(d_in: int, d_out: int, bias: bool = False) -> BitLinear:
        b = torch.zeros((d_out,), dtype=torch.float32, device=dev) if bias else None
        return BitLinear(normal((d_in, d_out), 1.0 / math.sqrt(d_in)), b)

    d, hd, vp = cfg.d_model, cfg.hd, cfg.padded_vocab

    def attn() -> Attention:
        return Attention(proj(d, cfg.n_heads * hd, cfg.qkv_bias),
                         proj(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                         proj(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                         proj(cfg.n_heads * hd, d))

    def swiglu() -> FFN:
        return FFN(proj(d, cfg.d_ff), proj(d, cfg.d_ff), proj(cfg.d_ff, d))

    embed = normal((vp, d), 0.02)
    head = normal((d, vp), 1.0 / math.sqrt(d))
    enc = [EncoderLayer(ones(), attn(), ones(), swiglu()) for _ in range(cfg.n_encoder_layers)]
    dec = [DecoderLayer(ones(), attn(), ones(), attn(), ones(), swiglu())
           for _ in range(cfg.n_layers)]
    return EncDec(embed, head, enc, ones(), dec, ones())


# ---------------------------------------------------------------------------
# The reference's stacked parameter tree
# ---------------------------------------------------------------------------

# the reference's layer subtrees: (name, kind) per child
ENC_LAYER = (("norm1", "norm"), ("attn", "attn"), ("norm2", "norm"), ("ffn", "ffn"))
DEC_LAYER = (("norm1", "norm"), ("self_attn", "attn"), ("norm_x", "norm"),
             ("cross_attn", "attn"), ("norm2", "norm"), ("ffn", "ffn"))
PROJECTIONS = {"attn": ("q", "k", "v", "o"), "ffn": ("w1", "w3", "w2")}
TOP = ("embed", "head", "enc_norm", "final_norm")


def _layer_leaves(layer: EncoderLayer | DecoderLayer, spec) -> dict:
    """One layer's parameters in the reference's layout."""
    out = {}
    for name, kind in spec:
        c = getattr(layer, name)
        out[name] = c if kind == "norm" else {
            n: _proj_leaves(getattr(c, n)) for n in PROJECTIONS[kind]}
    return out


def _stacks(model: EncDec):
    return (("enc_blocks", model.enc_blocks, ENC_LAYER),
            ("dec_blocks", model.dec_blocks, DEC_LAYER))


def _stacked(model: EncDec, top, per_layer) -> dict:
    """The reference's tree with ``top(t)`` at each top-level leaf and
    ``torch.stack([per_layer(t) for each layer])`` at each layer leaf."""
    tree = {name: top(getattr(model, name)) for name in TOP}
    for key, blocks, spec in _stacks(model):
        per = [_layer_leaves(b, spec) for b in blocks]
        tree[key] = tree_lib.map_with_path(
            lambda path, _: torch.stack([per_layer(tree_lib.get(t, path)) for t in per]), per[0])
    return tree


def param_tree(model: EncDec, device=None) -> dict:
    """The parameters as the reference's tree: ``embed``, ``head``,
    ``enc_norm``, ``final_norm`` and ``enc_blocks`` / ``dec_blocks``
    (``norm1``, ``attn`` or ``self_attn`` / ``norm_x`` / ``cross_attn``
    as ``<q|k|v|o>/{w, b}``, ``norm2``, ``ffn/<w1|w3|w2>/w``) stacked
    over layers. Fresh detached tensors on ``device`` (default: the
    model's; ``"meta"`` gives shapes and dtypes only), as
    ``lm.param_tree``."""
    return _stacked(model, lambda t: t.detach().to(device or t.device, copy=True),
                    lambda t: t.detach().to(device or t.device))


def take_grad_tree(model: EncDec) -> dict:
    """The gradients as :func:`param_tree` lays out the parameters (zeros
    where none arrived), clearing every ``.grad``."""

    def grad(p: torch.Tensor) -> torch.Tensor:
        g = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
        return g

    return _stacked(model, grad, grad)


@torch.no_grad()
def update_params_(model: EncDec, update) -> EncDec:
    """``lm.update_params_`` for an ``EncDec``: ``update(path, p)`` on
    every leaf of :func:`param_tree`'s layout, in place, one layer leaf's
    stack at a time."""
    for name in TOP:
        update((name,), getattr(model, name))
    for key, blocks, spec in _stacks(model):
        update_stacked_((key,), [_layer_leaves(b, spec) for b in blocks], update)
    return model


@torch.no_grad()
def load_param_tree_(model: EncDec, tree: dict) -> EncDec:
    """Copy a :func:`param_tree`-shaped tree into the model's parameters,
    in place."""
    for name in TOP:
        getattr(model, name).copy_(tree[name])
    for key, blocks, spec in _stacks(model):
        for i, blk in enumerate(blocks):
            tree_lib.map_with_path(
                lambda path, t: t.copy_(tree_lib.get(tree[key], path)[i]),
                _layer_leaves(blk, spec))
    return model


def _engine(cfg: ModelConfig, engine):
    return engine if engine is not None else infer_engine(cfg)


def _layers(body, h, blocks, cfg: ModelConfig):
    """``for blk in blocks: h = body(h, blk)``, each layer checkpointed
    under ``cfg.remat`` when a gradient is being recorded (loss and
    gradients equal the plain loop's bit for bit; serving runs plain)."""
    if cfg.remat and torch.is_grad_enabled():
        return remat_scan(body, h, blocks)
    for blk in blocks:
        h = body(h, blk)
    return h


def _encoder_layer(blk: EncoderLayer, h, positions, cfg: ModelConfig, eng):
    hn = rms_norm(h, blk.norm1, cfg.norm_eps)
    mix, _ = attention_block(blk.attn, hn, positions, cfg, causal=False, quant=cfg.quant,
                             engine=eng)
    h = hinted(h + mix, "dp", None, None)  # (the residual sums: see lm._ffn_residual)
    hn = rms_norm(h, blk.norm2, cfg.norm_eps)
    return hinted(h + ffn(blk.ffn, hn, cfg.quant, eng), "dp", None, None)


def encode(model: EncDec, src_embeds: torch.Tensor, cfg: ModelConfig, engine=None) -> torch.Tensor:
    """Bidirectional encoder over (B, Ss, d) frontend embeddings -> the
    normed (B, Ss, d) bf16 encoder output. ``engine`` overrides
    ``cfg.bnn_engine`` for the binarized projections (serving)."""
    return _encode(model, src_embeds, cfg, _engine(cfg, engine))


def _encode(model: EncDec, src_embeds: torch.Tensor, cfg: ModelConfig, eng) -> torch.Tensor:
    """The encoder on ``eng`` (``None``: the plain STE path training
    takes, as the reference's ``encode``)."""
    h = src_embeds.to(device=model.embed.device).to(ACT_DTYPE)
    positions = torch.arange(h.shape[1], device=h.device)
    h = _layers(lambda h, blk: _encoder_layer(blk, h, positions, cfg, eng), h, model.enc_blocks,
                cfg)
    return rms_norm(h, model.enc_norm, cfg.norm_eps)


def _cross_kv(blk: DecoderLayer, enc_out: torch.Tensor, cfg: ModelConfig, eng):
    """One decoder layer's cross-attention K/V (B, Ss, KV, D) over the
    encoder output (no RoPE)."""
    b, ss, _ = enc_out.shape
    k = split_heads(dense(blk.cross_attn.k, enc_out, cfg.quant, eng), b, ss, cfg.n_kv_heads, cfg.hd)
    v = split_heads(dense(blk.cross_attn.v, enc_out, cfg.quant, eng), b, ss, cfg.n_kv_heads, cfg.hd)
    return k, v


def decoder(model: EncDec, enc_out: torch.Tensor, tgt_tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """The training decoder pass: (B, St) target tokens over the encoder
    output -> (B, St, d) final-normed hidden states. Every projection
    runs the plain path (no engine), as in the reference; each layer is
    checkpointed under ``cfg.remat``."""
    tgt_tokens = tgt_tokens.to(device=model.embed.device, dtype=torch.int64)
    h = embed_rows(model.embed, tgt_tokens).to(ACT_DTYPE)
    positions = torch.arange(tgt_tokens.shape[1], device=h.device)
    h = _layers(lambda h, blk: _decoder_layer(blk, h, enc_out, positions, cfg, None)[0], h,
                model.dec_blocks, cfg)
    return rms_norm(h, model.final_norm, cfg.norm_eps)


def _decoder_layer(blk: DecoderLayer, h, enc_out, positions, cfg: ModelConfig, eng):
    """One decoder layer over whole sequences: the new residual stream
    and this layer's caches (bf16)."""
    hn = rms_norm(h, blk.norm1, cfg.norm_eps)
    mix, (k, v) = attention_block(blk.self_attn, hn, positions, cfg, quant=cfg.quant, engine=eng)
    h = hinted(h + mix, "dp", None, None)
    hn = rms_norm(h, blk.norm_x, cfg.norm_eps)
    ck, cv = _cross_kv(blk, enc_out, cfg, eng)
    h = hinted(h + cross_attention_block(blk.cross_attn, hn, (ck, cv), positions, cfg, cfg.quant,
                                         eng), "dp", None, None)
    hn = rms_norm(h, blk.norm2, cfg.norm_eps)
    h = hinted(h + ffn(blk.ffn, hn, cfg.quant, eng), "dp", None, None)
    return h, (k, v, ck, cv)


def loss_fn(model: EncDec, batch: dict, cfg: ModelConfig, aux_coef: float = 0.0) -> torch.Tensor:
    """Next-token loss over ``{"src_embeds": (B, Ss, d), "tokens": (B,
    St)}``: the encoder and decoder on the plain STE path (no engine, as
    the reference's), then the LM's sequence-chunked fp32 loss over the
    untied ``head``. ``aux_coef`` is the loop's common signature (an
    enc-dec stack has no MoE aux loss)."""
    enc_out = _encode(model, batch["src_embeds"], cfg, None)
    tokens = batch["tokens"].to(device=model.embed.device, dtype=torch.int64)
    hidden = decoder(model, enc_out, tokens, cfg)
    targets = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
    return lm_loss(model, hidden, targets, dataclasses.replace(cfg, tie_embeddings=False))


def prefill(model: EncDec, src_embeds: torch.Tensor, tgt_tokens: torch.Tensor,
            cfg: ModelConfig, engine=None):
    """Encode ``src_embeds`` (B, Ss, d), run the decoder over the (B, St)
    prompt; returns the last-position logits (B, Vp) fp32 (padding
    columns -1e30) and the caches ``{"self_k"/"self_v": (L, B, St, KV,
    D), "cross_k"/"cross_v": (L, B, Ss, KV, D)}`` bf16. ``engine``
    overrides ``cfg.bnn_engine`` for the binarized projections."""
    eng = _engine(cfg, engine)
    enc_out = encode(model, src_embeds, cfg, eng)
    tgt_tokens = tgt_tokens.to(device=model.embed.device, dtype=torch.int64)
    h = embed_rows(model.embed, tgt_tokens).to(ACT_DTYPE)
    positions = torch.arange(tgt_tokens.shape[1], device=h.device)
    per_key: dict[str, list[torch.Tensor]] = {key: [] for key in (*SELF_KEYS, *CROSS_KEYS)}
    for blk in model.dec_blocks:
        h, rows = _decoder_layer(blk, h, enc_out, positions, cfg, eng)
        for key, t in zip(per_key, rows, strict=True):
            per_key[key].append(t.to(ACT_DTYPE))
    return _logits(model, h, cfg), {key: torch.stack(ts) for key, ts in per_key.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int, dtype=ACT_DTYPE, *,
               device) -> dict:
    """Zero decode caches on ``device``: ``max_len`` self-attention rows
    and ``src_len`` cross-attention rows per decoder layer."""
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cross = (cfg.n_layers, batch, src_len, cfg.n_kv_heads, cfg.hd)
    return {
        **{key: torch.zeros(kv, dtype=dtype, device=device) for key in SELF_KEYS},
        **{key: torch.zeros(cross, dtype=dtype, device=device) for key in CROSS_KEYS},
    }


def graft_prefill_caches(caches: dict, pre: dict) -> dict:
    """Write :func:`prefill`'s caches into serving-capacity caches from
    :func:`init_cache`, in place: the prompt's self-attention rows into
    the time prefix, the cross K/V whole (the reference's serve loop)."""
    for key in SELF_KEYS:
        caches[key][:, :, : pre[key].shape[2]] = pre[key].to(caches[key].dtype)
    for key in CROSS_KEYS:
        caches[key].copy_(pre[key])
    return caches


def decode_step(model: EncDec, token: torch.Tensor, pos, caches: dict, cfg: ModelConfig,
                engine=None):
    """One decoder step over fixed cross K/V: token (B,), pos a scalar or
    (B,) positions. Writes the new self-attention rows into ``caches`` IN
    PLACE and returns (logits (B, Vp), caches). The cross-attention
    attends every source frame (``cache_len = Ss``) through
    ``layers.decode_attention``."""
    token = token.to(device=model.embed.device, dtype=torch.int64)
    b = token.shape[0]
    h = embed_rows(model.embed, token[:, None]).to(ACT_DTYPE)  # (B, 1, d)
    eng = _engine(cfg, engine)
    src_len = torch.full((b,), caches["cross_k"].shape[2], dtype=torch.int64, device=h.device)
    for layer, blk in enumerate(model.dec_blocks):
        hn = rms_norm(h, blk.norm1, cfg.norm_eps)
        mix, _, _ = attention_decode_step(blk.self_attn, hn, pos, caches["self_k"][layer],
                                          caches["self_v"][layer], cfg, cfg.quant, eng)
        h = hinted(h + mix, "dp", None, None)
        hn = rms_norm(h, blk.norm_x, cfg.norm_eps)
        q = split_heads(dense(blk.cross_attn.q, hn, cfg.quant, eng), b, 1, cfg.n_heads, cfg.hd)
        cross = decode_attention(q, caches["cross_k"][layer], caches["cross_v"][layer], src_len)
        h = hinted(h + dense(blk.cross_attn.o, merge_heads(cross, b, 1, cfg.n_heads * cfg.hd),
                             cfg.quant, eng), "dp", None, None)
        hn = rms_norm(h, blk.norm2, cfg.norm_eps)
        h = hinted(h + ffn(blk.ffn, hn, cfg.quant, eng), "dp", None, None)
    return _logits(model, h, cfg), caches

"""Transformer layers for serving: RMSNorm, RoPE, chunked GQA attention
(plain ops, or the flash-attention kernel), SwiGLU, and the BitLinear
seam (counterpart of ``repro/models/layers.py``, forward only).

Conventions as in the reference: activations bf16, accumulations and
normalizations fp32, latent weights fp32. Attention shapes are
(B, S, H, D). ``rms_norm``, ``rope``, attention and ``dense`` are plain
functions on tensors; the modules only hold weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import bnn
from repro_torch.core.engine import PreparedWeights
from repro_torch.kernels.flash_attention import ROW_BLOCK, flash_attention, rowblock_matmul
from repro_torch.kernels.ops import row_mean
from repro_torch.models.config import ModelConfig

ACT_DTYPE = torch.bfloat16
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Modules (weight holders)
# ---------------------------------------------------------------------------


class BitLinear(nn.Module):
    """One projection. Holds either the latent weight ``w`` (m, n) fp32,
    or -- once programmed by ``lm.program_weights`` -- the engine's
    resident ``words`` (the :class:`PreparedWeights` data) plus ``alpha``
    (the per-tensor ``mean|w|``, or one value per column for the fused
    [q|k|v] artifact). ``b`` is the optional bias. All are buffers: the
    serving slice computes no gradients.
    """

    def __init__(
        self,
        w: torch.Tensor | None = None,
        b: torch.Tensor | None = None,
        *,
        prepared: PreparedWeights | None = None,
        alpha: torch.Tensor | None = None,
    ):
        super().__init__()
        if (w is None) == (prepared is None):
            raise ValueError("a BitLinear holds either latent w or prepared weights")
        self.register_buffer("w", w)
        self.register_buffer("b", b)
        self.register_buffer("words", None if prepared is None else prepared.data)
        self.register_buffer("alpha", alpha)
        self._meta = None if prepared is None else (prepared.engine, prepared.m, prepared.n, prepared.aux)

    @property
    def prepared(self) -> PreparedWeights | None:
        """The programmed artifact (its tensor follows ``.to(device)``)."""
        if self._meta is None:
            return None
        engine, m, n, aux = self._meta
        return PreparedWeights(engine=engine, m=m, n=n, data=self.words, aux=aux)

    def extra_repr(self) -> str:
        if self.w is not None:
            return f"latent {tuple(self.w.shape)}, bias={self.b is not None}"
        engine, m, n, _ = self._meta
        return f"programmed for {engine} ({m}, {n}), bias={self.b is not None}"


class Attention(nn.Module):
    """q/k/v/o projections, plus the derived fused [q|k|v] artifact
    (``qkv``) that ``lm.program_weights`` attaches for fused engines."""

    def __init__(self, q: BitLinear, k: BitLinear, v: BitLinear, o: BitLinear,
                 qkv: BitLinear | None = None):
        super().__init__()
        self.q, self.k, self.v, self.o = q, k, v, o
        self.qkv = qkv


class FFN(nn.Module):
    """SwiGLU: w2(silu(w1 x) * w3 x)."""

    def __init__(self, w1: BitLinear, w3: BitLinear, w2: BitLinear):
        super().__init__()
        self.w1, self.w3, self.w2 = w1, w3, w2


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, returned in ``x``'s dtype. The mean's per-row
    arithmetic does not depend on the row count (:func:`row_mean`)."""
    xf = x.to(torch.float32)
    var = row_mean(xf * xf)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def infer_engine(cfg: ModelConfig):
    """Resolve ``cfg.bnn_engine`` into a backend for the binarized
    projections; ``None`` for the reference (plain ±1 matmul) path."""
    if cfg.quant != "bnn" or cfg.bnn_engine in ("", "reference"):
        return None
    from repro_torch.core import engine as engine_lib

    return engine_lib.get_engine(cfg.bnn_engine)


def _require_latent(p: BitLinear, engine) -> None:
    """A programmed projection carries only the engine artifact: reaching
    a path that needs the latent weights is a caller error."""
    if p.w is None:
        raise ValueError(
            f"projection was programmed for engine {p.prepared.engine!r} "
            "(lm.program_weights replaced the latent w with words/alpha); run "
            "it through that engine with quant='bnn', or use the original "
            f"un-programmed model (engine passed: {engine!r})"
        )


def dense(p: BitLinear, x: torch.Tensor, quant: str = "none", engine=None) -> torch.Tensor:
    """Linear layer; ``quant="bnn"`` routes through the paper's BitLinear:
    ``(binarize(x) @ binarize(w)) * (alpha * beta)`` with ``alpha =
    mean|w|`` per tensor and ``beta = mean|x|`` per token (batch rows stay
    uncoupled). ``engine`` executes the ±1 matmul through a registered
    backend; with a programmed projection and a fused engine the whole
    seam is one kernel launch (``engine.fused_dense``), bit-exact vs the
    unfused chain below.
    """
    if quant == "bnn":
        pw = p.prepared if engine is not None else None
        if pw is not None and getattr(engine, "supports_fused_dense", False):
            out = engine.fused_dense(x, pw, p.alpha).to(ACT_DTYPE)
        else:
            beta = row_mean(x.abs().to(torch.float32))
            xb = bnn.binarize_ste(x.to(torch.float32))
            if pw is not None:
                alpha = p.alpha
                dot = engine.binary_vmm(xb, pw).to(torch.float32)
            else:
                _require_latent(p, engine)
                w = p.w
                alpha = w.abs().mean().to(torch.float32)
                if engine is None:
                    dot = xb @ bnn.binarize_ste(w)
                elif hasattr(engine, "prepare_cached"):
                    # lazy: binarization runs only on a weight-cache miss
                    wx = engine.prepare_cached(lambda: bnn.binarize_ste(w), key=w)
                    dot = engine.binary_vmm(xb, wx).to(torch.float32)
                else:
                    dot = engine.binary_vmm(xb, bnn.binarize_ste(w)).to(torch.float32)
            out = (dot * (alpha * beta)).to(ACT_DTYPE)
    else:
        _require_latent(p, engine)
        out = torch.matmul(x, p.w.to(x.dtype))
    if p.b is not None:
        out = out + p.b.to(out.dtype)
    return out


def fused_qkv_dense(attn: Attention, x: torch.Tensor, cfg: ModelConfig, quant: str, engine):
    """One fused launch over the concatenated [q|k|v] artifact; returns
    (q, k, v) pre-reshape activations, or ``None`` when the artifact or
    the engine capability is absent (callers run three ``dense``)."""
    if (
        quant != "bnn"
        or attn.qkv is None
        or engine is None
        or not getattr(engine, "supports_fused_dense", False)
    ):
        return None
    out = engine.fused_dense(x, attn.qkv.prepared, attn.qkv.alpha).to(ACT_DTYPE)
    nq = cfg.n_heads * cfg.hd
    nkv = cfg.n_kv_heads * cfg.hd
    parts = (out[..., :nq], out[..., nq : nq + nkv], out[..., nq + nkv :])
    outs = []
    for proj, o in zip((attn.q, attn.k, attn.v), parts):
        outs.append(o + proj.b.to(o.dtype) if proj.b is not None else o)
    return tuple(outs)


def _qkv(attn: Attention, x: torch.Tensor, cfg: ModelConfig, quant: str, engine):
    qkv = fused_qkv_dense(attn, x, cfg, quant, engine)
    if qkv is None:
        qkv = tuple(dense(p, x, quant, engine) for p in (attn.q, attn.k, attn.v))
    return qkv


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x (B, S, H, D), positions (B, S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    causal: bool,
    chunk: int,
    impl: str = "jnp",
) -> torch.Tensor:
    """Chunked online-softmax attention with fp32 statistics.

    q (B, Sq, H, D); k/v (B, Skv, KV, D); positions (S,)-shaped. Returns
    (B, Sq, H, D) in q's dtype. The probabilities and values of each
    chunk round to bf16 before an fp32 contraction, as the reference's
    bf16 einsum with fp32 accumulation does. The queries are the last Sq
    of the Skv positions (every model path gives them so), and both
    contractions run in row blocks aligned to those absolute positions
    (``rowblock_matmul``), so a row's result does not depend on Sq: a
    prefix-grafted continuation equals the full prefill bit for bit.

    ``impl="pallas"`` routes through the fused flash-attention kernel
    (``kernels/flash_attention.py``) on the (B, H, S, D) layout.
    """
    if impl == "pallas":
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal
        )
        return out.transpose(1, 2)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    head_map = torch.arange(h, device=q.device) // g  # head -> kv head
    first_row = skv - sq  # absolute position of query row 0

    n_chunks = math.ceil(skv / chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=2**30)
        causal = True  # padded keys must be masked out via positions

    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    qf = q.to(torch.float32).transpose(1, 2)  # (B, H, Sq, D)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kh = k[:, sl][:, :, head_map].to(torch.float32)  # (B, C, H, D)
        vh = v[:, sl][:, :, head_map]
        s = rowblock_matmul(qf, kh.permute(0, 2, 3, 1), first_row) * scale  # (B, H, Sq, C)
        if causal:
            mask = kv_positions[sl][None, :] <= q_positions[:, None]  # (Sq, C)
            s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(mask[None, None], p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        av = rowblock_matmul(
            p.to(torch.bfloat16).to(torch.float32),
            vh.to(torch.bfloat16).to(torch.float32).transpose(1, 2),
            first_row,
        )
        acc = acc * corr[..., None] + av
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len: torch.Tensor
) -> torch.Tensor:
    """Single-token attention against a (B, T, KV, D) cache; positions
    >= ``cache_len`` are masked. q (B, 1, H, D). Normalizes, then
    contracts (the reference's order, which rounds differently from the
    prefill path).

    The lanes run in blocks of ``ROW_BLOCK`` (the last one padded), so
    every product has one shape whatever the lane count: a GEMM picks
    its algorithm by shape, and a lane's result must not depend on how
    many slots share the tick (batched == solo)."""
    b = q.shape[0]
    pad = (-b) % ROW_BLOCK
    if pad:
        q, k_cache, v_cache = (F.pad(t, (0, 0, 0, 0, 0, 0, 0, pad)) for t in (q, k_cache, v_cache))
        cache_len = F.pad(cache_len, (0, pad), value=1)
    out = torch.cat([
        _decode_block(q[i : i + ROW_BLOCK], k_cache[i : i + ROW_BLOCK],
                      v_cache[i : i + ROW_BLOCK], cache_len[i : i + ROW_BLOCK])
        for i in range(0, b + pad, ROW_BLOCK)
    ])
    return out[:b]


def _decode_block(q, k_cache, v_cache, cache_len):
    b, _, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, d)
    s = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32), k_cache.to(torch.float32))
    s = s / math.sqrt(d)
    mask = torch.arange(t, device=q.device)[None, :] < cache_len[:, None]  # (B, T)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(q.dtype)


def attention_block(
    attn: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    quant: str = "none",
    engine=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill). Returns (out, (k, v))."""
    b, s, _ = x.shape
    hd = cfg.hd
    qkv = _qkv(attn, x, cfg, quant, engine)
    q = rope(qkv[0].reshape(b, s, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = rope(qkv[1].reshape(b, s, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    v = qkv[2].reshape(b, s, cfg.n_kv_heads, hd)
    out = multi_head_attention(
        q, k, v, positions, positions, causal=causal, chunk=cfg.attn_chunk,
        impl=cfg.attn_impl,
    )
    out = dense(attn.o, out.reshape(b, s, cfg.n_heads * hd), quant, engine)
    return out, (k, v)


def attention_continue(
    attn: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    prefix_k: torch.Tensor,
    prefix_v: torch.Tensor,
    cfg: ModelConfig,
    *,
    quant: str = "none",
    engine=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Prefill continuation over a grafted KV prefix (prefix caching).

    ``x`` holds the suffix at absolute ``positions`` (starting at the
    prefix length); ``prefix_k``/``prefix_v`` (B, start, KV, D) are the
    cached rows of positions ``[0, start)`` from an earlier prefill of
    the same token prefix. Returns (out, (k, v)) with k/v covering only
    the suffix; the caller concatenates them after the prefix rows.

    Equal to the full prefill bit for bit, as in the reference: cached
    prefix rows do not depend on what followed them (causal masking adds
    exact zeros), and the suffix runs through the same attention as a
    prefill, whose per-row arithmetic does not depend on Sq
    (:func:`multi_head_attention`, the flash kernel). RoPE applies to the
    suffix only; the prefix rows join in the activation dtype.
    """
    b, s, _ = x.shape
    hd = cfg.hd
    qkv = _qkv(attn, x, cfg, quant, engine)
    q = rope(qkv[0].reshape(b, s, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = rope(qkv[1].reshape(b, s, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    v = qkv[2].reshape(b, s, cfg.n_kv_heads, hd)
    k_full = torch.cat([prefix_k.to(k.dtype), k], dim=1)
    v_full = torch.cat([prefix_v.to(v.dtype), v], dim=1)
    kv_positions = torch.arange(k_full.shape[1], device=x.device)
    out = multi_head_attention(
        q, k_full, v_full, positions, kv_positions, causal=True,
        chunk=cfg.attn_chunk, impl=cfg.attn_impl,
    )
    out = dense(attn.o, out.reshape(b, s, cfg.n_heads * hd), quant, engine)
    return out, (k, v)


def attention_decode_step(
    attn: Attention,
    x: torch.Tensor,
    pos: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cfg: ModelConfig,
    quant: str = "none",
    engine=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step. x (B, 1, d); pos a scalar or (B,) per-slot
    positions; caches (B, T, KV, D). Writes this token's K/V into the
    caches IN PLACE (callers keep positions inside the cache: an index
    past its end raises) and returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    hd = cfg.hd
    qkv = _qkv(attn, x, cfg, quant, engine)
    pos_vec = torch.as_tensor(pos, device=x.device).to(torch.int64).expand(b)
    posb = pos_vec[:, None]
    q = rope(qkv[0].reshape(b, 1, cfg.n_heads, hd), posb, cfg.rope_theta)
    k = rope(qkv[1].reshape(b, 1, cfg.n_kv_heads, hd), posb, cfg.rope_theta)
    v = qkv[2].reshape(b, 1, cfg.n_kv_heads, hd)
    rows = torch.arange(b, device=x.device)
    cache_k[rows, pos_vec] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, pos_vec] = v[:, 0].to(cache_v.dtype)
    out = decode_attention(q, cache_k, cache_v, pos_vec + 1)
    out = dense(attn.o, out.reshape(b, 1, cfg.n_heads * hd), quant, engine)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------


def ffn(p: FFN, x: torch.Tensor, quant: str = "none", engine=None) -> torch.Tensor:
    h = dense(p.w1, x, quant, engine).to(torch.float32)
    h = (h * torch.sigmoid(h)).to(x.dtype)  # silu, as x * sigmoid(x)
    h = h * dense(p.w3, x, quant, engine)
    return dense(p.w2, h, quant, engine)

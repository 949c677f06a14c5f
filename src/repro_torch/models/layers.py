"""Transformer layers: RMSNorm (with the reference's hand-written
backward), RoPE, chunked GQA attention (plain ops, or the
flash-attention kernel), SwiGLU, and the BitLinear seam (counterpart of
``repro/models/layers.py``).

Conventions as in the reference: activations bf16, accumulations and
normalizations fp32, latent weights fp32. Attention shapes are
(B, S, H, D). ``rms_norm``, ``rope``, attention and ``dense`` are plain
functions on tensors; the modules only hold weights. Latent weights are
``nn.Parameter``s that require no grad until a trainer asks
(``model.requires_grad_(True)``), so serving records no autograd graph.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.core import bnn
from repro_torch.core.engine import PreparedWeights
from repro_torch.kernels import rows
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig

ACT_DTYPE = torch.bfloat16
NEG_INF = -1e30
# the profiler's name for a latent projection's weight side in ``dense``
LATENT_WEIGHT_SPAN = "dense.latent_weight"


# ---------------------------------------------------------------------------
# Modules (weight holders)
# ---------------------------------------------------------------------------


def frozen_parameter(t: torch.Tensor | None) -> nn.Parameter | None:
    """``t`` as a parameter that requires no grad (``None`` stays)."""
    return None if t is None else nn.Parameter(t, requires_grad=False)


# A plain bf16 product's fp32 weights (MoE experts, Mamba projections):
# ``lm.program_weights`` gives their modules a resident ACT_DTYPE copy of
# each, the buffer ``<name>_resident``; ``product_weights`` reads it, or
# casts per call where a module holds none. Each pick is counted in
# ``model_weight_cast_total{site, outcome="resident"|"cast"}``.
RESIDENT = "_resident"
CAST_COUNTER = "model_weight_cast_total"
CAST_COUNTER_HELP = "plain bf16 products' weight picks: resident copies or a per-call cast"


def register_resident_(module: nn.Module, names, resident: bool) -> None:
    """Register ``<name>_resident`` for each named fp32 parameter of
    ``module``: with ``resident``, its ACT_DTYPE copy, made by the ``.to``
    that a per-call cast makes, on the parameter's device and placement,
    so the products read the same bits; else (or where the parameter is
    ``None``) ``None``. Buffers, so they follow ``.to(device)``; not
    saved, as the fp32 leaves are the model's state."""
    for name in names:
        w = getattr(module, name)
        copy = w.detach().to(ACT_DTYPE) if resident and w is not None else None
        module.register_buffer(name + RESIDENT, copy, persistent=False)


def product_weights(module: nn.Module, names, dtype: torch.dtype, site: str) -> list[torch.Tensor]:
    """``module``'s named fp32 weights in ``dtype`` for a product: the
    resident copies where it holds them in ``dtype`` and the weights take
    no grad (a programmed model), else each cast for this call (an
    unprogrammed model, or one in training, whose latents move)."""
    ws = [getattr(module, n) for n in names]
    held = [getattr(module, n + RESIDENT) for n in names]
    if all(h is not None and h.dtype == dtype for h in held) \
            and not any(w.requires_grad for w in ws):
        obs.count(CAST_COUNTER, 1, CAST_COUNTER_HELP, site=site, outcome="resident")
        return held
    obs.count(CAST_COUNTER, 1, CAST_COUNTER_HELP, site=site, outcome="cast")
    return [w.to(dtype) for w in ws]


class BitLinear(nn.Module):
    """One projection. Holds either the latent weight ``w`` (m, n) fp32,
    or -- once programmed by ``lm.program_weights`` -- the engine's
    resident ``words`` (the :class:`PreparedWeights` data) plus ``alpha``
    (the per-tensor ``mean|w|``, or one value per column for the fused
    [q|k|v] artifact). A fault-injecting engine's artifact carries
    ``(data, delta)``: the inner engine's data goes to ``words`` and the
    fault delta (or ``None``) to ``delta``. ``b`` is the optional bias.
    ``w`` and ``b`` are parameters (trainable once asked); the programmed
    artifact is buffers.
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
        self.register_parameter("w", frozen_parameter(w))
        self.register_parameter("b", frozen_parameter(b))
        data = None if prepared is None else prepared.data
        self._with_delta = isinstance(data, tuple)
        words, delta = data if self._with_delta else (data, None)
        self.register_buffer("words", words)
        self.register_buffer("delta", delta)
        self.register_buffer("alpha", alpha)
        self._meta = None if prepared is None else (prepared.engine, prepared.m, prepared.n, prepared.aux)

    @property
    def prepared(self) -> PreparedWeights | None:
        """The programmed artifact (its tensor follows ``.to(device)``)."""
        if self._meta is None:
            return None
        engine, m, n, aux = self._meta
        data = (self.words, self.delta) if self._with_delta else self.words
        return PreparedWeights(engine=engine, m=m, n=n, data=data, aux=aux)

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
# Placement on a sharded mesh (DTensors; identity for plain tensors)
# ---------------------------------------------------------------------------

_PLAIN = rows.PLAIN


def gathered(w: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """A weight as a product uses it (``distributed.hints.weight``: a
    DTensor gathered over the axes ``axis`` resolves to). One type check
    for a plain tensor, which is returned as is."""
    if type(w) in _PLAIN:
        return w
    from repro_torch.distributed.hints import weight

    return weight(w, axis)


def hinted(x: torch.Tensor, *axes, force: bool = False) -> torch.Tensor:
    """``distributed.hints.hint(x, *axes)`` for a DTensor; a plain tensor
    (one type check) is returned as is."""
    if type(x) in _PLAIN:
        return x
    from repro_torch.distributed.hints import hint

    return hint(x, *axes, force=force)


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; on a mesh the vocab-parallel lookup (the table's
    rows stay on the model axis, the rows each rank misses are summed in)
    with the batch pinned to the data axes."""
    if type(table) in _PLAIN:
        return table[ids]
    from repro_torch.distributed.hints import reduced

    out = reduced(F.embedding(ids, gathered(table)))
    return hinted(out, "dp", *([None] * (out.ndim - 1)))


def split_heads(x: torch.Tensor, b: int, s: int, n: int, hd: int) -> torch.Tensor:
    """(b, s, n * hd) -> (b, s, n, hd) with the reference's hint
    ``("dp", None, "model", None)``: on a mesh whose model axis does not
    divide ``n`` the heads are gathered first (a view cannot split a
    head across ranks)."""
    if type(x) not in _PLAIN:
        from repro_torch.distributed.hints import hint_heads

        x = hint_heads(x, n)
    return x.reshape(b, s, n, hd)


def merge_heads(x: torch.Tensor, b: int, s: int, width: int) -> torch.Tensor:
    """(b, s, n, hd) -> (b, s, n * hd), placed as :func:`split_heads`
    places its input, so that the gradient's way back through the view
    is even too."""
    n = x.shape[2]
    x = x.reshape(b, s, width)
    if type(x) not in _PLAIN:
        from repro_torch.distributed.hints import hint_heads

        x = hint_heads(x, n)
    return x


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = rows.row_mean(xf * xf)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """The reference's custom VJP: the forward saves only the input in
    its own dtype (bf16 in the residual stream) and the scale; the
    backward recomputes the fp32 statistics. Autodiff of the plain
    forward would save the fp32 upcast of x per layer as well."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm(x, scale, ctx.eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf = x.to(torch.float32)
        gf = g.to(torch.float32)
        inv = torch.rsqrt(rows.row_mean(xf * xf) + ctx.eps)
        xhat = xf * inv
        d_scale = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
        gs = gf * scale.to(torch.float32)
        dx = inv * (gs - xhat * rows.row_mean(gs * xhat))
        return dx.to(x.dtype), d_scale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, returned in ``x``'s dtype. The mean's per-row
    arithmetic does not depend on the row count (``rows.row_mean``). With
    grad enabled and an input that requires it, the backward is the
    reference's hand-written one (:class:`_RMSNorm`)."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _rms_norm(x, scale, eps)


class _Abs(torch.autograd.Function):
    """``|x|`` with XLA's derivative, ``select(x >= 0, g, -g)``: +g at
    zero, where torch's ``abs`` gives 0. A BitLinear's output is an
    exact zero wherever its ±1 sum is (often), so the two differ in the
    next layer's scale gradients."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs(x: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Abs.apply(x)
    return x.abs()


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
            beta = rows.row_mean(_abs(x).to(torch.float32))
            xb = bnn.binarize_ste(x.to(torch.float32))
            if pw is not None:
                alpha = p.alpha
                dot = engine.binary_vmm(xb, pw).to(torch.float32)
            else:
                _require_latent(p, engine)
                w = gathered(p.w)
                # the weight side of a latent projection, named for the
                # profiler: alpha and, on a weight-cache miss, the
                # binarize + pack
                with obs.range(LATENT_WEIGHT_SPAN):
                    alpha = _abs(w).mean().to(torch.float32)
                    if engine is not None and hasattr(engine, "prepare_cached"):
                        # lazy: binarization runs only on a weight-cache miss
                        wx = engine.prepare_cached(lambda: bnn.binarize_ste(w), key=w)
                    else:
                        wx = bnn.binarize_ste(w)
                if engine is None:
                    dot = xb @ wx
                else:
                    dot = engine.binary_vmm(xb, wx).to(torch.float32)
            out = (dot * (alpha * beta)).to(ACT_DTYPE)
    else:
        _require_latent(p, engine)
        out = torch.matmul(x, gathered(p.w.to(x.dtype)))
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


def _positioned(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q or k at ``positions``: RoPE, or ``x`` itself where the model
    has no position embedding (``cfg.rope`` False, NoPE)."""
    return rope(x, positions, cfg.rope_theta) if cfg.rope else x


def _scale(cfg: ModelConfig) -> float | None:
    """The attention logits' scale the config gives, or ``None`` for
    ``1 / sqrt(head_dim)``."""
    return cfg.attn_scale or None


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


class FlashBackwardError(NotImplementedError):
    """A gradient was asked for through the flash-attention kernel."""


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
    scale: float | None = None,
) -> torch.Tensor:
    """Chunked online-softmax attention with fp32 statistics; the logits
    are scaled by ``scale`` (``None``: ``1 / sqrt(D)``).

    q (B, Sq, H, D); k/v (B, Skv, KV, D); positions (S,)-shaped. Returns
    (B, Sq, H, D) in q's dtype. The probabilities and values of each
    chunk round to bf16 before an fp32 contraction, as the reference's
    bf16 einsum with fp32 accumulation does. Both contractions run in
    blocks of 16 query rows (``rows.matmul``) aligned to row
    ``Skv - Sq``. In self-attention the queries are the last Sq of the
    Skv positions, so that is their absolute position and a row's result
    does not depend on Sq: a prefix-grafted continuation equals the full
    prefill bit for bit. Cross-attention's queries are decoder positions
    over encoder frames, so ``Skv - Sq`` is only an offset (negative for
    a prompt longer than the source; the blocks are whole either way):
    the products are exact as always, and no row-count invariant is
    asked of them, since an enc-dec prompt is never continued. A prefill
    inside ``rows.sequence_products`` takes them one product per
    sequence instead (``rows.by_sequence``).

    When ``Skv`` is not a multiple of ``chunk`` the keys are padded and
    masked by position, which turns on the causal mask for the real keys
    too, as the reference does (it makes seamless's smoke encoder
    causal, and masks the frames past a decoder position in its
    cross-attention; at full width 512 frames fill one chunk). The flash
    path has no such rule.

    ``impl="pallas"`` routes through the fused flash-attention kernel
    (``kernels/flash_attention.py``) on the (B, H, S, D) layout. It has
    no backward (nor has the reference's): a gradient through it raises
    :class:`FlashBackwardError`. It scales by ``1 / sqrt(D)`` only, so a
    given ``scale`` raises there.
    """
    if impl == "pallas":
        if scale is not None:
            raise NotImplementedError(
                "the flash-attention kernel scales by 1/sqrt(head_dim); a config's "
                "attn_scale needs attn_impl='jnp'"
            )
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise FlashBackwardError(
                "attn_impl='pallas' runs the flash-attention kernel, which has no "
                "backward (the JAX reference's cannot be differentiated either); "
                "train with attn_impl='jnp'"
            )
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal
        )
        return out.transpose(1, 2)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if scale is None:
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

    def products(x, y):
        return rows.by_sequence(torch.matmul, (x, y),
                                 blocked=lambda x, y: rows.matmul(x, y, first_row))

    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kh = _expand_heads(k[:, sl], head_map, g).to(torch.float32)  # (B, C, H, D)
        vh = _expand_heads(v[:, sl], head_map, g)
        s = products(qf, kh.permute(0, 2, 3, 1)) * scale  # (B, H, Sq, C)
        if causal:
            mask = kv_positions[sl][None, :] <= q_positions[:, None]  # (Sq, C)
            s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(mask[None, None], p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        av = products(
            p.to(torch.bfloat16).to(torch.float32),
            vh.to(torch.bfloat16).to(torch.float32).transpose(1, 2),
        )
        acc = acc * corr[..., None] + av
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _expand_heads(t: torch.Tensor, head_map: torch.Tensor, g: int) -> torch.Tensor:
    """(B, C, KV, D) -> (B, C, H, D), head ``h`` reading KV head ``h //
    g``. On a mesh, as a broadcast view (an index's backward is an
    ``index_put`` some DTensor versions cannot place) whose heads then
    follow q's over the model axis."""
    if type(t) in _PLAIN:
        return t[:, :, head_map]
    b, c, kvh, d = t.shape
    t = t.unsqueeze(3).expand(b, c, kvh, g, d).reshape(b, c, kvh * g, d)
    return hinted(t, "dp", None, "model", None)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token attention against a (B, T, KV, D) cache; positions
    >= ``cache_len`` are masked. q (B, 1, H, D); the logits scaled by
    ``scale`` (``None``: divided by ``sqrt(D)``). Normalizes, then
    contracts (the reference's order, which rounds differently from the
    prefill path).

    The lanes run in blocks of ``rows.ROWS`` (the last one padded), so
    every product has one shape whatever the lane count: a GEMM picks
    its algorithm by shape, and a lane's result must not depend on how
    many slots share the tick (batched == solo). On a mesh the query's
    heads are gathered: the grouped view splits them by KV head, and the
    cache's time axis holds the model axis."""
    q = hinted(q, "dp", None, None, None, force=True)
    return rows.blocks(functools.partial(_decode_block, scale=scale),
                       (q, k_cache, v_cache, cache_len), dim=0)


def _decode_block(q, k_cache, v_cache, cache_len, scale=None):
    b, _, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, d)
    s = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32), k_cache.to(torch.float32))
    s = s / math.sqrt(d) if scale is None else s * scale
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
    q = _positioned(split_heads(qkv[0], b, s, cfg.n_heads, hd), positions, cfg)
    k = _positioned(split_heads(qkv[1], b, s, cfg.n_kv_heads, hd), positions, cfg)
    v = split_heads(qkv[2], b, s, cfg.n_kv_heads, hd)
    out = multi_head_attention(
        q, k, v, positions, positions, causal=causal, chunk=cfg.attn_chunk,
        impl=cfg.attn_impl, scale=_scale(cfg),
    )
    out = hinted(out, "dp", None, "model", None)
    out = dense(attn.o, merge_heads(out, b, s, cfg.n_heads * hd), quant, engine)
    return out, (k, v)


def cross_attention_block(
    attn: Attention,
    x: torch.Tensor,
    kv: tuple[torch.Tensor, torch.Tensor],
    positions: torch.Tensor,
    cfg: ModelConfig,
    quant: str = "none",
    engine=None,
) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (B, Ss, KV, D):
    non-causal, the keys at source positions ``0 .. Ss - 1``, no RoPE."""
    b, s, _ = x.shape
    hd = cfg.hd
    k, v = kv
    q = split_heads(dense(attn.q, x, quant, engine), b, s, cfg.n_heads, hd)
    src_pos = torch.arange(k.shape[1], device=x.device)
    out = multi_head_attention(
        q, k, v, positions, src_pos, causal=False, chunk=cfg.attn_chunk,
        impl=cfg.attn_impl,
    )
    return dense(attn.o, merge_heads(out, b, s, cfg.n_heads * hd), quant, engine)


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
    (:func:`multi_head_attention`, the flash kernel). RoPE (where the
    model has it) applies to the suffix only; the prefix rows join in the activation dtype.
    """
    b, s, _ = x.shape
    hd = cfg.hd
    qkv = _qkv(attn, x, cfg, quant, engine)
    q = _positioned(split_heads(qkv[0], b, s, cfg.n_heads, hd), positions, cfg)
    k = _positioned(split_heads(qkv[1], b, s, cfg.n_kv_heads, hd), positions, cfg)
    v = split_heads(qkv[2], b, s, cfg.n_kv_heads, hd)
    k_full = torch.cat([prefix_k.to(k.dtype), k], dim=1)
    v_full = torch.cat([prefix_v.to(v.dtype), v], dim=1)
    kv_positions = torch.arange(k_full.shape[1], device=x.device)
    out = multi_head_attention(
        q, k_full, v_full, positions, kv_positions, causal=True,
        chunk=cfg.attn_chunk, impl=cfg.attn_impl, scale=_scale(cfg),
    )
    out = hinted(out, "dp", None, "model", None)
    out = dense(attn.o, merge_heads(out, b, s, cfg.n_heads * hd), quant, engine)
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
    q = _positioned(split_heads(qkv[0], b, 1, cfg.n_heads, hd), posb, cfg)
    k = _positioned(split_heads(qkv[1], b, 1, cfg.n_kv_heads, hd), posb, cfg)
    v = split_heads(qkv[2], b, 1, cfg.n_kv_heads, hd)
    rows = torch.arange(b, device=x.device)
    if type(cache_k) in _PLAIN:
        cache_k[rows, pos_vec] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, pos_vec] = v[:, 0].to(cache_v.dtype)
    else:  # a sharded cache: each rank writes its own rows
        from repro_torch.distributed.hints import write_positions_

        write_positions_(cache_k, pos_vec, k[:, 0])
        write_positions_(cache_v, pos_vec, v[:, 0])
    out = decode_attention(q, cache_k, cache_v, pos_vec + 1, _scale(cfg))
    out = dense(attn.o, merge_heads(out, b, 1, cfg.n_heads * hd), quant, engine)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------


def ffn(p: FFN, x: torch.Tensor, quant: str = "none", engine=None) -> torch.Tensor:
    h = dense(p.w1, x, quant, engine).to(torch.float32)
    h = (h * torch.sigmoid(h)).to(x.dtype)  # silu, as x * sigmoid(x)
    h = hinted(h * dense(p.w3, x, quant, engine), "dp", None, "model")
    return dense(p.w2, h, quant, engine)

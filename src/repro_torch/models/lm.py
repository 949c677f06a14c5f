"""Decoder-only LM: the training forward and loss, and serving
(counterpart of ``repro/models/lm.py``).

The reference stacks each pattern slot's parameters over repeats and
scans over them; here the model is a tree of modules, ``LM`` ->
``nn.ModuleList`` of ``Block``s -> a mixer (``Attention`` or
``ssm.Mamba``) and an FFN (``FFN``, ``moe.MoE`` or none) -> ``BitLinear``
for the attention and dense-FFN projections, with layer ``r * P + i``
holding repeat ``r`` of pattern slot ``i`` (P = ``len(cfg.pattern)``,
``LM.n_slots``), the order the reference's scan applies them in. Caches
keep the reference's layout, ``{"slot<i>": {"k"/"v": (R, B, T, KV, D)}}``
for attention slots and ``{"conv_x"/"conv_b"/"conv_c": (R, B, K-1, C),
"ssm": (R, B, H, N, P)}`` for Mamba slots, and :func:`param_tree` gives
the parameters in the reference's stacked tree, the layout the
optimizer, the checkpoints and ``convert`` work in.

Training calls :func:`loss_fn` (per-block rematerialization,
``models/scan.py``; the sequence-chunked fp32 loss). Inference consumers
reach ``prefill`` / ``prefill_continue`` / ``decode_step`` /
``program_weights`` through ``repro_torch.compiler.compile``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch import tree as tree_lib
from repro_torch.core import bnn
from repro_torch.device import resolve_device
from repro_torch.kernels import rows
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ACT_DTYPE,
    FFN,
    RESIDENT,
    Attention,
    BitLinear,
    attention_block,
    attention_continue,
    attention_decode_step,
    ffn,
    embed_rows,
    frozen_parameter,
    gathered,
    hinted,
    infer_engine,
    rms_norm,
)
from repro_torch.models.scan import remat_scan


class Block(nn.Module):
    """One pre-norm residual layer: a ``mixer`` (:class:`Attention` or
    :class:`~repro_torch.models.ssm.Mamba`) and, unless the layer is
    mixer-only (mamba2's ``d_ff = 0``), ``norm2`` and an ``ffn`` (SwiGLU
    :class:`FFN` or :class:`~repro_torch.models.moe.MoE`); the absent
    ones are ``None``. :func:`_mix`, :func:`_mix_step`,
    :func:`_ffn_residual` and :func:`_block_leaves` dispatch on the
    children's types."""

    def __init__(self, norm1: torch.Tensor, mixer: Attention | ssm_lib.Mamba,
                 norm2: torch.Tensor | None = None, ffn: FFN | moe_lib.MoE | None = None):
        super().__init__()
        if (norm2 is None) != (ffn is None):
            raise ValueError("a block has norm2 exactly when it has an FFN")
        self.norm1 = frozen_parameter(norm1)
        self.mixer = mixer
        self.register_parameter("norm2", frozen_parameter(norm2))
        self.ffn = ffn


class LM(nn.Module):
    """Embedding, the block stack, the final norm and the fp32 head
    (``head`` is ``None`` with tied embeddings: the head is ``embed.T``).
    ``n_slots`` is the pattern's period P (blocks ``r * P + i`` stack as
    the reference's ``slot<i>``)."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 head: torch.Tensor | None, blocks: list[Block], n_slots: int = 1):
        super().__init__()
        self.embed = frozen_parameter(embed)
        self.final_norm = frozen_parameter(final_norm)
        self.register_parameter("head", frozen_parameter(head))
        self.blocks = nn.ModuleList(blocks)
        self.n_slots = n_slots


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> LM:
    """Random parameters with the reference's shapes and distributions:
    N(0, 0.02^2) embeddings, N(0, 1/d_in) projections, router, experts and
    head, N(0, 1/K) conv taps, zero biases, unit norm scales and Mamba's
    ``A_log`` / ``D`` / ``dt_bias`` as the reference sets them; layer
    ``r * P + i`` takes pattern slot ``i``'s kind. Drawn from ``gen`` on
    its device, then placed on ``device`` (default ``cuda``; ``"meta"``
    draws nothing and gives shapes and dtypes only). The
    parameters require no grad until a trainer asks
    (``model.requires_grad_(True)``)."""
    dev = resolve_device(device, meta=True)

    def normal(shape, std: float) -> torch.Tensor:
        if dev.type == "meta":  # shapes only: nothing drawn, nothing allocated
            return torch.empty(shape, dtype=torch.float32, device=dev)
        x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        return (x * std).to(dev)

    def ones(n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=torch.float32, device=dev)

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def proj(d_in: int, d_out: int, bias: bool = False) -> BitLinear:
        b = torch.zeros((d_out,), dtype=torch.float32, device=dev) if bias else None
        return BitLinear(normal((d_in, d_out), 1.0 / math.sqrt(d_in)), b)

    d, hd, vp = cfg.d_model, cfg.hd, cfg.padded_vocab
    embed = normal((vp, d), 0.02)
    head = None if cfg.tie_embeddings else normal((d, vp), 1.0 / math.sqrt(d))

    def mamba() -> ssm_lib.Mamba:
        di, gn, h, k = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
        f32 = dict(dtype=torch.float32, device=dev)
        return ssm_lib.Mamba(
            z_proj=normal((d, di), 1.0 / math.sqrt(d)),
            x_proj=normal((d, di), 1.0 / math.sqrt(d)),
            b_proj=normal((d, gn), 1.0 / math.sqrt(d)),
            c_proj=normal((d, gn), 1.0 / math.sqrt(d)),
            dt_proj=normal((d, h), 1.0 / math.sqrt(d)),
            conv_x=normal((k, di), 1.0 / math.sqrt(k)),
            conv_b=normal((k, gn), 1.0 / math.sqrt(k)),
            conv_c=normal((k, gn), 1.0 / math.sqrt(k)),
            conv_bias_x=zeros(di), conv_bias_b=zeros(gn), conv_bias_c=zeros(gn),
            A_log=torch.log(torch.linspace(1.0, 16.0, h, **f32)),
            D=ones(h),
            dt_bias=torch.log(torch.expm1(torch.full((h,), 1e-2, **f32))),  # softplus^-1
            norm=ones(di),
            out_proj=normal((di, d), 1.0 / math.sqrt(di)),
        )

    def moe() -> moe_lib.MoE:
        e, f, fs = cfg.moe_experts, cfg.d_ff, cfg.moe_shared_ff
        shared = {}
        if fs:
            shared = dict(ws1=normal((d, fs), 1.0 / math.sqrt(d)),
                          ws3=normal((d, fs), 1.0 / math.sqrt(d)),
                          ws2=normal((fs, d), 1.0 / math.sqrt(fs)))
        return moe_lib.MoE(normal((d, e), 1.0 / math.sqrt(d)),
                           normal((e, d, f), 1.0 / math.sqrt(d)),
                           normal((e, d, f), 1.0 / math.sqrt(d)),
                           normal((e, f, d), 1.0 / math.sqrt(f)), **shared)

    blocks = []
    for layer in range(cfg.n_layers):
        kind = cfg.pattern[layer % len(cfg.pattern)]
        if kind.mixer == "attn":
            mixer = Attention(
                proj(d, cfg.n_heads * hd, cfg.qkv_bias),
                proj(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                proj(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                proj(cfg.n_heads * hd, d),
            )
        else:
            mixer = mamba()
        if kind.moe:
            blocks.append(Block(ones(d), mixer, ones(d), moe()))
        elif cfg.d_ff > 0:  # mamba2-style stacks set d_ff = 0: mixer-only blocks
            f = FFN(proj(d, cfg.d_ff), proj(d, cfg.d_ff), proj(cfg.d_ff, d))
            blocks.append(Block(ones(d), mixer, ones(d), f))
        else:
            blocks.append(Block(ones(d), mixer))
    return LM(embed, ones(d), head, blocks, n_slots=len(cfg.pattern))


# ---------------------------------------------------------------------------
# The reference's stacked parameter tree
# ---------------------------------------------------------------------------


def _proj_leaves(p: BitLinear) -> dict:
    if p.w is None:
        raise ValueError(
            "a programmed projection holds no latent weights: take the tree of "
            "the un-programmed model"
        )
    return {"w": p.w} if p.b is None else {"w": p.w, "b": p.b}


def _block_leaves(blk: Block) -> dict:
    """One block's parameters in the reference's slot layout."""
    out = {"norm1": blk.norm1}
    if isinstance(blk.mixer, Attention):
        out["attn"] = {n: _proj_leaves(getattr(blk.mixer, n)) for n in BINARIZED_PROJECTIONS["attn"]}
    else:
        out["mamba"] = blk.mixer.leaves()
    if isinstance(blk.ffn, moe_lib.MoE):
        out["norm2"] = blk.norm2
        out["moe"] = blk.ffn.leaves()
    elif blk.ffn is not None:
        out["norm2"] = blk.norm2
        out["ffn"] = {n: _proj_leaves(getattr(blk.ffn, n)) for n in BINARIZED_PROJECTIONS["ffn"]}
    return out


def _top_leaves(model: LM) -> dict:
    out = {"embed": model.embed, "final_norm": model.final_norm}
    if model.head is not None:
        out["head"] = model.head
    return out


def _slots(model: LM) -> list[list[Block]]:
    """Slot ``i``'s blocks, repeat by repeat."""
    return [list(model.blocks)[i :: model.n_slots] for i in range(model.n_slots)]


def _stacked(model: LM, top, per_block) -> dict:
    """The reference's tree with ``top(t)`` at each top-level leaf and
    ``torch.stack([per_block(t) for each repeat])`` at each block leaf."""
    tree = tree_lib.tree_map(top, _top_leaves(model))
    tree["blocks"] = {}
    for i, blocks in enumerate(_slots(model)):
        per = [_block_leaves(b) for b in blocks]
        tree["blocks"][f"slot{i}"] = tree_lib.map_with_path(
            lambda path, _: torch.stack([per_block(tree_lib.get(t, path)) for t in per]), per[0]
        )
    return tree


def param_tree(model: LM, device=None) -> dict:
    """The parameters as the reference's tree: ``embed``, ``final_norm``,
    ``head`` (untied models), ``blocks/slot<i>/{norm1, attn/<q|k|v|o>/
    {w, b} or mamba/{<z|x|b|c|dt|out>_proj/w, conv_*, A_log, D, dt_bias,
    norm}, norm2, ffn/<w1|w3|w2>/w or moe/{router, w1, w3, w2}}`` stacked
    over repeats ((R, m, n) per projection, (R, E, d, f) per expert
    stack, (R, d) per norm). Fresh detached tensors on ``device``
    (default: the model's; ``"meta"`` gives shapes and dtypes only): the
    optimizer updates them in place, :func:`load_param_tree_` writes them
    back."""
    return _stacked(
        model,
        lambda t: t.detach().to(device or t.device, copy=True),
        lambda t: t.detach().to(device or t.device),
    )


def take_grad_tree(model: LM) -> dict:
    """The gradients as :func:`param_tree` lays out the parameters (zeros
    where a parameter got none, as ``jax.grad`` gives), clearing every
    ``.grad``: stacking one name at a time frees its per-block gradients
    as it goes."""

    def grad(p: torch.Tensor) -> torch.Tensor:
        g = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
        return g

    return _stacked(model, grad, grad)


@torch.no_grad()
def update_stacked_(prefix: tuple[str, ...], per: list[dict], update) -> None:
    """``update(prefix + path, stacked)`` for each leaf of the per-layer
    trees ``per``, their tensors stacked over layers, each written back
    after its update: one leaf's stack exists at a time (a view for a
    single layer)."""
    for path, _ in tree_lib.leaves_with_paths(per[0]):
        parts = [tree_lib.get(t, path) for t in per]
        stacked = parts[0].unsqueeze(0) if len(parts) == 1 else torch.stack(parts)
        update(prefix + path, stacked)
        if len(parts) > 1:
            for r, t in enumerate(parts):
                t.copy_(stacked[r])


@torch.no_grad()
def update_params_(model: LM, update) -> LM:
    """Apply ``update(path, p)`` (``optim.adamw_begin``'s) to every leaf
    of :func:`param_tree`'s layout, in place: a top-level leaf is the
    model's own tensor, a block leaf is updated as a stack and written
    back. The same values as updating ``param_tree(model)`` and loading
    it back, without a copy of every parameter."""
    for name, t in _top_leaves(model).items():
        update((name,), t)
    for i, blocks in enumerate(_slots(model)):
        update_stacked_(("blocks", f"slot{i}"), [_block_leaves(b) for b in blocks], update)
    return model


@torch.no_grad()
def load_param_tree_(model: LM, tree: dict) -> LM:
    """Copy a :func:`param_tree`-shaped tree into the model's parameters,
    in place (any device or float dtype; checkpoints restore through it)."""
    for name, t in _top_leaves(model).items():
        t.copy_(tree[name])
    for i, blocks in enumerate(_slots(model)):
        stacked = tree["blocks"][f"slot{i}"]
        for r, blk in enumerate(blocks):
            tree_lib.map_with_path(
                lambda path, t: t.copy_(tree_lib.get(stacked, path)[r]), _block_leaves(blk)
            )
    return model


# ---------------------------------------------------------------------------
# Forward (train): per-block remat, sequence-chunked loss
# ---------------------------------------------------------------------------


def embed_tokens(model: LM, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The token embeddings (fp32), times ``cfg.embedding_multiplier``
    where it is not 1."""
    e = embed_rows(model.embed, tokens)
    return e if cfg.embedding_multiplier == 1.0 else e * cfg.embedding_multiplier


def _residual(h: torch.Tensor, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``h + y``: the residual add of a sublayer's output ``y``, times
    ``cfg.residual_multiplier`` first where it is not 1."""
    return h + (y if cfg.residual_multiplier == 1.0 else y * cfg.residual_multiplier)


def _apply_block(carry, blk: Block, positions: torch.Tensor, cfg: ModelConfig):
    h, aux = carry
    h = hinted(h, "dp", None, None)  # re-pin the batch sharding in the remat replay
    mix, _ = _mix(blk, rms_norm(h, blk.norm1, cfg.norm_eps), positions, cfg, None)
    h, a = _ffn_residual(blk, _residual(h, mix, cfg), cfg, None)
    return hinted(h, "dp", None, None), aux if a is None else aux + a


def backbone(model: LM, embeds: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """(B, S, d) -> (hidden (B, S, d), the MoE layers' summed aux loss,
    an fp32 scalar). ``cfg.remat`` checkpoints each block, saving only
    its bf16 input (:func:`~repro_torch.models.scan.remat_scan`); either
    way the loss and gradients are the same bit for bit."""
    h = hinted(embeds.to(ACT_DTYPE), "dp", None, None)
    carry = (h, torch.zeros((), dtype=torch.float32, device=h.device))

    def body(carry, blk):
        return _apply_block(carry, blk, positions, cfg)

    if cfg.remat:
        carry = remat_scan(body, carry, model.blocks)
    else:
        for blk in model.blocks:
            carry = body(carry, blk)
    h, aux = carry
    return rms_norm(h, model.final_norm, cfg.norm_eps), aux


def _loss_chunk(hc: torch.Tensor, tc: torch.Tensor, w: torch.Tensor, cfg: ModelConfig):
    hc = hinted(hc, "dp_strict", None, None)
    logits = _logit_scaled(torch.matmul(hc.to(torch.float32), gathered(w, "dp_strict")), cfg)
    logits = hinted(_mask_padded_vocab(logits, cfg), "dp_strict", None, "model_strict")
    lse = torch.logsumexp(logits, dim=-1)
    # the gathered target logit keeps its dim until the difference (a
    # vocab-sharded DTensor's masked gather reduces there)
    ll = torch.take_along_dim(logits, tc.clamp_min(0)[..., None], dim=-1)
    mask = (tc >= 0).to(torch.float32)
    return mask.sum(), ((lse[..., None] - ll)[..., 0] * mask).sum()


def lm_loss(model: LM, hidden: torch.Tensor, targets: torch.Tensor, cfg: ModelConfig):
    """Sequence-chunked fp32 softmax cross-entropy over ``cfg.loss_chunk``
    positions at a time, each chunk checkpointed (the backward recomputes
    its (B, chunk, V) logits instead of keeping them); the padded vocab
    is masked and ``targets < 0`` are left out of the mean."""
    w = _head_weights(model, cfg)
    s = hidden.shape[1]
    ck = min(cfg.loss_chunk, s)
    pad = (-s) % ck
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    n_tok = torch.zeros((), dtype=torch.float32, device=hidden.device)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, hidden.shape[1], ck):
        n, t = checkpoint(_loss_chunk, hidden[:, c : c + ck], targets[:, c : c + ck], w, cfg,
                          use_reentrant=False, preserve_rng_state=False, **rows.checkpoint_kw())
        n_tok = n_tok + n
        total = total + t
    return total / torch.clamp_min(n_tok, 1.0)


def loss_fn(model: LM, batch: dict, cfg: ModelConfig, aux_coef: float = 0.01) -> torch.Tensor:
    """Next-token loss over a ``{"tokens": (B, S)}`` batch, plus
    ``aux_coef`` times the MoE layers' summed load-balance loss. An
    ``extra_embeds`` (B, L, d) entry (a VLM's patch embeddings) is
    prepended to the token embeddings, positions run over all ``L + S``
    rows, and the loss reads only the token rows."""
    tokens = batch["tokens"].to(device=model.embed.device, dtype=torch.int64)
    embeds = embed_tokens(model, tokens, cfg)
    if "extra_embeds" in batch:
        extra = batch["extra_embeds"].to(device=embeds.device, dtype=embeds.dtype)
        embeds = torch.cat([extra, embeds], dim=1)
    positions = torch.arange(embeds.shape[1], device=embeds.device)
    hidden, aux = backbone(model, embeds, positions, cfg)
    hidden = hidden[:, embeds.shape[1] - tokens.shape[1]:]
    targets = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
    return lm_loss(model, hidden, targets, cfg) + aux_coef * aux


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


def _rebuild(model: LM, attn_fn, ffn_fn, mamba_fn=None, moe_fn=None) -> LM:
    """A new ``LM`` whose blocks hold ``attn_fn(attn)`` and ``ffn_fn(ffn)``
    in place of their attention and dense FFN, and ``mamba_fn(mixer)`` /
    ``moe_fn(ffn)`` in place of their Mamba mixers and MoE FFNs where
    given (else those are shared); norms and the embedding are shared."""
    blocks = []
    for blk in model.blocks:
        mixer, f = blk.mixer, blk.ffn
        if isinstance(mixer, Attention):
            mixer = attn_fn(mixer)
        elif mamba_fn is not None:
            mixer = mamba_fn(mixer)
        if isinstance(f, FFN):
            f = ffn_fn(f)
        elif isinstance(f, moe_lib.MoE) and moe_fn is not None:
            f = moe_fn(f)
        blocks.append(Block(blk.norm1, mixer, blk.norm2, f))
    return LM(model.embed, model.final_norm, model.head, blocks, model.n_slots)


def _binarized_parts(blk: Block):
    """``(part, module)`` for the block's children whose projections are
    BitLinears: ``("attn", Attention)`` and ``("ffn", FFN)``."""
    if isinstance(blk.mixer, Attention):
        yield "attn", blk.mixer
    if isinstance(blk.ffn, FFN):
        yield "ffn", blk.ffn


def program_weights(model: LM, cfg: ModelConfig, engine) -> tuple[LM, int]:
    """Program every binarized projection into ``engine``'s resident
    form once, before serving: each attn q/k/v/o and dense-FFN w1/w3/w2
    ``BitLinear`` is replaced by one holding the prepared artifact and
    its ``alpha`` (the latent weight is dropped, as the hardware holds
    only cell states), plus the fused [q|k|v] artifact for fused
    engines. Mamba projections and MoE experts are plain bf16 matmuls in
    the reference and stay so, but of weights made resident here: each
    Mamba mixer and MoE FFN is replaced by one over the same fp32 leaves
    that also holds their bf16 copies (its six projections; the routed
    and shared expert stacks, the router kept fp32), cast once here where
    the products would cast them on every call (:func:`resident_bytes`).
    Returns ``(programmed_model, n_programmed)``; the input model is not
    mutated (unchanged tensors are shared). No-op unless ``cfg.quant ==
    "bnn"`` and an engine is bound."""
    if cfg.quant != "bnn" or engine is None:
        return model, 0
    base = getattr(engine, "base", engine)  # unwrap a GroupedEngine
    if not hasattr(base, "prepare"):
        return model, 0
    fused = getattr(base, "supports_fused_dense", False)

    def attn(a: Attention) -> Attention:
        return Attention(
            *(_program(getattr(a, name), base) for name in BINARIZED_PROJECTIONS["attn"]),
            qkv=_fused_qkv_artifact(a, base) if fused else None,
        )

    def dense_ffn(f: FFN) -> FFN:
        return FFN(*(_program(getattr(f, name), base) for name in BINARIZED_PROJECTIONS["ffn"]))

    def mamba(m: ssm_lib.Mamba) -> ssm_lib.Mamba:
        leaves = {n: getattr(m, n) for n in m.PROJECTIONS + m.VECTORS}
        return ssm_lib.Mamba(resident=True, **leaves)

    def moe(f: moe_lib.MoE) -> moe_lib.MoE:
        return moe_lib.MoE(*(getattr(f, n) for n in f.LEAVES + f.SHARED), resident=True)

    n = sum(len(BINARIZED_PROJECTIONS[part]) for blk in model.blocks
            for part, _ in _binarized_parts(blk))
    return _rebuild(model, attn, dense_ffn, mamba, moe), n


def resident_bytes(model: LM) -> int:
    """Bytes of the bf16 copies :func:`program_weights` made resident
    (0 for a model it did not program)."""
    return sum(t.numel() * t.element_size() for name, t in model.named_buffers()
               if name.endswith(RESIDENT))


def programmed_projections(model: LM):
    """``(name, BitLinear)`` for every programmed projection, block by
    block: attn q/k/v/o, the fused [q|k|v] when present, FFN w1/w3/w2
    (``name`` is ``"<layer>.<part>.<proj>"``)."""
    names = {"attn": (*BINARIZED_PROJECTIONS["attn"], "qkv"), "ffn": BINARIZED_PROJECTIONS["ffn"]}
    for layer, blk in enumerate(model.blocks):
        for part, module in _binarized_parts(blk):
            for name in names[part]:
                p = getattr(module, name)
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

    return _rebuild(
        model,
        lambda a: Attention(*(one(getattr(a, n)) for n in BINARIZED_PROJECTIONS["attn"]),
                            qkv=one(a.qkv)),
        lambda f: FFN(*(one(getattr(f, n)) for n in BINARIZED_PROJECTIONS["ffn"])),
    )


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


def _logit_scaled(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The head's product divided by ``cfg.logits_scaling`` where it is
    not 1."""
    return logits if cfg.logits_scaling == 1.0 else logits / cfg.logits_scaling


def _logits(model: LM, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Last-position fp32 logits, inside the ``lm.head`` profiler range.
    The head runs in 16-row blocks (``rows.matmul``) in a prefill and a
    decode step alike, so a row's logits do not depend on how many
    sequences share the call."""
    with obs.range("lm.head"):
        h = rms_norm(h, model.final_norm, cfg.norm_eps)
        logits = rows.matmul(h[:, -1, :].to(torch.float32), _head_weights(model, cfg))
        return _mask_padded_vocab(_logit_scaled(logits, cfg), cfg)


def _mix(blk: Block, hn: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, eng):
    """The block's mixer over whole sequences of normed input: its output
    and its decode cache (``{"k", "v"}`` bf16 rows for attention, the
    Mamba decode cache of :func:`~repro_torch.models.ssm.mamba_block`)."""
    if isinstance(blk.mixer, Attention):
        mix, (k, v) = attention_block(blk.mixer, hn, positions, cfg, quant=cfg.quant, engine=eng)
        return mix, {"k": k.to(ACT_DTYPE), "v": v.to(ACT_DTYPE)}
    return ssm_lib.mamba_block(blk.mixer, hn, cfg)


def _mix_step(blk: Block, hn: torch.Tensor, pos, cache: dict, cfg: ModelConfig, eng):
    """One decode step of the block's mixer over (B, 1, d), writing
    ``cache`` (one repeat's entries) in place; returns its output."""
    if isinstance(blk.mixer, Attention):
        return attention_decode_step(blk.mixer, hn, pos, cache["k"], cache["v"], cfg,
                                     quant=cfg.quant, engine=eng)[0]
    return ssm_lib.mamba_step(blk.mixer, hn, cache, cfg)[0]


def _ffn_residual(blk: Block, h: torch.Tensor, cfg: ModelConfig, eng):
    """``(h + the block's FFN of its normed input, the MoE aux or None)``;
    ``(h, None)`` for a mixer-only block. Serving drops the aux, as the
    reference does. On a mesh each residual sum is pinned to the batch
    axes, replicated over the model axis: DTensor would otherwise carry
    the TP products' partial sums on into the next products, which then
    run unsharded (the reference's XLA reduces at the add)."""
    h = hinted(h, "dp", None, None)
    if blk.ffn is None:
        return h, None
    hn = rms_norm(h, blk.norm2, cfg.norm_eps)
    if isinstance(blk.ffn, moe_lib.MoE):
        y, aux = _moe(blk.ffn, hn, cfg)
        return hinted(_residual(h, y, cfg), "dp", None, None), aux
    return hinted(_residual(h, ffn(blk.ffn, hn, cfg.quant, eng), cfg), "dp", None, None), None


def _moe(p: moe_lib.MoE, hn: torch.Tensor, cfg: ModelConfig):
    """MoE with selectable dispatch (``cfg.moe_impl``), as the reference's
    ``lm._moe``: with ``"ep_shard_map"`` under ``activation_hints(mesh)``
    whose ``model`` axis divides the experts, the expert-parallel
    dispatch (``hn`` is this rank's rows, ``p`` its experts); otherwise
    ``moe_ffn``. The reference also asks that the global rows divide by
    the axis: each rank holding an equal share of them, as the port's
    ranks do, is that condition."""
    if cfg.moe_impl == "ep_shard_map":
        from repro_torch.distributed.ep import ep_moe_ffn
        from repro_torch.distributed.hints import current_mesh
        from repro_torch.distributed.partitioner import mesh_shape

        mesh = current_mesh()
        if mesh is not None:
            sizes = mesh_shape(mesh).shape
            if "model" in sizes and cfg.moe_experts % sizes["model"] == 0:
                return ep_moe_ffn(p, hn, cfg, mesh)
    return moe_lib.moe_ffn(p, hn, cfg)


def run_blocks(blocks, h: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, engine=None):
    """The prefill's layer loop over ``blocks`` (a slice of ``model.blocks``)
    without caches: hidden (B, S, d) in, hidden out (no final norm) -- a
    pipeline stage's forward (``distributed.pipeline.gpipe``)."""
    eng = engine if engine is not None else infer_engine(cfg)
    for blk in blocks:
        mix, _ = _mix(blk, rms_norm(h, blk.norm1, cfg.norm_eps), positions, cfg, eng)
        h, _ = _ffn_residual(blk, _residual(h, mix, cfg), cfg, eng)
    return h


def _stack_caches(per_slot: list[dict[str, list[torch.Tensor]]]) -> dict:
    """Per-slot lists of per-repeat cache tensors -> the stacked tree."""
    return {f"slot{i}": {key: torch.stack(ts) for key, ts in kv.items()}
            for i, kv in enumerate(per_slot)}


def prefill(model: LM, tokens: torch.Tensor, cfg: ModelConfig,
            extra_embeds: torch.Tensor | None = None, engine=None):
    """Forward over (B, S) prompt tokens. Returns last-position logits
    (B, V) fp32 and the prompt caches: ``{"k"/"v": (R, B, S, KV, D)}``
    bf16 per attention slot, the Mamba decode cache (``ssm.mamba_block``)
    per Mamba slot. ``extra_embeds`` (B, L, d) prepends modality-frontend
    embeddings (a VLM's patches): the sequence is ``[extra_embeds,
    embed(tokens)]`` at positions ``0 .. L + S - 1``, and the caches
    cover all of it. ``engine`` overrides ``cfg.bnn_engine`` for the
    binarized projections (serving passes its K-group
    ``GroupedEngine``). With ``cfg.prefill_per_sequence`` the layers run
    inside ``rows.sequence_products``."""
    tokens = tokens.to(device=model.embed.device, dtype=torch.int64)
    embeds = embed_tokens(model, tokens, cfg)
    if extra_embeds is not None:
        extra = extra_embeds.to(device=embeds.device, dtype=embeds.dtype)
        embeds = torch.cat([extra, embeds], dim=1)
    h = embeds.to(ACT_DTYPE)
    positions = torch.arange(h.shape[1], device=h.device)
    eng = engine if engine is not None else infer_engine(cfg)
    n_slots = len(cfg.pattern)
    per_slot: list[dict[str, list[torch.Tensor]]] = [{} for _ in range(n_slots)]
    with rows.sequence_products(cfg.prefill_per_sequence):
        for layer, blk in enumerate(model.blocks):
            mix, cache = _mix(blk, rms_norm(h, blk.norm1, cfg.norm_eps), positions, cfg, eng)
            for key, t in cache.items():
                per_slot[layer % n_slots].setdefault(key, []).append(t)
            h, _ = _ffn_residual(blk, _residual(h, mix, cfg), cfg, eng)
    return _logits(model, h, cfg), _stack_caches(per_slot)


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
    :class:`PrefixContinuationError`. Token prompts only, as in the
    reference: there is no ``extra_embeds`` (a VLM prompt's frontend
    embeddings have positions a token-hash prefix cannot name).
    """
    bad = [f"slot{i}" for i, kind in enumerate(cfg.pattern) if kind.mixer != "attn"]
    if bad:
        raise PrefixContinuationError(
            f"prefix continuation needs per-position KV rows; {cfg.name} has "
            f"non-attention mixer(s) at {', '.join(bad)} whose recurrent state "
            "cannot be sliced at a prefix boundary"
        )
    tokens = tokens.to(device=model.embed.device, dtype=torch.int64)
    start = next(iter(prefix_caches.values()))["k"].shape[2]
    h = embed_tokens(model, tokens, cfg).to(ACT_DTYPE)
    positions = torch.arange(start, start + tokens.shape[1], device=h.device)
    eng = engine if engine is not None else infer_engine(cfg)
    n_slots = len(cfg.pattern)
    per_slot: list[dict[str, list[torch.Tensor]]] = [{"k": [], "v": []} for _ in range(n_slots)]
    for layer, blk in enumerate(model.blocks):
        pre = prefix_caches[f"slot{layer % n_slots}"]
        r = layer // n_slots
        pk, pv = pre["k"][r], pre["v"][r]
        hn = rms_norm(h, blk.norm1, cfg.norm_eps)
        mix, (k, v) = attention_continue(
            blk.mixer, hn, positions, pk, pv, cfg, quant=cfg.quant, engine=eng
        )
        per_slot[layer % n_slots]["k"].append(torch.cat([pk, k.to(ACT_DTYPE)], dim=1))
        per_slot[layer % n_slots]["v"].append(torch.cat([pv, v.to(ACT_DTYPE)], dim=1))
        h, _ = _ffn_residual(blk, _residual(h, mix, cfg), cfg, eng)
    return _logits(model, h, cfg), _stack_caches(per_slot)


# the cache entries of an attention slot: rows indexed by position
KV_KEYS = ("k", "v")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=ACT_DTYPE, *, device) -> dict:
    """Zero decode caches (stacked over repeats) on ``device``: K/V rows
    in ``dtype`` per attention slot; per Mamba slot the conv tails in
    ``dtype`` and the SSD state in fp32."""
    r = cfg.n_repeats

    def zeros(*shape, dt=dtype):
        return torch.zeros((r, batch, *shape), dtype=dt, device=device)

    caches = {}
    for i, kind in enumerate(cfg.pattern):
        if kind.mixer == "attn":
            caches[f"slot{i}"] = {key: zeros(max_len, cfg.n_kv_heads, cfg.hd) for key in KV_KEYS}
        else:
            tail, gn = cfg.ssm_conv - 1, cfg.ssm_groups * cfg.ssm_state
            caches[f"slot{i}"] = {
                "conv_x": zeros(tail, cfg.d_inner),
                "conv_b": zeros(tail, gn),
                "conv_c": zeros(tail, gn),
                "ssm": zeros(cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, dt=torch.float32),
            }
    return caches


def graft_cache_(dst: torch.Tensor, src: torch.Tensor, key: str) -> None:
    """Write prompt caches ``src`` into serving caches ``dst`` (same
    leading (R, B) dims), in place, by the reference's rule: attention
    K/V rows (R, B, T, KV, D) fill the time prefix; Mamba conv tails and
    states carry over whole."""
    if key in KV_KEYS:
        dst[:, :, : src.shape[2]] = src.to(dst.dtype)
    else:
        dst.copy_(src)


def decode_step(model: LM, token: torch.Tensor, pos, caches: dict, cfg: ModelConfig, engine=None):
    """One serving step: token (B,), pos a scalar or (B,) per-slot
    positions, caches from ``init_cache``/``prefill``. Writes the new K/V
    rows, conv tails and SSD states into ``caches`` IN PLACE (the
    reference donates its caches to the same effect) and returns (logits
    (B, V), caches)."""
    token = token.to(device=model.embed.device, dtype=torch.int64)
    h = embed_tokens(model, token[:, None], cfg).to(ACT_DTYPE)  # (B, 1, d)
    eng = engine if engine is not None else infer_engine(cfg)
    n_slots = len(cfg.pattern)
    for layer, blk in enumerate(model.blocks):
        c = caches[f"slot{layer % n_slots}"]
        r = layer // n_slots
        hn = rms_norm(h, blk.norm1, cfg.norm_eps)
        mix = _mix_step(blk, hn, pos, {key: t[r] for key, t in c.items()}, cfg, eng)
        h, _ = _ffn_residual(blk, _residual(h, mix, cfg), cfg, eng)
    return _logits(model, h, cfg), caches

"""Mixture-of-Experts FFN: top-k routing with capacity-bounded scatter
dispatch, Switch/GShard style (counterpart of ``repro/models/moe.py``).

The routing is the reference's: an fp32 router, softmax over all
experts, the top-k renormalized with a ``1e-9`` floor, each (token,
expert) assignment's slot inside its expert counted along the row, and
assignments at or past the capacity dropped (they contribute zero).
Kept assignments scatter into a dense (B, E, C, d) bf16 buffer; every
expert runs its SwiGLU over its whole (C, d) buffer, zeros included, in
bf16 with the SiLU in fp32; the gated results combine back per token.
A layer with a shared expert (Granite-4.0-H's) adds its SwiGLU of every
token to the routed combine, computed the same way. The expert stacks
are fp32 leaves; their products read the bf16 copies that
``lm.program_weights`` makes once for serving (``MoE(...,
resident=True)``), or cast them per call where a module holds none (an
unprogrammed model, or one in training): the same bits either way
(``layers.product_weights``).

Per-row arithmetic does not depend on how many rows share a call, which
batched == solo serving needs on the card: the router, the expert and
the shared expert products and the softmax sums take their rows as
``kernels/rows.py`` decides, and the sums over k are unrolled. Top-k is
a stable descending sort, so ties keep the lower expert index first, as
``jax.lax.top_k`` does. Kept (expert, slot) pairs never collide, so the
scatter is a plain index write.

The expert-parallel dispatch (``distributed/ep.py``) runs instead under
a mesh with ``moe_impl="ep_shard_map"`` (``lm``'s MoE residual), as in
the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.kernels import rows
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ACT_DTYPE,
    frozen_parameter,
    product_weights,
    register_resident_,
)


class MoE(nn.Module):
    """The router (d, E) and the expert stacks ``w1`` / ``w3`` (E, d, f)
    and ``w2`` (E, f, d), fp32; optionally a shared expert, ``ws1`` /
    ``ws3`` (d, fs) and ``ws2`` (fs, d), fp32 and real-valued like the
    routed ones (``None`` without one). With ``resident`` each expert
    stack also has its bf16 copy, ``<name>_resident``
    (``layers.register_resident_``); the router stays fp32, as its
    product is."""

    LEAVES = ("router", "w1", "w3", "w2")
    SHARED = ("ws1", "ws3", "ws2")
    ROUTED = ("w1", "w3", "w2")

    def __init__(self, router: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                 w2: torch.Tensor, ws1: torch.Tensor | None = None,
                 ws3: torch.Tensor | None = None, ws2: torch.Tensor | None = None, *,
                 resident: bool = False):
        super().__init__()
        if len({t is None for t in (ws1, ws3, ws2)}) > 1:
            raise ValueError("a shared expert takes all of ws1, ws3 and ws2")
        self.router = frozen_parameter(router)
        self.w1 = frozen_parameter(w1)
        self.w3 = frozen_parameter(w3)
        self.w2 = frozen_parameter(w2)
        for name, t in zip(self.SHARED, (ws1, ws3, ws2)):
            self.register_parameter(name, frozen_parameter(t))
        register_resident_(self, self.ROUTED + self.SHARED, resident)

    @property
    def has_shared(self) -> bool:
        return self.ws1 is not None

    def leaves(self) -> dict:
        """The parameters in the reference's ``moe`` layout, the shared
        expert's after the routed ones where there is one."""
        names = self.LEAVES + (self.SHARED if self.has_shared else ())
        return {n: getattr(self, n) for n in names}


def capacity(cfg: ModelConfig, seq: int) -> int:
    return max(1, math.ceil(seq * cfg.moe_top_k / cfg.moe_experts * cfg.moe_capacity_factor))


def _sum_k(t: torch.Tensor) -> torch.Tensor:
    """Sum over dim 2 in a fixed order, one elementwise add per term."""
    out = t[:, :, 0]
    for i in range(1, t.shape[2]):
        out = out + t[:, :, i]
    return out


def route(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """(B, S, d) -> (probs (B, S, E) fp32, gates (B, S, k) fp32, top_idx
    (B, S, k) int64)."""
    return route_logits(rows.seq_matmul(x.to(torch.float32), p.router), cfg.moe_top_k)


def route_logits(logits: torch.Tensor, k: int):
    """:func:`route` from the router's fp32 logits (B, S, E)."""
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = ex / rows.row_sum(ex)
    gates, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, top_idx = gates[..., :k], top_idx[..., :k]
    total = _sum_k(gates.unsqueeze(-1))  # (B, S, 1)
    return probs, gates / torch.clamp_min(total, 1e-9), top_idx


def slots(top_idx: torch.Tensor, n_experts: int, cap: int):
    """Each assignment's expert (B, S*k), its slot inside the expert, the
    count of earlier assignments of the row to it, and ``keep = slot <
    cap``; plus the one-hot (B, S*k, E) the aux loss counts."""
    b = top_idx.shape[0]
    flat_e = top_idx.reshape(b, -1)
    onehot = F.one_hot(flat_e, n_experts)
    pos = onehot.cumsum(dim=1) - 1
    slot = pos.gather(2, flat_e.unsqueeze(-1)).squeeze(-1)
    return flat_e, slot, slot < cap, onehot


def experts(p: MoE, expert_in: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its (B, C) buffer rows: (B, E, C, d)
    bf16 -> (B, E, C, d) bf16, the (E, B C, d) rows in 16-row blocks, or
    each sequence's (E, C, d) buffer as one batched product
    (``rows.by_sequence``)."""
    ws = product_weights(p, MoE.ROUTED, expert_in.dtype, "moe.experts")
    return rows.by_sequence(lambda xe, *ws: _swiglu(xe, *ws, torch.matmul), (expert_in,), ws,
                            blocked=_blocked_experts)


def _blocked_experts(expert_in: torch.Tensor, *ws: torch.Tensor) -> torch.Tensor:
    b, e, c, d = expert_in.shape
    xe = expert_in.transpose(0, 1).reshape(e, b * c, d)
    out = _swiglu(xe, *ws, rows.matmul)
    return out.reshape(e, b, c, -1).transpose(0, 1)


def _swiglu(x, w1, w3, w2, matmul) -> torch.Tensor:
    """``w2(silu(x w1) * x w3)`` in bf16 products of the weights as
    ``layers.product_weights`` gives them (in x's dtype; ``w2`` taken to
    the bf16 of ``h``, a no-op for bf16 x), the SiLU in fp32."""
    h = matmul(x, w1)
    g = matmul(x, w3)
    hf = h.to(torch.float32)
    h = (hf * torch.sigmoid(hf)).to(ACT_DTYPE) * g.to(ACT_DTYPE)  # silu, as x * sigmoid(x)
    return matmul(h, w2.to(h.dtype))


def shared_expert(p: MoE, x: torch.Tensor) -> torch.Tensor:
    """The shared expert's SwiGLU of every row: (B, S, d) bf16 -> (B, S,
    d) bf16 (``rows.seq_matmul``)."""
    return _swiglu(x, *product_weights(p, MoE.SHARED, x.dtype, "moe.shared"), rows.seq_matmul)


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, d) -> (B, S, d) in x's dtype, plus the GShard load-balance
    aux loss ``E * sum_e f_e * P_e`` (fp32 scalar). Its four phases run
    inside the profiler ranges ``moe.route``, ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine`` (the aux loss last, in the
    combine's); a shared expert runs inside ``moe.shared``, before the
    combine, and joins the routed sum there in fp32."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    c = capacity(cfg, s)
    with obs.range("moe.route"):
        probs, gates, top_idx = route(p, x, cfg)
        flat_e, slot, keep, onehot = slots(top_idx, e, c)

    # dispatch: kept assignments write their token into (B, E, C, d);
    # dropped ones go to a spare slot C that is cut off
    with obs.range("moe.dispatch"):
        rows = torch.arange(b, device=x.device)[:, None].expand_as(flat_e)
        x_rep = x.repeat_interleave(k, dim=1)  # (B, S*k, d)
        buf = x.new_zeros((b, e, c + 1, d))
        buf[rows, flat_e, torch.where(keep, slot, c)] = x_rep
    with obs.range("moe.experts"):
        out_e = experts(p, buf[:, :, :c])

    if p.has_shared:
        with obs.range("moe.shared"):
            shared = shared_expert(p, x)

    # combine: a dropped assignment reads the clamped last slot, times 0,
    # as the reference's out-of-range gather does
    with obs.range("moe.combine"):
        got = out_e[rows, flat_e, torch.clamp_max(slot, c - 1)]
        got = got * keep[..., None].to(got.dtype)
        weighted = got.reshape(b, s, k, d) * gates[..., None].to(got.dtype)
        y = _sum_k(weighted.to(torch.float32))
        if p.has_shared:
            y = y + shared.to(torch.float32)

        frac = onehot.reshape(b, s, k, e).sum(dim=2).to(torch.float32).mean(dim=(0, 1))
        aux = e * (frac * probs.mean(dim=(0, 1))).sum()
        return y.to(x.dtype), aux

"""Hand-written expert-parallel MoE dispatch (counterpart of
``repro/distributed/ep.py``), on ``torch.distributed``.

Rank r of the ``model`` axis holds experts ``[r E/R, (r+1) E/R)``
(:func:`shard_experts_`) and its own token rows (the caller's batch
share). Each rank routes its tokens, buckets them by destination rank
(owner(e) = e // E_local) with capacity C = ceil(T_local k / R x
factor) per (src, dst) pair, and one ``all_to_all`` moves the (R, C, d)
payload each way (the expert ids ride with it in a second one): expert
weights never move. The receiving rank runs each local expert's SwiGLU
on exactly the rows it owns; the return trip brings outputs back, gates
combine locally, and the aux load-balance loss is averaged over ranks.
Over-capacity assignments contribute zero. Differentiable end to end:
an ``all_to_all``'s backward is the same exchange of the gradient.
A layer with a shared expert (``cfg.moe_shared_ff``) is refused
(:class:`SharedExpertError`): this dispatch would drop it.

Two departures from the reference's arithmetic layout, none from its
function:

* the reference gathers a weight matrix per received row (``w1[sel]``,
  (R C, d, f): ~64 GB per projection at qwen3-moe's full width); the
  port groups the received rows by local expert and runs one row-blocked
  product per expert (``rows.matmul``), so a row's bits do not
  depend on how many rows share its expert;
* the reference's out-of-range scatters (``mode="drop"``) are an
  explicit ``keep`` mask here; nothing is indexed out of range.

The combine keeps the reference's: gates times the returned rows in x's
dtype, summed over k in x's dtype (``moe.moe_ffn`` sums in fp32), so EP
equals ``moe_ffn`` within a tolerance, at drop-free capacity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (
    all_reduce_sum,
    all_to_all,
    all_to_all0,
    axis_index,
    axis_size,
    group_of,
)
from repro_torch.kernels import rows
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig


def _axis(mesh, axis: str):
    """``(mesh, axis)`` for a ``DeviceMesh``; a process group as is."""
    return (mesh, axis) if hasattr(mesh, "get_group") else mesh


def capacity(t_local: int, cfg: ModelConfig, n_ranks: int) -> int:
    """Per-(src, dst) capacity: tokens x k per rank pair, times the
    capacity factor (the reference's ``ep.py:118``)."""
    return max(1, math.ceil(t_local * cfg.moe_top_k / n_ranks * cfg.moe_capacity_factor))


class SharedExpertError(NotImplementedError):
    """An expert-parallel MoE was asked of a layer with a shared expert,
    which this dispatch does not compute (it would drop it silently)."""


def local_experts(p: moe_lib.MoE, rank: int, n_ranks: int) -> moe_lib.MoE:
    """Rank ``rank``'s share of an expert stack: experts ``[rank E/R,
    (rank+1) E/R)`` of w1 / w3 / w2 (copies, so the full stacks can be
    freed), the router whole."""
    e = p.w1.shape[0]
    if e % n_ranks:
        raise ValueError(f"{e} experts on a {n_ranks}-way axis")
    lo, hi = rank * e // n_ranks, (rank + 1) * e // n_ranks
    return moe_lib.MoE(p.router.data, *(getattr(p, n).data[lo:hi].clone()
                                        for n in ("w1", "w3", "w2")))


def shard_experts_(model, mesh, axis: str = "model"):
    """Every MoE block of ``model`` (an ``lm.LM``) keeps only this rank's
    experts along ``axis``, in place; returns the model."""
    ax = _axis(mesh, axis)
    rank, n = axis_index(ax), axis_size(ax)
    for blk in model.blocks:
        if isinstance(blk.ffn, moe_lib.MoE):
            blk.ffn = local_experts(blk.ffn, rank, n)
    return model


def _local_dispatch(x2d: torch.Tensor, logits: torch.Tensor, n_ranks: int, e_local: int,
                    k: int, cap: int):
    """Bucket local tokens by destination rank.

    x2d (T, d); logits (T, E) fp32. Returns (send (R, C, d), send_eid
    (R, C) in [0, e_local) or -1, send_tok (R, C) source token index or
    -1, gates (T, k), top_idx (T, k), dest (T k,), slot (T k,), keep
    (T k,)): assignment i (token i // k, its (i % k)-th expert) goes to
    rank ``dest[i]`` at bucket slot ``slot[i]``, its running count among
    the assignments to that rank, and is kept when ``slot < cap``."""
    t, d = x2d.shape
    _, gates, top_idx = moe_lib.route_logits(logits[None], k)
    gates, top_idx = gates[0], top_idx[0]
    flat_e = top_idx.reshape(-1)                                   # (T k,)
    dest = torch.div(flat_e, e_local, rounding_mode="floor")
    onehot = F.one_hot(dest, n_ranks)                              # (T k, R)
    slot = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1)  # position within dest
    keep = slot < cap
    tok = torch.arange(t, device=x2d.device).repeat_interleave(k)
    # one flat row per (rank, slot), the dropped assignments all to a spare
    # last row that is cut off: no shape depends on the routing (no host
    # sync), and a step analysis traces this same path
    rows = n_ranks * cap
    at = (torch.where(keep, dest * cap + slot, rows),)
    send = x2d.new_zeros((rows + 1, d)).index_put(at, x2d[tok])[:rows].view(n_ranks, cap, d)
    full = dict(dtype=torch.int64, device=x2d.device)
    send_eid = torch.full((rows + 1,), -1, **full).index_put(at, flat_e % e_local)
    send_tok = torch.full((rows + 1,), -1, **full).index_put(at, tok)
    return (send, send_eid[:rows].view(n_ranks, cap), send_tok[:rows].view(n_ranks, cap),
            gates, top_idx, dest, slot, keep)


def _expert_ffn(recv: torch.Tensor, recv_eid: torch.Tensor, w1: torch.Tensor,
                w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """(N, d) rows with local-expert ids (-1: an empty slot) -> (N, d)
    outputs, zero at the empty slots. The rows are grouped by expert (a
    stable sort: one host read of the counts) and each expert runs its
    SwiGLU -- bf16 products in 16-row blocks, the SiLU in fp32
    -- on its rows only."""
    n, d = recv.shape
    e_local = w1.shape[0]
    key = torch.where(recv_eid >= 0, recv_eid, e_local)
    order = torch.argsort(key, stable=True)
    if rows.ACTIVE is not None:  # a trace holds no values: the rows split evenly
        counts = [n // e_local + (e < n % e_local) for e in range(e_local)]
    else:
        counts = torch.bincount(key, minlength=e_local + 1).tolist()
    grouped = recv[order]
    outs, start = [], 0
    for e in range(e_local):
        c = counts[e]
        if c == 0:
            continue
        xe = grouped[start : start + c]
        h = rows.matmul(xe, w1[e].to(xe.dtype))
        g = rows.matmul(xe, w3[e].to(xe.dtype))
        hf = h.to(torch.float32)
        h = (hf * torch.sigmoid(hf)).to(xe.dtype) * g  # silu, as x * sigmoid(x)
        outs.append(rows.matmul(h, w2[e].to(h.dtype)))
        start += c
    out = recv.new_zeros((n, d))
    if not outs:
        return out
    return out.index_put((order[:start],), torch.cat(outs))


def ep_moe_ffn(p: moe_lib.MoE, x: torch.Tensor, cfg: ModelConfig, mesh,
               axis: str = "model") -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN. ``x`` (B, S, d) is this rank's rows;
    ``p`` holds this rank's experts (E/R of w1 / w3 / w2,
    :func:`shard_experts_`) and the whole router. ``mesh`` is a
    ``DeviceMesh`` with an ``axis`` dim, or a process group. Returns
    (out (B, S, d) in x's dtype, the aux load-balance loss averaged over
    the ranks)."""
    if cfg.moe_shared_ff or p.has_shared:
        raise SharedExpertError(
            f"{cfg.name}: the expert-parallel dispatch has no shared expert; "
            "serve it with moe_impl='pjit' (moe.moe_ffn adds it once per token)")
    ax = _axis(mesh, axis)
    group = group_of(ax)
    n_ranks = axis_size(ax)
    e, k = cfg.moe_experts, cfg.moe_top_k
    if e % n_ranks:
        raise ValueError(f"{e} experts on a {n_ranks}-way axis")
    e_local = e // n_ranks
    if p.w1.shape[0] != e_local:
        raise ValueError(f"rank holds {p.w1.shape[0]} experts, expected {e_local} "
                         "(shard_experts_ first)")
    b, s, d = x.shape
    t = b * s
    cap = capacity(t, cfg, n_ranks)

    x2d = x.reshape(t, d)
    logits = rows.matmul(x2d.to(torch.float32), p.router)
    send, send_eid, _, gates, top_idx, dest, slot, keep = _local_dispatch(
        x2d, logits, n_ranks, e_local, k, cap)
    # buckets travel: (R, C, .) sent -> (R, C, .) received from each rank
    recv = all_to_all(send, group)
    recv_eid = all_to_all0(send_eid, group)
    out_e = _expert_ffn(recv.reshape(n_ranks * cap, d), recv_eid.reshape(-1),
                        p.w1, p.w3, p.w2).reshape(n_ranks, cap, d)
    back = all_to_all(out_e, group)
    # combine: assignment i's result lives at (dest[i], slot[i])
    got = back[dest, slot.clamp_max(cap - 1)] * keep[:, None].to(back.dtype)
    y = (got.reshape(t, k, d) * gates[..., None].to(got.dtype)).sum(dim=1)
    # aux loss from local stats, averaged over the ranks
    f32 = dict(dtype=torch.float32, device=x.device)
    frac = F.one_hot(top_idx.reshape(-1), e).to(torch.float32).mean(dim=0) * e \
        / torch.tensor(float(k), **f32)
    mean_prob = torch.softmax(logits, dim=-1).mean(dim=0)
    aux = (frac * mean_prob).sum() * e / torch.tensor(float(e), **f32)
    aux = all_reduce_sum(aux, group) / torch.tensor(float(n_ranks), **f32)
    return y.reshape(x.shape).to(x.dtype), aux

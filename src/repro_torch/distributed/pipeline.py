"""GPipe pipeline parallelism on ``torch.distributed`` (counterpart of
``repro/distributed/pipeline.py``).

Each rank of the pipeline group is one stage and holds only its own
stage's parameters; microbatches stream through the stages with the
classic GPipe fill/drain bubble, (P-1)/(P-1+M). The schedule is the
reference's tick loop, run by every rank (SPMD): over P-1+M ticks stage
0 ingests microbatch t while t < M, every stage applies ``stage_fn`` to
its buffer, the last stage emits microbatch t-(P-1) once t >= P-1, and
each tick ends with a ring shift (stage s -> s+1; the wrap-around to
stage 0 carries junk, overwritten by the next ingest or never emitted).
The last stage's outputs are shared by a sum all-reduce of the masked
outputs, so every rank returns the full result.

Gradients flow through the shifts (``ppermute_shift``'s backward is the
reverse shift). Every rank must run the same shift backwards in the same
order, so every rank's result depends, through a zero-gradient anchor,
on the last shift's output: then each rank's backward walks its whole
chain of shifts, newest first. The shared result is read as one value
held by every rank (the reference's global view): its backward hands
the last stage its own rank's cotangent and no communication, so a loss
computed the same on every rank gives each stage the sequential
gradient once.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed.collectives import (
    all_reduce_sum,
    axis_index,
    axis_size,
    group_of,
    ppermute_shift,
)


def stage_split(n_layers: int, n_stages: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) layer ranges per stage (balanced)."""
    base, rem = divmod(n_layers, n_stages)
    out, s = [], 0
    for i in range(n_stages):
        e = s + base + (1 if i < rem else 0)
        out.append((s, e))
        s = e
    return out


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead: (P-1) / (P-1+M)."""
    return (n_stages - 1) / (n_stages - 1 + n_microbatches)


class _Share(torch.autograd.Function):
    """The last stage's outputs, summed onto every rank (the others
    contribute zeros); backward: this rank's cotangent to the last stage
    only, no communication (see the module docstring)."""

    @staticmethod
    def forward(ctx, outs, group, is_last):
        ctx.is_last = is_last
        masked = outs if is_last else torch.zeros_like(outs)
        return all_reduce_sum(masked.detach(), group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_last else torch.zeros_like(g)), None, None


class _Anchor(torch.autograd.Function):
    """``y`` unchanged, with a zero-gradient edge to ``dep``."""

    @staticmethod
    def forward(ctx, y, dep):
        ctx.dep_shape, ctx.dep_dtype = dep.shape, dep.dtype
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros(ctx.dep_shape, dtype=ctx.dep_dtype, device=g.device)


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], axis=None, *,
          n_microbatches: int) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """Build a pipelined apply: ``(stage_params, x (M*b, ...)) -> y``.

    ``stage_fn(stage_params, x_mb)`` applies ONE stage to ONE microbatch;
    ``stage_params`` is this rank's stage's (stage = the rank's index
    along ``axis``: a process group, a 1-D ``DeviceMesh`` or a
    ``(DeviceMesh, dim)`` pair). ``x`` is the whole batch, the same on
    every rank, split into ``n_microbatches`` along dim 0; ``stage_fn``
    must keep a microbatch's shape and dtype. Every rank returns ``y``.
    """
    group = group_of(axis)
    n_stages = axis_size(group)
    stage = axis_index(group)
    last = stage == n_stages - 1

    def pipelined(stage_params: Any, x: torch.Tensor) -> torch.Tensor:
        m = n_microbatches
        if x.shape[0] % m:
            raise ValueError(f"batch {x.shape[0]} does not split into {m} microbatches")
        xs = x.reshape(m, x.shape[0] // m, *x.shape[1:])
        buf = torch.zeros_like(xs[0])
        outs: list[torch.Tensor | None] = [None] * m
        for t in range(n_stages - 1 + m):
            if stage == 0 and t < m:  # ingest; the shifted-in junk stays in the graph
                buf = torch.where(torch.ones((), dtype=torch.bool, device=x.device), xs[t], buf)
            y = stage_fn(stage_params, buf)
            if last and t >= n_stages - 1:
                outs[t - (n_stages - 1)] = y
            buf = ppermute_shift(y, group, 1)
        stacked = torch.stack(outs) if last else torch.zeros_like(xs)
        ys = _Anchor.apply(_Share.apply(stacked, group, last), buf)
        return ys.reshape(x.shape[0], *ys.shape[2:])

    return pipelined

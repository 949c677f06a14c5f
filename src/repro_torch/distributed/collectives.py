"""Collective helpers on ``torch.distributed`` (counterpart of
``repro/distributed/collectives.py``).

Each takes the group it runs over as ``axis``: a process group, a 1-D
``DeviceMesh``, a ``(DeviceMesh, dim_name)`` pair, or ``None`` for the
default group. Each returns a new tensor (the input is not touched) and
is differentiable as its JAX counterpart is: the gradient of a sum
all-reduce is a sum all-reduce, of a reduce-scatter an all-gather and
back, of a ring shift the reverse shift. Every rank of the group must
make the same calls in the same order, forward and backward.

Gloo takes CUDA tensors for some collectives only. A CUDA tensor on a
gloo group goes through pinned host memory for every operation not in
:data:`GLOO_CUDA_OPS`, the set ``chip_smoke.py``'s distributed phase
probes on the card (and fails if the set is stale); :func:`transport`
names the route an operation takes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the collectives gloo runs on CUDA tensors directly (the rest are
# staged through pinned host memory): chip_smoke.py's probe on the H100,
# torch 2.11. Send/recv is not among them: gloo's TCP pair writes the
# device pointer itself ("writev ... Bad address") and the pair breaks
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
                           "all_to_all_single"})
OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
       "send_recv")


def group_of(axis):
    """The process group ``axis`` names (see the module docstring)."""
    if axis is None:
        return dist.group.WORLD
    if isinstance(axis, tuple):
        mesh, name = axis
        return mesh.get_group(name)
    if hasattr(axis, "get_group"):  # a 1-D DeviceMesh
        return axis.get_group()
    return axis


def transport(op: str, x: torch.Tensor, group) -> str:
    """``"host"`` when ``op`` on ``x`` is staged through pinned host
    memory (a CUDA tensor, a gloo group, an op gloo does not run on the
    device), else ``"device"``."""
    if x.is_cuda and dist.get_backend(group) == "gloo" and op not in GLOO_CUDA_OPS:
        return "host"
    return "device"


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return h.copy_(x)


def _run(op: str, fn, out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """``fn(out, x)`` on the route :func:`transport` gives; returns ``out``."""
    if transport(op, x, group) == "device":
        fn(out, x)
        return out
    h_out = _host(out)
    fn(h_out, h_out if x is out else _host(x))
    return out.copy_(h_out)


def axis_size(axis) -> int:
    return dist.get_world_size(group_of(axis))


def axis_index(axis) -> int:
    """This rank's index along ``axis``."""
    return dist.get_rank(group_of(axis))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        return _run("all_reduce",
                    lambda o, _: dist.all_reduce(o, op=dist.ReduceOp.SUM, group=group),
                    out, out, group)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, axis=None) -> torch.Tensor:
    """psum: the sum over the group, on every rank."""
    return _AllReduceSum.apply(x, group_of(axis))


def ring_all_reduce_mean(x: torch.Tensor, axis=None) -> torch.Tensor:
    """psum / axis_size -- the canonical DP gradient reduction."""
    n = axis_size(axis)
    return all_reduce_sum(x, axis) / torch.tensor(float(n), dtype=x.dtype, device=x.device)


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    return _run("all_gather_into_tensor",
                lambda o, i: dist.all_gather_into_tensor(o, i, group=group), out, x, group)


def _scatter0(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim of size {x.shape[0]} does not split over {n} ranks")
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    return _run("reduce_scatter_tensor",
                lambda o, i: dist.reduce_scatter_tensor(o, i, op=dist.ReduceOp.SUM, group=group),
                out, x, group)


class _ReduceScatter0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _AllGather0.apply(g, ctx.group), None


class _AllGather0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter0.apply(g, ctx.group), None


def reduce_scatter_mean(x: torch.Tensor, axis=None, *, scatter_dim: int = 0) -> torch.Tensor:
    """ZeRO-2 gradient path: each rank keeps 1/N of the reduced tensor
    (dim ``scatter_dim`` divided by the group size; rank i the i-th
    block)."""
    group = group_of(axis)
    n = dist.get_world_size(group)
    out = _ReduceScatter0.apply(x.movedim(scatter_dim, 0), group).movedim(0, scatter_dim)
    return out / torch.tensor(float(n), dtype=x.dtype, device=x.device)


def all_gather_dim(x: torch.Tensor, axis=None, *, dim: int = 0) -> torch.Tensor:
    """Inverse of :func:`reduce_scatter_mean`'s split: the ranks' blocks
    concatenated along ``dim`` in rank order."""
    return _AllGather0.apply(x.movedim(dim, 0), group_of(axis)).movedim(0, dim)


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to rank ``i + shift`` and receive rank ``i - shift``'s,
    both posted in one ``batch_isend_irecv`` so the ring cannot
    deadlock."""
    n = dist.get_world_size(group)
    if shift % n == 0:
        return x.clone()
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)

    def exchange(o, i):
        ops = [dist.P2POp(dist.isend, i, dst, group), dist.P2POp(dist.irecv, o, src, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    x = x.contiguous()
    return _run("send_recv", exchange, torch.empty_like(x), x, group)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _Shift.apply(g, ctx.group, -ctx.shift), None, None


def ppermute_shift(x: torch.Tensor, axis=None, shift: int = 1) -> torch.Tensor:
    """Neighbour exchange on a ring -- the pipeline's stage hand-off: rank
    ``i``'s ``x`` arrives at rank ``i + shift`` (mod N). Its backward is
    the reverse shift, so a gradient flows back through it."""
    return _Shift.apply(x, group_of(axis), shift)


class _AllToAll0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _AllToAll0.apply(g, ctx.group), None


def all_to_all0(x: torch.Tensor, group) -> torch.Tensor:
    """(N, ...) -> (N, ...): block ``j`` goes to rank ``j``; block ``i``
    of the result came from rank ``i`` (``lax.all_to_all`` over dim 0,
    untiled). Not differentiable; :func:`all_to_all` is."""
    x = x.contiguous()
    return _run("all_to_all_single", lambda o, i: dist.all_to_all_single(o, i, group=group),
                torch.empty_like(x), x, group)


def all_to_all(x: torch.Tensor, axis=None) -> torch.Tensor:
    """:func:`all_to_all0`, differentiable: its backward is the same
    exchange of the gradient."""
    return _AllToAll0.apply(x, group_of(axis))

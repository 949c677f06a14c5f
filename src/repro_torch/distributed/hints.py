"""Activation sharding hints (counterpart of ``repro/distributed/hints.py``).

The hints are contextual so model code stays mesh-agnostic:

    with activation_hints(mesh):
        ...

``hint(x, *axes)`` is the identity outside the context. Inside it, a
DTensor is redistributed to the spec the axes resolve to (an axis that
does not divide its dim drops to replicated, as the reference's does),
and a plain tensor -- one rank's own rows -- is returned unchanged. The
context's ``current_mesh()`` also selects the expert-parallel MoE
dispatch (``models.lm``, ``moe_impl="ep_shard_map"``).

Axis vocabulary: "dp" (all pure-DP axes: pod+data, or the context's
``batch_axes``), "dp_strict" (always pod+data), "model", "model_strict"
(the model axis even when TP is off), None. Dims beyond the given axes
replicate.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.partitioner import P, mesh_shape, to_placements

_CTX = threading.local()

MODEL_AXIS = "model"


@contextmanager
def activation_hints(mesh, *, batch_axes: tuple | None = None, tp: bool = True):
    """Make ``mesh`` (a ``DeviceMesh``, or a ``MeshShape`` for spec-only
    work) the current one. ``batch_axes`` overrides what "dp" resolves to
    (FSDP mode shards the batch over the model axis too); ``tp=False``
    drops all "model" hints."""
    prev = (getattr(_CTX, "mesh", None), getattr(_CTX, "batch_axes", None),
            getattr(_CTX, "tp", True))
    _CTX.mesh, _CTX.batch_axes, _CTX.tp = mesh, batch_axes, tp
    try:
        yield
    finally:
        _CTX.mesh, _CTX.batch_axes, _CTX.tp = prev


def current_mesh():
    return getattr(_CTX, "mesh", None)


def _resolve(axis, mesh):
    """'dp' -> the context batch axes (default: pod+data); 'model' ->
    itself unless TP is disabled in this context."""
    ms = mesh_shape(mesh)
    if axis is None:
        return None
    if axis == "dp":
        override = getattr(_CTX, "batch_axes", None)
        if override is not None:
            axes = tuple(a for a in override if a in ms.shape)
        else:
            axes = tuple(a for a in ms.axis_names if a in ("pod", "data"))
        return axes if axes else None
    if axis == "dp_strict":  # the pure-DP axes, ignoring any FSDP batch override
        axes = tuple(a for a in ms.axis_names if a in ("pod", "data"))
        return axes if axes else None
    if axis == "model" and not getattr(_CTX, "tp", True):
        return None
    if axis == "model_strict":  # model axis even when TP is off (vocab-parallel loss)
        axis = MODEL_AXIS
    return axis if axis in ms.shape else None


def _axis_size(axis, mesh) -> int:
    if axis is None:
        return 1
    sizes = mesh_shape(mesh).shape
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def hint(x: torch.Tensor, *axes, force: bool = False) -> torch.Tensor:
    """Constrain ``x``'s leading dims to ``axes`` (see module docstring).
    ``force=True`` constrains even when no axis divides its dim (``x``
    then replicated), where the reference's hint leaves XLA free."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = []
    for dim, axis in zip(x.shape, axes):
        r = _resolve(axis, mesh)
        spec.append(r if r is not None and dim % _axis_size(r, mesh) == 0 else None)
    if not force and not any(s is not None for s in spec):
        return x
    return _Constrain.apply(x, to_placements(P(*spec), x.device_mesh))


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``placements``, and its gradient too, as
    the transpose of the reference's ``with_sharding_constraint`` is the
    same constraint on the cotangent. DTensor's own ``redistribute``
    sends a gradient back to the input's placements only, so a partial
    sum arriving at an already-placed activation would otherwise flow on
    unreduced into the next products."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements, ctx.input_placements = placements, tuple(x.placements)
        if tuple(x.placements) == tuple(placements):
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        # the constraint, then back to the input's own placements (as
        # DTensor's redistribute sends a gradient back)
        # (a partial input takes the constrained gradient as it is)
        targets = [ctx.placements]
        if not any(p.is_partial() for p in ctx.input_placements):
            targets.append(ctx.input_placements)
        for placements in targets:
            if tuple(g.placements) != tuple(placements):
                g = g.redistribute(g.device_mesh, placements)
        return g, None


def weight(w: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """A weight as a product uses it: the identity outside the context;
    inside it, a DTensor gathered over the batch axes ("dp": the
    complementary dim its spec shards over data, ZeRO-3's gather;
    under FSDP's ``batch_axes`` the model axis too), its TP shard kept.
    Its gradient comes back reduce-scattered. This is where the
    reference's XLA gathers a weight its activation hints force.
    ``axis="dp_strict"`` gathers the pure-DP axes only (the head, whose
    vocab dim stays on the model axis under FSDP too)."""
    mesh = current_mesh()
    if mesh is None or not isinstance(w, DTensor):
        return w
    axes = _resolve(axis, mesh) or ()
    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if names[i] in axes else p for i, p in enumerate(w.placements)]
    if tuple(pl) == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def hint_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """A (B, ..., n_heads * hd) activation placed for its split into
    heads: the reference's ``("dp", None, "model", None)`` on the heads,
    which drops to replicated heads when the model axis does not divide
    ``n_heads`` (no head may straddle two ranks); forced, whatever else
    divides, since the view needs it."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    tp = _resolve("model", mesh)
    last = "model" if tp and n_heads % _axis_size(tp, mesh) == 0 else None
    return hint(x, "dp", *([None] * (x.ndim - 2)), last, force=True)


def write_positions_(cache: torch.Tensor, pos: torch.Tensor, val: torch.Tensor) -> None:
    """``cache[b, pos[b]] = val[b]`` for a (B, T, ...) DTensor cache whose
    batch and time dims are sharded (decode's KV cache: B over data, T
    over the model axis). DTensor has no sharding rule for an in-place
    ``index_put_`` on a sharded dim, so each rank writes its own shard:
    its batch rows, at the positions that fall in its time range (the
    others keep their rows), as the reference's XLA lowers the update to
    a masked dynamic-update-slice."""
    mesh = cache.device_mesh
    names = mesh.mesh_dim_names
    local = cache.to_local()
    b0, t0 = 0, 0
    for i, p in enumerate(cache.placements):
        if isinstance(p, Shard):
            r = mesh.get_local_rank(names[i])
            if p.dim == 0:
                b0 += r * local.shape[0]
            elif p.dim == 1:
                t0 += r * local.shape[1]
    v = val.full_tensor() if isinstance(val, DTensor) and not _matches(val, cache) else val
    v = v.to_local() if isinstance(v, DTensor) else v[b0:b0 + local.shape[0]]
    p = pos.full_tensor() if isinstance(pos, DTensor) else pos
    p = p[b0:b0 + local.shape[0]] - t0
    keep = (p >= 0) & (p < local.shape[1])
    rows = torch.arange(local.shape[0], device=local.device)
    idx = p.clamp(0, local.shape[1] - 1)
    mask = keep.reshape(-1, *([1] * (v.ndim - 1)))
    local[rows, idx] = torch.where(mask, v.to(local.dtype), local[rows, idx])


def _matches(val, cache) -> bool:
    """Whether ``val`` (B, ...) holds the same batch rows per rank as
    ``cache`` (B, T, ...): sharded alike on dim 0, replicated elsewhere."""
    for pv, pc in zip(val.placements, cache.placements):
        if isinstance(pc, Shard) and pc.dim == 0:
            if not (isinstance(pv, Shard) and pv.dim == 0):
                return False
        elif not isinstance(pv, Replicate):
            return False
    return True


def reduced(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its partial sums reduced (a vocab-parallel lookup's
    masked partial is reduced right away: DTensor keeps its mask for the
    next op only)."""
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def placed_like(x: torch.Tensor, ref: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` sharded as ``ref`` is on their first ``n`` dims, replicated
    elsewhere."""
    pl = [p if isinstance(p, Shard) and p.dim < n else Replicate() for p in ref.placements]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(x.device_mesh, pl)

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
from torch.distributed.tensor import DTensor

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


def hint(x: torch.Tensor, *axes) -> torch.Tensor:
    """Constrain ``x``'s leading dims to ``axes`` (see module docstring)."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = []
    for dim, axis in zip(x.shape, axes):
        r = _resolve(axis, mesh)
        spec.append(r if r is not None and dim % _axis_size(r, mesh) == 0 else None)
    if not any(s is not None for s in spec):
        return x
    return x.redistribute(x.device_mesh, to_placements(P(*spec), x.device_mesh))

"""int8 gradient compression with error feedback (counterpart of
``repro/distributed/compression.py``).

Quantizing a gradient to int8 (per-tensor absmax scale) carries the
quantization residual in an error-feedback buffer (Seide et al. 2014;
Karimireddy et al. 2019), so the accumulated gradient is unbiased. The
arithmetic is the reference's: scale = max(absmax, 1e-30) / 127, q =
clip(round half to even(x / scale), -127, 127) as int8, dequantized q *
scale, residual x - dequantized. Every division is tensor by tensor on
the tensor's device (CUDA turns a division by a host scalar into a
reciprocal multiply).

API is functional over the port's trees (``repro_torch.tree``): the
state tree mirrors the gradient tree.

    state = ef_init(grads)
    grads_c, state = compress_grads(grads, state)      # before all-reduce
    grads   = decompress_grads(grads_c)                # after all-reduce

``compressed_all_reduce_mean`` fuses the three over a process group. As
in the reference, what it all-reduces is the dequantized fp32 payload
(the int8 wire format is ROADMAP's performance work).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as tree_lib
from repro_torch.distributed.collectives import all_reduce_sum, axis_size

_QMAX = 127.0


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def ef_init(grads: Any) -> Any:
    return tree_lib.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                             grads)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    qmax = _scalar(_QMAX, x)
    scale = torch.clamp_min(x.abs().amax(), 1e-30) / qmax
    q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _is_payload(t) -> bool:
    return isinstance(t, dict) and set(t) == {"q", "scale"}


def _map_payloads(fn, comp: Any) -> Any:
    """``fn`` at each ``{q, scale}`` node of a compressed tree."""
    if _is_payload(comp):
        return fn(comp)
    if isinstance(comp, dict):
        return {k: _map_payloads(fn, v) for k, v in comp.items()}
    if type(comp) in (tuple, list):
        return type(comp)(_map_payloads(fn, v) for v in comp)
    return comp


def _per_leaf(fn, grads: Any, ef_state: Any) -> tuple[Any, Any]:
    """``fn(g, e) -> (a, b)`` at each leaf (``e`` the state's leaf at
    the same path); the two results as trees shaped as ``grads``."""
    out = {path: fn(g, tree_lib.get(ef_state, path))
           for path, g in tree_lib.leaves_with_paths(grads)}
    return tuple(tree_lib.map_with_path(lambda path, _: out[path][i], grads) for i in (0, 1))


def compress_grads(grads: Any, ef_state: Any) -> tuple[Any, Any]:
    """Returns ({q, scale} tree, new error-feedback state)."""

    def one(g, e):
        x = g.to(torch.float32) + e
        q, scale = _quantize(x)
        return {"q": q, "scale": scale}, x - _dequantize(q, scale)  # residual stays local

    return _per_leaf(one, grads, ef_state)


def decompress_grads(comp: Any) -> Any:
    return _map_payloads(lambda c: _dequantize(c["q"], c["scale"]), comp)


def compressed_all_reduce_mean(grads: Any, ef_state: Any, axis=None) -> tuple[Any, Any]:
    """Compress each leaf with error feedback, all-reduce the ranks'
    dequantized payloads and divide by the group size: (mean tree, new
    error-feedback state). Leaf by leaf, so one leaf's payload is in
    flight at a time."""
    n = axis_size(axis)

    def one(g, e):
        x = g.to(torch.float32) + e
        payload = _dequantize(*_quantize(x))
        return all_reduce_sum(payload, axis) / _scalar(float(n), payload), x - payload

    return _per_leaf(one, grads, ef_state)

"""Binary-neural-network arithmetic: Eq. 1 of the paper and binarization
(counterpart of ``repro/core/bnn.py``, forward only).

The paper's Eq. 1 (for equally-sized binary vectors)::

    In (*) W = 2 * Popcount(In' XNOR W') - VectorLength

where ``In', W'`` are the {0,1} encodings of the ±1 vectors ``In, W``.
Conventions: ``bits`` hold {0, 1}, ``signs`` hold {-1, +1}.
"""

from __future__ import annotations

import torch


def signs_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Map {-1,+1} -> {0,1} (``-1 -> 0``, ``+1 -> 1``)."""
    if x.dtype.is_floating_point:
        return (x + 1.0) * 0.5
    return torch.div(x + 1, 2, rounding_mode="floor").to(x.dtype)


def binarize_ste(x: torch.Tensor) -> torch.Tensor:
    """Sign-binarize: ``x >= 0`` -> +1, else -1, in ``x``'s dtype.

    Zero and -0.0 map to +1 and NaN to -1, as ``jnp.where(x >= 0, ...)``
    gives. The serving slice needs no gradient, so the straight-through
    estimator of the reference is the identity of the forward here.
    """
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, one, -one)


def binary_matmul_signs(a_signs: torch.Tensor, w_signs: torch.Tensor) -> torch.Tensor:
    """Reference ±1 binary matmul: ``a @ w`` for sign-valued tensors.

    ``a_signs``: (..., m), ``w_signs``: (m, n) -> (..., n). This is the
    ground truth every engine and kernel must reproduce.
    """
    return torch.matmul(a_signs, w_signs)

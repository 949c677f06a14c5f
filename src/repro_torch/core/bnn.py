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


# The binarize threshold: -2^-126, the least normal float32 (and
# bfloat16) magnitude, negated. ``x > NEG_MIN_NORMAL`` is ``x >= 0`` on
# every value but a negative subnormal, which it reads as zero (bit 1),
# as XLA does: on the CPU and the TPU it compares subnormals as zero, so
# the reference's ``x >= 0`` gives a negative subnormal +1. The
# threshold is a normal number, so the comparison gives the same bit
# whether or not the hardware flushes subnormals.
NEG_MIN_NORMAL = -(2.0**-126)


def nonneg(x: torch.Tensor) -> torch.Tensor:
    """The binarize bit of every element: ``x > -2^-126`` (``x >= 0``
    with subnormals read as zero: -0.0 and a negative subnormal give
    True, NaN False)."""
    return x > NEG_MIN_NORMAL


def binarize_ste(x: torch.Tensor) -> torch.Tensor:
    """Sign-binarize: +1 where :func:`nonneg`, else -1, in ``x``'s dtype.

    Zero, -0.0 and subnormals of either sign map to +1 and NaN to -1, as
    the reference's ``jnp.where(x >= 0, ...)`` gives under XLA. The
    serving slice needs no gradient, so the straight-through estimator
    of the reference is the identity of the forward here.
    """
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(nonneg(x), one, -one)


def binary_matmul_signs(a_signs: torch.Tensor, w_signs: torch.Tensor) -> torch.Tensor:
    """Reference ±1 binary matmul: ``a @ w`` for sign-valued tensors.

    ``a_signs``: (..., m), ``w_signs``: (m, n) -> (..., n). This is the
    ground truth every engine and kernel must reproduce.
    """
    return torch.matmul(a_signs, w_signs)

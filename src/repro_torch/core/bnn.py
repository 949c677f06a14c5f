"""Binary-neural-network arithmetic: Eq. 1 of the paper and binarization
(counterpart of ``repro/core/bnn.py``, forward only).

The paper's Eq. 1 (for equally-sized binary vectors)::

    In (*) W = 2 * Popcount(In' XNOR W') - VectorLength

where ``In', W'`` are the {0,1} encodings of the ±1 vectors ``In, W``.
Conventions: ``bits`` hold {0, 1}, ``signs`` hold {-1, +1}. The
bit-level helpers work on any carrier dtype (no bitwise ops), so the
crossbar simulators run them on float cell states.
"""

from __future__ import annotations

import torch


def signs_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Map {-1,+1} -> {0,1} (``-1 -> 0``, ``+1 -> 1``)."""
    if x.dtype.is_floating_point:
        return (x + 1.0) * 0.5
    return torch.div(x + 1, 2, rounding_mode="floor").to(x.dtype)


def bits_to_signs(b: torch.Tensor) -> torch.Tensor:
    """Map {0,1} -> {-1,+1}."""
    return 2 * b - 1


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


# ---------------------------------------------------------------------------
# Eq. 1: XNOR + Popcount
# ---------------------------------------------------------------------------


def xnor(a_bits: torch.Tensor, w_bits: torch.Tensor) -> torch.Tensor:
    """Element-wise XNOR on {0,1} tensors (dtype-preserving, no bitwise
    ops so it also works on float carriers)."""
    return 1 - (a_bits + w_bits - 2 * a_bits * w_bits)


def popcount(bits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Population count (number of set bits) along ``dim``."""
    return torch.sum(bits, dim=dim)


def xnor_popcount(a_bits: torch.Tensor, w_bits: torch.Tensor) -> torch.Tensor:
    """``popcount(xnor(a, w))`` along the last axis — the BNN MAC."""
    return popcount(xnor(a_bits, w_bits))


def binary_dot_eq1(a_bits: torch.Tensor, w_bits: torch.Tensor) -> torch.Tensor:
    """Eq. 1: the ±1-domain dot product recovered from XNOR+popcount."""
    m = a_bits.shape[-1]
    return 2 * xnor_popcount(a_bits, w_bits) - m


# ---------------------------------------------------------------------------
# The TacitMap algebraic core: complement concatenation
# ---------------------------------------------------------------------------


def concat_complement_input(a_bits: torch.Tensor) -> torch.Tensor:
    """TacitMap input prep: ``[a ; ā]`` along the last axis (length 2m)."""
    return torch.cat([a_bits, 1 - a_bits], dim=-1)


def stack_complement_weights(w_bits: torch.Tensor) -> torch.Tensor:
    """TacitMap weight prep: ``[w ; w̄]`` stacked along the row axis.

    ``w_bits``: (m, n) -> (2m, n): weight column then its complement
    directly below it (Fig. 2-(b) of the paper).
    """
    return torch.cat([w_bits, 1 - w_bits], dim=0)


def tacitmap_vmm(a_bits: torch.Tensor, w_bits: torch.Tensor) -> torch.Tensor:
    """One-step XNOR+Popcount via a single VMM (the TacitMap identity).

    ``a_bits``: (..., m) in {0,1}; ``w_bits``: (m, n) in {0,1}. Returns
    popcount(XNOR) of shape (..., n), computed as ``[a ; ā] @ [w ; w̄]``
    — exactly what the crossbar's analog MAC does.
    """
    return torch.matmul(concat_complement_input(a_bits), stack_complement_weights(w_bits))


def tacitmap_binary_matmul(a_signs: torch.Tensor, w_signs: torch.Tensor) -> torch.Tensor:
    """±1 binary matmul routed through the TacitMap VMM identity."""
    m = a_signs.shape[-1]
    pc = tacitmap_vmm(signs_to_bits(a_signs), signs_to_bits(w_signs))
    return 2 * pc - m

"""Public wrappers around the kernels (counterpart of
``repro/kernels/ops.py``).

Bit packing, the Eq. 1 affine correction, the per-row activation scale
and shape restoration live here; callers pass ordinary tensors. The
kernels mask ragged rows, columns and words themselves, so nothing here
pads operands to block multiples -- the TPU tiling policy of the
reference (``_row_block``, the interpret-mode block choice) has no
counterpart.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import bitlinear as _bitlinear_kernel
from repro_torch.kernels import fused_decode as _fused_kernel
from repro_torch.kernels import wdm_mmm as _wdm_kernel
from repro_torch.kernels import xnor_matmul as _xnor_kernel

WORD = 32

# Block multiples of the reference's packed kernels, kept for
# `pad_packed_weights` so a prepadded artifact has the same words as the
# reference's (``repro.kernels.xnor_matmul.DEFAULT_BKW`` / ``DEFAULT_BN``).
PREPAD_WORDS = 16
PREPAD_COLS = 128


# CUDA's reduction kernel lays out fewer rows than this differently (a
# wider block, another summation tree), so a row's mean would depend on
# how many rows share the call; smaller calls are padded to this many.
MEAN_ROWS = 16


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim, keepdim, with per-row arithmetic that does
    not depend on the number of rows in the call: a decode tick of 8
    lanes, one request alone, a 1-token continuation and a full prefill
    give each row the same bits (the serving invariants need it; the CPU
    reduction has the property already, and padding leaves it so)."""
    x2 = x.reshape(-1, x.shape[-1])
    rows = x2.shape[0]
    if rows < MEAN_ROWS:
        x2 = F.pad(x2, (0, 0, 0, MEAN_ROWS - rows))
    return x2.mean(dim=-1)[:rows].reshape(*x.shape[:-1], 1)


# ---------------------------------------------------------------------------
# Bit packing
# ---------------------------------------------------------------------------


def pack_bits(bits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack {0,1} values into int32 words along ``axis`` (zero-padded).

    (..., m) -> (..., ceil(m/32)); bit i of word j is element 32*j + i.
    Words are built in int64 and wrapped, so bit 31 gives the negative
    int32 the reference's bitcast gives.
    """
    b = bits.movedim(axis, -1).to(torch.int64)
    m = b.shape[-1]
    kw = math.ceil(m / WORD)
    b = F.pad(b, (0, kw * WORD - m))
    b = b.reshape(*b.shape[:-1], kw, WORD)
    shifts = torch.arange(WORD, dtype=torch.int64, device=b.device)
    words = (b << shifts).sum(dim=-1)  # disjoint bits: sum == or
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return words.movedim(-1, axis).contiguous()


def pack_signs(signs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack ±1 values (bit = 1 for +1) into int32 words."""
    return pack_bits(signs > 0, axis)


def pack_weights(w_signs: torch.Tensor) -> torch.Tensor:
    """Program ±1 weights for the packed kernels: (m, n) -> (ceil(m/32), n)
    int32 words packed along the contraction axis (zero pad bits)."""
    return pack_bits(w_signs > 0, axis=0)


def pad_packed_weights(
    w_packed: torch.Tensor, *, bkw: int = PREPAD_WORDS, bn: int = PREPAD_COLS
) -> torch.Tensor:
    """Pad packed words with zero words to (ceil(KW/bkw)*bkw,
    ceil(n/bn)*bn) at program time. The kernels take the logical ``m``
    and ``n`` and never read the pad, so results are bit-identical."""
    kw, n = w_packed.shape
    return F.pad(w_packed, (0, (-n) % bn, 0, (-kw) % bkw))


# ---------------------------------------------------------------------------
# XNOR matmul (packed popcount path)
# ---------------------------------------------------------------------------


def xnor_matmul_packed_weights(
    a_signs: torch.Tensor, w_packed: torch.Tensor, *, m: int, n: int
) -> torch.Tensor:
    """±1 binary matmul against pre-packed weights (:func:`pack_weights`).

    (..., m) x (ceil(m/32), n) words -> (..., n) int32. ``m``/``n`` are
    the logical weight dims; Eq. 1 needs the true contraction length.
    Only the activation side packs per call.
    """
    lead = a_signs.shape[:-1]
    ap = pack_bits(a_signs.reshape(-1, m) > 0)
    ham = _xnor_kernel.hamming_matmul_packed(ap, w_packed, n=n)
    return (m - 2 * ham).reshape(*lead, n)


def xnor_matmul(a_signs: torch.Tensor, w_signs: torch.Tensor) -> torch.Tensor:
    """±1 binary matmul via the packed XNOR+popcount kernel:
    (..., m) x (m, n) -> (..., n) int32, bit-exact vs the ±1 matmul.
    Packs the weights, then delegates to :func:`xnor_matmul_packed_weights`."""
    return xnor_matmul_packed_weights(
        a_signs,
        pack_weights(w_signs),
        m=int(a_signs.shape[-1]),
        n=int(w_signs.shape[1]),
    )


# ---------------------------------------------------------------------------
# Fused BitLinear (binarize + pack + XNOR + popcount + scale)
# ---------------------------------------------------------------------------


def fused_bnn_matmul(
    x: torch.Tensor, w_packed: torch.Tensor, alpha, *, m: int, n: int
) -> torch.Tensor:
    """Whole fused BitLinear against prepared weights, one kernel launch.

    (..., m) raw activations x (ceil(m/32), n) words x alpha -> (..., n)
    fp32 of ``(binarize(x) @ w±1) * (alpha * beta)`` with ``beta =
    mean|x|`` per row, computed here in fp32 with the same expression as
    ``models.layers.dense`` (:func:`row_mean`). ``alpha`` is a scalar or an (n,) vector (the
    concatenated [q|k|v] projection). Leading dims flatten, so stacked
    (G, K, m) groups are one launch. bf16 and fp32 activations go to the
    kernel as they are; other dtypes are cast to fp32.
    """
    lead = x.shape[:-1]
    beta = row_mean(x.abs().to(torch.float32))
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.to(torch.float32)
    x2 = x.reshape(-1, m).contiguous()
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    alpha = alpha.reshape(-1).expand(n).contiguous()
    out = _fused_kernel.fused_bnn_matmul_kernel(
        x2, w_packed, alpha, beta.reshape(-1), m=m, n=n
    )
    return out.reshape(*lead, n)


# ---------------------------------------------------------------------------
# WDM MMM
# ---------------------------------------------------------------------------


def wdm_mmm(groups: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, K, m) x (m, n) -> (G, K, n) fp32: K wavelengths per pass, one
    launch over the G * K rows. Both operands are carried in bf16 (exact
    for ±1), as the reference does."""
    g, k, m = groups.shape
    lhs = groups.reshape(g * k, m).to(torch.bfloat16)
    out = _wdm_kernel.mmm(lhs, w.to(torch.bfloat16))
    return out.reshape(g, k, w.shape[1])


# ---------------------------------------------------------------------------
# BitLinear (fused binarize + matmul + rescale)
# ---------------------------------------------------------------------------


def bitlinear(x: torch.Tensor, w_signs: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """(..., m) fp x (m, n) ±1 x (n,) -> (..., n) fp32 fused BitLinear:
    ``(sign(x) @ w_signs) * alpha`` with sign(0) = +1. Weights go to the
    kernel in bf16 and alpha in fp32, as the reference casts them; bf16
    and fp32 activations go as they are, other dtypes as fp32."""
    m = x.shape[-1]
    lead = x.shape[:-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.to(torch.float32)
    out = _bitlinear_kernel.bitlinear_kernel(
        x.reshape(-1, m),
        w_signs.to(torch.bfloat16),
        alpha.to(torch.float32).reshape(-1),
    )
    return out.reshape(*lead, w_signs.shape[1])

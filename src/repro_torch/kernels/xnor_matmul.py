"""Packed XNOR+popcount Hamming matmul: CUDA kernel, plain version, count.

Replaces the Pallas TPU kernel ``repro/kernels/xnor_matmul.py``
(``_hamming_kernel`` / ``hamming_matmul_packed``)::

    ham[b, c] = sum_j popcount(a[b, j] XOR w[j, c])      (int32)

The wrapper :func:`hamming_matmul_packed` launches ``csrc/xnor_matmul.cu``
for CUDA tensors and runs :func:`hamming_matmul_plain` for CPU tensors;
any other device raises. The ops wrapper applies Eq. 1
(``dot = m - 2 * ham``).

Two variants of the CUDA kernel sit behind the wrapper, chosen by
:func:`mma_plan.choose_hamming` from strides and alignment before the
launch; a variant that fails to build or launch raises:

* ``b1`` -- row strides of both operands multiples of 4 words: the
  binary tensor cores (``mma.sync`` m16n8k256 ``.and.popc``, ham =
  popc(a) + popc(w) - 2 popc(a & w)), a TMA ring of the artifact's word
  tiles and a cluster split-K planned in :mod:`mma_plan`. What bounds it
  on an H100: the weight words at decode, the int32 output at the
  lockstep prefill's 1024 rows;
* ``popc`` -- any strides: 32-bit popcounts, one thread per column.

See the source for both designs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, mma_plan

# launches of the CUDA kernel since the last reset (the plain version
# does not count), in all and per variant
launches = 0
launches_by_variant = dict.fromkeys(mma_plan.HAM_VARIANTS, 0)

# rows per chunk of the plain version are sized so the (rows, KW, N)
# XOR intermediate stays near this many elements
_PLAIN_CHUNK = 1 << 22


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word, as int64 (SWAR popcount).

    Works in int64 on the word's unsigned value, so the shifts stay
    logical (``>>`` on int32 is arithmetic) and nothing overflows.
    """
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matmul_plain(a_packed: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """(B, KW) int32 x (KW, N) int32 -> (B, N) int32 Hamming sums, in
    plain PyTorch ops, chunked over rows."""
    rows, kw = a_packed.shape
    n = w_packed.shape[1]
    out = torch.empty((rows, n), dtype=torch.int32, device=a_packed.device)
    step = max(1, _PLAIN_CHUNK // max(1, kw * n))
    for i in range(0, rows, step):
        x = torch.bitwise_xor(a_packed[i : i + step, :, None], w_packed[None])
        out[i : i + step] = popcount32(x).sum(dim=1).to(torch.int32)
    return out


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


_B1_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    return _build.load("xnor_matmul", {"hamming_matmul": _ARGTYPES,
                                       "hamming_matmul_b1": _B1_ARGTYPES})


def hamming_matmul_packed(
    a_packed: torch.Tensor, w_packed: torch.Tensor, *, n: int | None = None
) -> torch.Tensor:
    """(B, KW) int32 x (KW', N') int32 -> (B, n) int32 Hamming sums.

    Sums over the activation's ``KW`` words; the weight artifact may
    carry more word rows and columns (block padding), so ``KW' >= KW``
    and ``n <= N'`` (default ``N'``).
    """
    if a_packed.dtype != torch.int32 or w_packed.dtype != torch.int32:
        raise TypeError(
            f"packed operands must be int32, got {a_packed.dtype} / {w_packed.dtype}"
        )
    if a_packed.ndim != 2 or w_packed.ndim != 2:
        raise ValueError(
            f"expected (B, KW) x (KW, N) words, got {tuple(a_packed.shape)} x "
            f"{tuple(w_packed.shape)}"
        )
    rows, kw = a_packed.shape
    n = w_packed.shape[1] if n is None else int(n)
    if kw > w_packed.shape[0] or n > w_packed.shape[1]:
        raise ValueError(
            f"packed word-count mismatch: activations carry {kw} words and want "
            f"{n} columns, weights carry {tuple(w_packed.shape)}"
        )
    if a_packed.device != w_packed.device:
        raise ValueError(f"operands on {a_packed.device} and {w_packed.device}")
    if a_packed.device.type == "cpu":
        return hamming_matmul_plain(a_packed, w_packed[:kw, :n])
    if a_packed.device.type != "cuda":
        raise ValueError(f"no Hamming kernel for device {a_packed.device}")
    if w_packed.stride(1) != 1:
        raise ValueError("weight words must be row-major (stride 1 along N)")
    a = a_packed.contiguous()
    out = torch.empty((rows, n), dtype=torch.int32, device=a.device)
    if rows == 0 or n == 0:
        return out
    lib = _lib()
    plan = mma_plan.choose_hamming(a, w_packed, out)
    args = (a.data_ptr(), a.stride(0), w_packed.data_ptr(), w_packed.stride(0),
            out.data_ptr(), rows, n, kw)
    if plan.variant == "b1":
        rc = _build.on_device(a.device, lib.hamming_matmul_b1, *args, *plan.args)
    else:
        rc = _build.on_device(a.device, lib.hamming_matmul, *args)
    if rc != 0:
        raise RuntimeError(f"hamming_matmul launch failed ({plan.describe()}): error {rc}")
    global launches
    launches += 1
    launches_by_variant[plan.variant] += 1
    return out

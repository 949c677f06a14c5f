"""Packed XNOR+popcount Hamming matmul: CUDA kernel, plain version, count.

Replaces the Pallas TPU kernel ``repro/kernels/xnor_matmul.py``
(``_hamming_kernel`` / ``hamming_matmul_packed``)::

    ham[b, c] = sum_j popcount(a[b, j] XOR w[j, c])      (int32)

The wrapper :func:`hamming_matmul_packed` launches ``csrc/xnor_matmul.cu``
for CUDA tensors and runs :func:`hamming_matmul_plain` for CPU tensors;
any other device raises. The ops wrapper applies Eq. 1
(``dot = m - 2 * ham``).

What bounds it on an H100: at decode (a handful of rows) the weight
words are nearly all the bytes and each is read once per 8-row tile, so
it is memory bound; at prefill widths the 32-bit popcount rate (16 per
clock per SM) bounds it. The kernel keeps a row tile's activation words
in shared memory, gives each thread one output column so a warp's weight
reads coalesce, and accumulates in int32 registers (see the source).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel since the last reset (the plain version
# does not count)
launches = 0

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


def _lib() -> ctypes.CDLL:
    return _build.load("xnor_matmul", {"hamming_matmul": _ARGTYPES})


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
    with torch.cuda.device(a.device):
        rc = lib.hamming_matmul(
            a.data_ptr(), a.stride(0), w_packed.data_ptr(), w_packed.stride(0),
            out.data_ptr(), rows, n, kw, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"hamming_matmul launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out

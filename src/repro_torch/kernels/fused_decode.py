"""Fused BitLinear (binarize + pack + XNOR + popcount + scale): CUDA
kernel, plain version, launch count.

Replaces the Pallas TPU kernel ``repro/kernels/fused_decode.py``
(``_fused_kernel`` / ``fused_bnn_matmul_kernel``)::

    out[b, c] = (m - 2 * sum_j popcount(pack(x[b] >= 0)_j XOR w[j, c]))
                * (alpha[c] * beta[b])

with ``alpha * beta`` multiplied first, as the reference does, so the
result is bit-exact against the unfused ``layers.dense`` chain given the
same ``beta``. The wrapper :func:`fused_bnn_matmul_kernel` launches
``csrc/fused_decode.cu`` for CUDA tensors and runs
:func:`fused_bnn_matmul_plain` for CPU tensors; any other device raises.

What bounds it on an H100: at decode the weight words dominate the bytes
(memory bound); at prefill widths the popcount rate does. The kernel
reads the activations in the dtype they arrive in (bf16 on the serving
path: ``x >= 0`` gives the same bit as on its fp32 cast, so no cast pass
runs), packs 32 features per warp step with ``__ballot_sync`` into
shared memory, and streams coalesced weight words per output column
(see the source).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.xnor_matmul import hamming_matmul_plain

# launches of the CUDA kernel since the last reset (the plain version
# does not count)
launches = 0

_ENTRY = {torch.bfloat16: "fused_bnn_matmul_bf16", torch.float32: "fused_bnn_matmul_f32"}


def fused_bnn_matmul_plain(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    *,
    m: int,
    n: int,
) -> torch.Tensor:
    """The same function in plain PyTorch ops: (B, m) float x
    (KW', N') words x alpha (n,) x beta (B,) -> (B, n) fp32."""
    from repro_torch.kernels.ops import pack_bits  # ops imports this module

    kw = -(-m // 32)
    words = pack_bits(x[:, :m] >= 0)
    ham = hamming_matmul_plain(words, w_packed[:kw, :n])
    dot = (m - 2 * ham).to(torch.float32)  # exact: |dot| <= m < 2^24
    return dot * (alpha.reshape(1, n) * beta.reshape(-1, 1))


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _lib() -> ctypes.CDLL:
    return _build.load("fused_decode", {entry: _ARGTYPES for entry in _ENTRY.values()})


def fused_bnn_matmul_kernel(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    *,
    m: int,
    n: int,
) -> torch.Tensor:
    """(B, m) bf16/fp32 x (KW', N') int32 words x alpha (n,) fp32 x
    beta (B,) fp32 -> (B, n) fp32.

    ``m``/``n`` are the logical weight dims; the weight artifact may
    carry block padding (``KW' >= ceil(m/32)``, ``N' >= n``), whose
    extra words are never read.
    """
    if x.ndim != 2 or x.shape[1] < m:
        raise ValueError(f"activations must be (B, >= {m}), got {tuple(x.shape)}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"activations must be bf16 or fp32, got {x.dtype}")
    if w_packed.dtype != torch.int32 or w_packed.ndim != 2:
        raise TypeError(f"weights must be 2-D int32 words, got {w_packed.dtype}")
    kw = -(-m // 32)
    if w_packed.shape[0] < kw or w_packed.shape[1] < n:
        raise ValueError(
            f"prepared weights carry {tuple(w_packed.shape)} words but m={m}, "
            f"n={n} need ({kw}, {n})"
        )
    rows = x.shape[0]
    if alpha.shape != (n,) or beta.shape != (rows,):
        raise ValueError(
            f"scale shapes must be alpha ({n},) / beta ({rows},), got "
            f"{tuple(alpha.shape)} / {tuple(beta.shape)}"
        )
    if alpha.dtype != torch.float32 or beta.dtype != torch.float32:
        raise TypeError("alpha and beta must be fp32")
    devices = {t.device for t in (x, w_packed, alpha, beta)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    if x.device.type == "cpu":
        return fused_bnn_matmul_plain(x, w_packed, alpha, beta, m=m, n=n)
    if x.device.type != "cuda":
        raise ValueError(f"no fused BitLinear kernel for device {x.device}")
    if x.stride(1) != 1 or w_packed.stride(1) != 1:
        raise ValueError("activations and weight words must be row-major")
    alpha, beta = alpha.contiguous(), beta.contiguous()
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    if rows == 0 or n == 0:
        return out
    fn = getattr(_lib(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), x.stride(0), w_packed.data_ptr(), w_packed.stride(0),
            alpha.data_ptr(), beta.data_ptr(), out.data_ptr(), rows, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_bnn_matmul launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out

"""Fused BitLinear (binarize + pack + XNOR + popcount + scale): CUDA
kernel, plain version, launch counts.

Replaces the Pallas TPU kernel ``repro/kernels/fused_decode.py``
(``_fused_kernel`` / ``fused_bnn_matmul_kernel``)::

    out[b, c] = (m - 2 * sum_j popcount(pack(x[b] >= 0)_j XOR w[j, c]))
                * (alpha[c] * beta[b])

with ``alpha * beta`` multiplied first, as the reference does, so the
result is bit-exact against the unfused ``layers.dense`` chain given the
same ``beta``. The wrapper :func:`fused_bnn_matmul_kernel` launches
``csrc/fused_decode.cu`` for CUDA tensors and runs
:func:`fused_bnn_matmul_plain` for CPU tensors; any other device raises.

Two variants of the CUDA kernel sit behind the wrapper, chosen by
:func:`mma_plan.choose_fused` from dtype, strides and alignment before
the launch; a variant that fails to build or launch raises, naming the
plan:

* ``b1`` -- x's row stride a multiple of 16 bytes, the weight row stride
  a multiple of 4 words, 16-byte-aligned bases: the binary tensor-core
  tile loop of ``csrc/sm90_b1.cuh`` (shared with the Hamming matmul) over
  raw activations. Each k stage's 256 features of x arrive by TMA in x's
  dtype and are binarized (``x >= 0``) and packed in the kernel; the
  epilogue applies Eq. 1 and ``alpha * beta`` after a cluster split-K.
  What bounds it on an H100: the bytes (weight words and x at decode,
  the fp32 output at the lockstep prefill's 1024 rows);
* ``popc`` -- any strides: one thread per column on the 32-bit popcount
  pipe, packing 32 features per warp step with ``__ballot_sync``.

Both read the activations in the dtype they arrive in (bf16 on the
serving path: ``x >= 0`` gives the same bit as on its fp32 cast, so no
cast pass runs). See the source for both designs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, mma_plan
from repro_torch.kernels.xnor_matmul import hamming_matmul_plain

# launches of the CUDA kernel since the last reset (the plain version
# does not count), in all and per variant
launches = 0
launches_by_variant = dict.fromkeys(mma_plan.FUSED_VARIANTS, 0)

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


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
_B1_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    sigs = {}
    for d in _DTYPES.values():
        sigs[f"fused_bnn_matmul_{d}"] = _ARGTYPES
        sigs[f"fused_bnn_matmul_b1_{d}"] = _B1_ARGTYPES
    return _build.load("fused_decode", sigs)


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
    if x.dtype not in _DTYPES:
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
    lib = _lib()
    plan = mma_plan.choose_fused(x, w_packed, out, alpha, beta, m=m)
    args = (x.data_ptr(), x.stride(0), w_packed.data_ptr(), w_packed.stride(0),
            alpha.data_ptr(), beta.data_ptr(), out.data_ptr(), rows, n, m)
    dt = _DTYPES[x.dtype]
    if plan.variant == "b1":
        rc = _build.on_device(x.device, getattr(lib, f"fused_bnn_matmul_b1_{dt}"), *args,
                              *plan.args)
    else:
        rc = _build.on_device(x.device, getattr(lib, f"fused_bnn_matmul_{dt}"), *args)
    if rc != 0:
        raise RuntimeError(f"fused_bnn_matmul launch failed ({plan.describe()}): error {rc}")
    global launches
    launches += 1
    launches_by_variant[plan.variant] += 1
    return out

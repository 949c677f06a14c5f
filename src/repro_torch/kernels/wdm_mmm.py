"""WDM MMM (K wavelengths per pass): CUDA kernel, plain version, launch
count.

Replaces the Pallas TPU kernel ``repro/kernels/wdm_mmm.py``
(``_mmm_kernel`` / ``mmm``)::

    out[r, c] = sum_k a[r, k] * w[k, c]      (bf16 operands, fp32 out)

over the (G * K, m) rows of the wavelength groups. The wrapper
:func:`mmm` launches ``csrc/wdm_mmm.cu`` for CUDA tensors and runs
:func:`mmm_plain` for CPU tensors; any other device raises.
``ops.wdm_mmm`` is the public entry point.

For ±1 operands the fp32 sums are exact integers, so kernel and plain
version agree bit for bit; for real-valued bf16 weights they differ by
summation order only. What bounds it on an H100: the weight bytes at a
few rows, the tensor cores at many; the kernel is a plain WMMA tile
loop (see the source).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel since the last reset (the plain version
# does not count)
launches = 0


def mmm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch ops: (B, m) bf16 x (m, n) bf16
    -> (B, n) fp32."""
    return a.to(torch.float32) @ w.to(torch.float32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("wdm_mmm")
    lib.wdm_mmm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.wdm_mmm.restype = ctypes.c_int
    return lib


def mmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, m) bf16 x (m, n) bf16 -> (B, n) fp32."""
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(
            f"contraction mismatch: lhs {tuple(a.shape)} against rhs {tuple(w.shape)}"
        )
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"operands must be bf16, got {a.dtype} / {w.dtype}")
    if a.device != w.device:
        raise ValueError(f"operands on {a.device} and {w.device}")
    if a.device.type == "cpu":
        return mmm_plain(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"no WDM MMM kernel for device {a.device}")
    rows, m = a.shape
    n = w.shape[1]
    a, w = a.contiguous(), w.contiguous()
    out = torch.empty((rows, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        rc = lib.wdm_mmm(
            a.data_ptr(), w.data_ptr(), out.data_ptr(), rows, m, n,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"wdm_mmm launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out

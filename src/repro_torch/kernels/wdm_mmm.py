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
summation order only; the sm90 variant's split-K adds its partials in
a fixed order, so two launches give the same bits. What bounds it on an
H100: the weight bytes at the tinyllama-1.1b shapes, 8 and 128 rows.
The kernel is the shared Hopper tile loop of ``csrc/sm90_mma.cuh``
(variant ``sm90``: TMA ring, wgmma, cluster split-K), or its WMMA
variant for shapes TMA cannot describe; :func:`mma_plan.choose` picks
one before the launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, mma_plan

# launches of the CUDA kernel since the last reset (the plain version
# does not count), in all and per variant
launches = 0
launches_by_variant = dict.fromkeys(mma_plan.VARIANTS, 0)


def mmm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch ops: (B, m) bf16 x (m, n) bf16
    -> (B, n) fp32."""
    return a.to(torch.float32) @ w.to(torch.float32)


def _lib() -> ctypes.CDLL:
    return _build.load("wdm_mmm", {
        "wdm_mmm": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        "wdm_mmm_max_active_clusters": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)],
    })


def max_active_clusters(plan: mma_plan.Plan) -> int:
    """Clusters of ``plan.split`` CTAs of the sm90 variant that the card
    holds at once (CUDA's occupancy query)."""
    clusters = ctypes.c_int(0)
    rc = _lib().wdm_mmm_max_active_clusters(plan.row_tile, plan.split, plan.stages,
                                            ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"wdm_mmm occupancy query failed: error {rc}")
    return clusters.value


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
    fn = _lib().wdm_mmm
    rows, m = a.shape
    n = w.shape[1]
    a, w = a.contiguous(), w.contiguous()
    out = torch.empty((rows, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    plan = mma_plan.choose(a, w, out)
    rc = _build.on_device(a.device, fn, a.data_ptr(), w.data_ptr(), out.data_ptr(),
                          rows, m, n, *plan.args)
    if rc != 0:
        raise RuntimeError(f"wdm_mmm launch failed ({plan.describe()}): error {rc}")
    global launches
    launches += 1
    launches_by_variant[plan.variant] += 1
    return out

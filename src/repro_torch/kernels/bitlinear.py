"""Fused BitLinear (binarize -> ±1 matmul -> rescale): CUDA kernel,
plain version, launch count.

Replaces the Pallas TPU kernel ``repro/kernels/bitlinear.py``
(``_bitlinear_kernel`` / ``bitlinear``)::

    out[r, c] = (sum_k sign(x[r, k]) * w[k, c]) * alpha[c]      (fp32)

with ``sign(x) = +1`` where ``x > -2^-126`` (``bnn.nonneg``: -0.0 and
subnormals give +1 and NaN -1, as the reference's ``jnp.where(x >= 0,
...)`` does under XLA), bf16 weights (±1 on the serving path)
and no activation scale. The wrapper :func:`bitlinear_kernel` launches
``csrc/bitlinear.cu`` for CUDA tensors and runs :func:`bitlinear_plain`
for CPU tensors; any other device raises. ``ops.bitlinear`` is the
public entry point.

With ±1 weights the sums are integers below 2^24, exact in fp32 in any
order, so kernel, plain version and the JAX kernel agree bit for bit.
What bounds it on an H100: the weight bytes at the tinyllama-1.1b shapes,
8 and 128 rows. The kernel is the shared Hopper tile loop of
``csrc/sm90_mma.cuh`` (variant ``sm90``: TMA ring, wgmma, cluster
split-K), or its WMMA variant for shapes TMA cannot describe;
:func:`mma_plan.choose` picks one before the launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bnn import nonneg
from repro_torch.kernels import _build, mma_plan

# launches of the CUDA kernel since the last reset (the plain version
# does not count), in all and per variant
launches = 0
launches_by_variant = dict.fromkeys(mma_plan.VARIANTS, 0)

_ENTRY = {torch.bfloat16: "bitlinear_bf16", torch.float32: "bitlinear_f32"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def bitlinear_plain(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch ops: (B, m) float x (m, n) bf16
    x alpha (n,) -> (B, n) fp32."""
    xs = torch.where(nonneg(x), 1.0, -1.0).to(torch.float32)
    return (xs @ w.to(torch.float32)) * alpha.reshape(1, -1)


def _lib() -> ctypes.CDLL:
    return _build.load("bitlinear", {
        **{name: _ARGTYPES for name in _ENTRY.values()},
        "bitlinear_max_active_clusters": [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)],
    })


def max_active_clusters(plan: mma_plan.Plan, x_dtype: torch.dtype) -> int:
    """Clusters of ``plan.split`` CTAs of the sm90 variant that the card
    holds at once (CUDA's occupancy query)."""
    clusters = ctypes.c_int(0)
    rc = _lib().bitlinear_max_active_clusters(
        int(x_dtype == torch.bfloat16), plan.row_tile, plan.split, plan.stages,
        ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"bitlinear occupancy query failed: error {rc}")
    return clusters.value


def bitlinear_kernel(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """(B, m) fp32 or bf16 x (m, n) bf16 x alpha (n,) fp32 -> (B, n) fp32."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"contraction mismatch: x {tuple(x.shape)} against w {tuple(w.shape)}"
        )
    rows, m = x.shape
    n = w.shape[1]
    if w.dtype != torch.bfloat16 or alpha.dtype != torch.float32 or alpha.shape != (n,):
        raise TypeError(
            f"expected bf16 weights and fp32 alpha of shape ({n},), got {w.dtype} and "
            f"{alpha.dtype} {tuple(alpha.shape)}"
        )
    if x.dtype not in _ENTRY:
        raise TypeError(f"activations must be fp32 or bf16, got {x.dtype}")
    if not (x.device == w.device == alpha.device):
        raise ValueError(f"operands on {x.device}, {w.device}, {alpha.device}")
    if x.device.type == "cpu":
        return bitlinear_plain(x, w, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"no bitlinear kernel for device {x.device}")
    fn = getattr(_lib(), _ENTRY[x.dtype])
    x, w, alpha = x.contiguous(), w.contiguous(), alpha.contiguous()
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    plan = mma_plan.choose(x, w, out, alpha)
    rc = _build.on_device(x.device, fn, x.data_ptr(), w.data_ptr(), alpha.data_ptr(),
                          out.data_ptr(), rows, m, n, *plan.args)
    if rc != 0:
        raise RuntimeError(f"bitlinear launch failed ({plan.describe()}): error {rc}")
    global launches
    launches += 1
    launches_by_variant[plan.variant] += 1
    return out

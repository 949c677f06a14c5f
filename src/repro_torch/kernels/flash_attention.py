"""Flash attention (forward): CUDA kernel, plain version, launch count.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention``): causal or non-causal softmax
attention with the online-softmax state (m, l, acc) kept in fp32 and
never written to device memory::

    q (B, H, Sq, D), k/v (B, KV, Skv, D), KV | H  ->  o (B, H, Sq, D)

GQA reads key/value head ``h // (H / KV)`` in place (no repeat). Causal
masking puts the queries at the last Sq of the Skv positions (diagonal
offset ``Skv - Sq``), which is what a continuation over a cached prefix
needs. The wrapper :func:`flash_attention` launches
``csrc/flash_attention.cu`` for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors; any other device raises.

Both walk the keys in tiles of :data:`KEY_TILE` starting at key 0, with
the TPU kernel's per-tile update::

    s = (q . k) * scale, NEG_INF where masked
    m' = max(m, rowmax(s));  p = exp(s - m'), 0 where s <= NEG_INF / 2
    l' = l * exp(m - m') + rowsum(p);  acc' = acc * exp(m - m') + p @ v
    o = acc / max(l, 1e-30)

so a query row's arithmetic depends only on its own q, its position and
the keys, never on Sq or on which query tile holds it: a tile that lies
wholly above a row's diagonal adds exactly 0 with a correction of
exactly 1. That is what makes a prefix-grafted continuation equal the
full prefill bit for bit (``models.layers.attention_continue``).

What bounds it on an H100: at the serving shapes (Sq, Skv <= a few
thousand, D = 64 or 128) the q/k/v/o bytes are small and the QK^T and
PV products dominate, so the operation rate bounds it; this first kernel
runs them on the fp32 FMA units, not the tensor cores (see the source).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# launches of the CUDA kernel since the last reset (the plain version
# does not count)
launches = 0

NEG_INF = -1e30
KEY_TILE = 32          # keys per tile (one per lane in the kernel)
ROW_BLOCK = 16         # query rows per block of the plain contractions
HEAD_DIMS = (64, 128)  # head dims the CUDA kernel is built for

_ENTRY = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}


def rowblock_matmul(a: torch.Tensor, b: torch.Tensor, first_row: int) -> torch.Tensor:
    """``a @ b`` for a (..., M, K) x (..., K, N), computed in blocks of
    :data:`ROW_BLOCK` rows aligned to absolute row ``first_row + i``, one
    product call per block.

    A GEMM picks its algorithm by shape (a CPU GEMM takes another path for
    a handful of rows, a CUDA one by M and batch count), so its per-row
    arithmetic can depend on M. Here every row is computed by a call of
    one shape, at the offset its absolute position gives it, so a row's
    bits do not depend on how many rows share the product: a
    continuation's rows equal the full pass's, a lane's equal its solo
    run's.
    """
    m = a.shape[-2]
    front = first_row % ROW_BLOCK
    back = (-(front + m)) % ROW_BLOCK
    a = F.pad(a, (0, 0, front, back))
    out = torch.cat([
        torch.matmul(a[..., i : i + ROW_BLOCK, :].contiguous(), b)
        for i in range(0, a.shape[-2], ROW_BLOCK)
    ], dim=-2)
    return out[..., front : front + m, :]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> int:
    """Validate shapes; returns the diagonal offset (0 when non-causal)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B, H, Sq, D) and k/v (B, KV, Skv, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not pair (KV | H)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    # the reference pads Skv to its key block min(128, max(Skv, 8)) and
    # masks the pad by causal position only, so it refuses this case
    bk = min(128, max(skv, 8))
    if not causal and skv % bk:
        raise ValueError("non-causal flash_attention requires Skv % bk == 0")
    return skv - sq if causal else 0


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch ops: q, k, v in fp32, the
    online softmax over key tiles of :data:`KEY_TILE`, p kept in fp32 for
    the P.V product, ``p = 0`` where ``s <= NEG_INF / 2``. Returns q's
    dtype. The products run through :func:`rowblock_matmul`, so each row
    is independent of Sq here too."""
    diag = _check(q, k, v, causal)
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    head_map = torch.arange(h, device=q.device) // (h // kvh)
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32)
    q_pos = torch.arange(sq, device=q.device) + diag
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, skv, KEY_TILE):
        kt = k[:, head_map, k0 : k0 + KEY_TILE].to(torch.float32)  # (B, H, C, D)
        vt = v[:, head_map, k0 : k0 + KEY_TILE].to(torch.float32)
        k_pos = torch.arange(k0, k0 + kt.shape[2], device=q.device)
        s = rowblock_matmul(qf, kt.transpose(-1, -2), diag) * scale
        if causal:
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(s <= NEG_INF / 2, 0.0, p)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + rowblock_matmul(p, vt, diag)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong] * 3
            + [ctypes.c_void_p]
            + [ctypes.c_int] * 8
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q (B, H, Sq, D); k/v (B, KV, Skv, D) with KV | H -> (B, H, Sq, D)
    in q's dtype. Ragged Sq and Skv are masked, never padded; non-causal
    attention over a ragged Skv raises as the reference kernel does. On
    CUDA: fp32 or bf16, D in :data:`HEAD_DIMS`, any strides with D
    contiguous."""
    diag = _check(q, k, v, causal)
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"the flash attention kernel takes fp32 or bf16, got {q.dtype}")
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernel is built for D in {HEAD_DIMS}, got {d}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
            out.data_ptr(), b, h, kvh, sq, skv, d, int(causal), diag,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out

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

The plain version and the kernel's ``sm90`` variant walk the keys in
tiles of :data:`KEY_TILE` starting at key 0 (the ``fma`` variant in tiles
of 32), with the TPU kernel's per-tile update::

    s = (q . k) * scale, NEG_INF where masked
    m' = max(m, rowmax(s));  p = exp(s - m'), 0 where s <= NEG_INF / 2
    l' = l * exp(m - m') + rowsum(p);  acc' = acc * exp(m - m') + p @ v
    o = acc / max(l, 1e-30)

so a query row's arithmetic depends only on its own q, its position and
the keys, never on Sq or on which query tile holds it: a tile that lies
wholly above a row's diagonal adds exactly 0 with a correction of
exactly 1. That is what makes a prefix-grafted continuation equal the
full prefill bit for bit (``models.layers.attention_continue``).

Two variants of the CUDA kernel sit behind the wrapper, chosen by
:func:`choose_variant` from dtypes, head dim, strides and alignment
before the launch; a variant that fails to build or launch raises (no
other variant and no plain version takes over):

* ``sm90`` -- bf16 q/k/v, D in :data:`HEAD_DIMS`, strides and bases TMA
  can describe: a TMA ring of K/V tiles, QK^T and P.V on the tensor cores
  (``wgmma``), p split exactly into three bf16 terms so that P.V stays
  exact (:func:`split_bf16x3`). What bounds it on an H100: the q/k/v/o
  bytes at the serving shapes, the products close behind;
* ``fma`` -- fp32, or a view TMA cannot describe: the products on the fp32
  FMA pipes.

See the source for both designs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, rows

# launches of the CUDA kernel since the last reset (the plain version
# does not count), in all and per variant
launches = 0
VARIANTS = ("fma", "sm90")
launches_by_variant = dict.fromkeys(VARIANTS, 0)

NEG_INF = -1e30
KEY_TILE = 64          # keys per tile (the sm90 variant's wgmma N)
HEAD_DIMS = (64, 128)  # head dims the CUDA kernel is built for

_ENTRY = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}
_SM90_ENTRY = "flash_attention_sm90"


def split_bf16x3(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 ``p`` as three bf16 terms (returned in fp32) with ``p == hi +
    mid + lo`` exactly: ``hi = bf16(p)``, ``mid = bf16(p - hi)``, ``lo =
    bf16(p - hi - mid)``. Each difference is exact in fp32 and holds at
    most 16, then 8, significant bits, and bf16 has fp32's exponent range,
    so nothing is lost while the residuals stay normal (|p| >= 2^-110).
    The sm90 kernel computes P.V as hi.V + mid.V + lo.V this way, every
    product exact, so it differs from the plain version's fp32 p @ v by
    summation order only."""
    p = p.to(torch.float32)
    hi = p.to(torch.bfloat16).to(torch.float32)
    mid = (p - hi).to(torch.bfloat16).to(torch.float32)
    lo = (p - hi - mid).to(torch.bfloat16).to(torch.float32)
    return hi, mid, lo


def tma_ok(t: torch.Tensor) -> bool:
    """Whether TMA can describe a (B, N, S, D) bf16 view: d contiguous,
    the other strides positive multiples of 16 bytes, the base 16-byte
    aligned."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) > 0 and t.stride(i) % 8 == 0 for i in range(3)))


def choose_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The CUDA variant for these operands, before any launch: ``sm90`` for
    bf16 with D in :data:`HEAD_DIMS` and views TMA can describe, else
    ``fma``."""
    if (q.dtype == torch.bfloat16 and q.shape[3] in HEAD_DIMS
            and all(tma_ok(t) for t in (q, k, v))):
        return "sm90"
    return "fma"


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
    dtype. The products run through ``rows.matmul``, so each row is
    independent of Sq here too."""
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
        s = rows.matmul(qf, kt.transpose(-1, -2), diag) * scale
        if causal:
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(s <= NEG_INF / 2, 0.0, p)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + rows.matmul(p, vt, diag)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong] * 3
    + [ctypes.c_void_p]
    + [ctypes.c_int] * 8
    + [ctypes.c_void_p]
)


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention",
                       {name: _ARGTYPES for name in (*_ENTRY.values(), _SM90_ENTRY)})


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q (B, H, Sq, D); k/v (B, KV, Skv, D) with KV | H -> (B, H, Sq, D)
    in q's dtype. Ragged Sq and Skv are masked, never padded; non-causal
    attention over a ragged Skv raises as the reference kernel does. On
    CUDA: fp32 or bf16, D in :data:`HEAD_DIMS`, any strides (a view whose
    D is not contiguous is copied first); :func:`choose_variant` picks the
    kernel."""
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
    variant = choose_variant(q, k, v)
    fn = getattr(lib, _SM90_ENTRY if variant == "sm90" else _ENTRY[q.dtype])
    rc = _build.on_device(
        q.device, fn,
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        out.data_ptr(), b, h, kvh, sq, skv, d, int(causal), diag,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed (variant {variant}): error {rc}")
    global launches
    launches += 1
    launches_by_variant[variant] += 1
    return out

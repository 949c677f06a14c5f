"""Dense oracles for the kernels (counterpart of ``repro/kernels/ref.py``).

Each is the plainest statement of what a kernel computes, with no
blocking: the tests hold the kernels' wrappers to these within the
tolerances the reference's own kernel tests state (exactly for the ±1
products, whose integer sums fp32 holds without rounding).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.bnn import nonneg


def wdm_mmm_ref(groups: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """WDM MMM oracle: (G, K, m) x (m, n) -> (G, K, n), fp32."""
    return torch.einsum("gkm,mn->gkn", groups.to(torch.float32), w.to(torch.float32))


def bitlinear_ref(x: torch.Tensor, w_signs: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Fused binarize -> matmul -> rescale oracle:
    ``(sign(x) @ w_signs) * alpha`` with sign := +1 where ``bnn.nonneg``
    (zero, -0.0 and subnormals), fp32 result."""
    xs = torch.where(nonneg(x), 1.0, -1.0).to(torch.float32)
    return (xs @ w_signs.to(torch.float32)) * alpha.to(torch.float32)[None, :]


def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Dense softmax attention. q (B, H, Sq, D); k/v (B, KV, Skv, D) with
    KV | H; causal masking puts the queries at the last Sq positions."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    kh = torch.repeat_interleave(k, g, dim=1).to(torch.float32)
    vh = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kh) / math.sqrt(d)
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril(skv - sq)
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vh).to(q.dtype)

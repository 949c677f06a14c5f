"""Seeded weights and inputs, made by the benchmark and handed to both
sides: the system under test (through the model module's ``build``,
which uses the system's own constructors) and the plain reference (as a
dict of tensors).

Every tensor is a slice of one flat buffer drawn by one ``torch.randn``
call on a CUDA generator (the CPU one in the tests), then scaled in
place: the set-up costs one large launch, not one per leaf, and the same
seed gives the same weights on either side.
"""

from __future__ import annotations

import math

import torch


def make_weights(layout: list[tuple[str, tuple[int, ...], str, float]], seed: int,
                 device) -> dict[str, torch.Tensor]:
    """The model's fp32 weights from ``seed``: one flat draw, sliced in
    the order of ``layout``, the model module's ``(name, shape, kind,
    std)`` list. ``kind`` is ``normal`` (std * N(0, 1)) or ``scale`` (1 +
    std * N(0, 1), a norm's scale)."""
    total = sum(math.prod(shape) for _, shape, _, _ in layout)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind, std in layout:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        t.mul_(std)
        if kind == "scale":
            t.add_(1.0)
        out[name] = t
    return out


def draw_normal(shape, seed: int, stream: int, std: float, device, dtype) -> torch.Tensor:
    """Inputs drawn from ``(seed, stream)`` on ``device`` in one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + stream) % (2**63))
    return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std).to(dtype)

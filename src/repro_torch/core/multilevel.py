"""Multi-level PCM study — the paper's §VI-C future-work item, built on
the crossbar device models (counterpart of ``repro/core/multilevel.py``).

The paper uses PCM cells in binary mode, citing Cardoso et al. [16]: at
realistic photonic noise levels, multi-level cells corrupt the MAC. This
module quantifies that trade-off:

* ``quantize_weights(w, bits)`` — a multi-level cell stores ``bits``
  bits of a fixed-point weight.
* ``noisy_vmm(...)`` — the analog MAC with the oPCM readout-noise model
  (relative Gaussian on the photocurrent), followed by ADC quantization.
* ``level_error_rate(...)`` — Monte-Carlo probability that noise flips
  the recovered dot product by at least one output LSB, per cell depth.

Randomness comes from an explicit ``torch.Generator`` (``noisy_vmm``) or
a seed (``level_error_rate``, ``sweep``) on the chosen device, so the
draws are the port's, not ``jax.random``'s. The ADC readout of a given
noise draw is separate from the draw (``_readout``), so the same draw
gives the reference's result bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.crossbar import OPCM_TILE, CrossbarSpec
from repro_torch.device import resolve_device


def quantize_weights(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Real-valued w in [-1, 1] -> integer conductance levels 0..2^b-1
    (round half to even, as the reference)."""
    levels = 2**bits - 1
    return torch.round((torch.clamp(w, -1.0, 1.0) + 1.0) * 0.5 * levels).to(torch.int32)


def dequantize(q: torch.Tensor, bits: int) -> torch.Tensor:
    levels = 2**bits - 1
    return q.to(torch.float32) / levels * 2.0 - 1.0


def multilevel_vmm_exact(a_levels: torch.Tensor, w_levels: torch.Tensor) -> torch.Tensor:
    """Noise-free analog MAC on integer levels (the crossbar ideal)."""
    return torch.matmul(a_levels.to(torch.float32), w_levels.to(torch.float32))


def _readout(
    a_levels: torch.Tensor,
    w_levels: torch.Tensor,
    bits: int,
    sigma: float,
    z: torch.Tensor,
    spec: CrossbarSpec,
) -> torch.Tensor:
    """The noisy MAC and ADC of :func:`noisy_vmm` for a given standard
    normal draw ``z`` of shape (batch, m, n)."""
    levels = 2**bits - 1
    af = a_levels.to(torch.float32)
    wf = w_levels.to(torch.float32)
    contrib = af[..., :, None] * wf[None, ...]  # (batch, m, n) cell currents
    noise = 1.0 + sigma * z
    summed = torch.sum(contrib * noise, dim=-2)
    # the ADC cannot resolve finer than one level-product unit (outputs
    # are integers in level units); its range covers full scale
    full_scale = a_levels.shape[-1] * levels * levels
    lsb = max(max(full_scale, 1) / spec.adc_levels, 1.0)
    # a true division, by a 0-dim tensor (CUDA turns a division by a
    # Python scalar into a multiply by its reciprocal)
    lsb_t = torch.tensor(lsb, dtype=summed.dtype, device=summed.device)
    return torch.round(summed / lsb_t) * lsb_t


def noisy_vmm(
    a_levels: torch.Tensor,
    w_levels: torch.Tensor,
    bits: int,
    sigma: float,
    gen: torch.Generator,
    spec: CrossbarSpec = OPCM_TILE,
) -> torch.Tensor:
    """Analog MAC with multiplicative photocurrent noise + ADC.

    sigma is the relative noise on each cell's contribution (per [16]:
    noise grows with modulation frequency), drawn from ``gen`` on its
    device. The ADC quantizes the summed current to ``spec.adc_bits``
    over the full-scale range rows * levels^2 (input levels x weight
    levels).
    """
    shape = (*a_levels.shape[:-1], a_levels.shape[-1], w_levels.shape[-1])
    z = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return _readout(a_levels, w_levels, bits, sigma, z.to(a_levels.device), spec)


def _error_rate(a, w, bits: int, sigma: float, z, spec: CrossbarSpec) -> float:
    """Fraction of MAC outputs off the exact integer MAC by >= one unit,
    for given level draws ``a``/``w`` and noise draw ``z``."""
    exact = multilevel_vmm_exact(a, w)
    noisy = _readout(a, w, bits, sigma, z, spec)
    return float(torch.mean((torch.abs(noisy - exact) > 0.5).to(torch.float32)))


def level_error_rate(
    bits: int,
    sigma: float,
    *,
    m: int = 64,
    n: int = 32,
    batch: int = 64,
    seed: int = 0,
    spec: CrossbarSpec = OPCM_TILE,
    device=None,
) -> float:
    """Fraction of MAC outputs whose ADC reading differs from exact.

    The error counts a recovered reading off the true integer MAC by at
    least one output unit: it captures both the analog noise and the
    ADC-resolution loss that deeper cells force (full scale grows as
    levels^2 while the ADC stays 9-bit — the paper's argument for binary
    cells, quantified). Draws come from ``torch.Generator`` seeded with
    ``seed`` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    levels = 2**bits - 1
    a = torch.randint(0, levels + 1, (batch, m), generator=gen, device=dev)
    w = torch.randint(0, levels + 1, (m, n), generator=gen, device=dev)
    z = torch.randn((batch, m, n), generator=gen, device=dev, dtype=torch.float32)
    return _error_rate(a, w, bits, sigma, z, spec)


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    bits: int
    sigma: float
    error_rate: float
    density_x: float      # storage density vs binary
    latency_x: float      # steps saved vs bit-serial binary (= bits)


def sweep(bit_depths=(1, 2, 4), sigmas=(0.0, 0.01, 0.02, 0.05, 0.1), **kw):
    """One :class:`SweepPoint` per (depth, sigma), as the reference."""
    out = []
    for bits in bit_depths:
        for sigma in sigmas:
            out.append(
                SweepPoint(
                    bits=bits,
                    sigma=sigma,
                    error_rate=level_error_rate(bits, sigma, **kw),
                    density_x=float(bits),
                    latency_x=float(bits),
                )
            )
    return out

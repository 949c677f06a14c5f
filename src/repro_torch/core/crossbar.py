"""Crossbar device + tile geometry models shared by the mappings
(counterpart of ``repro/core/crossbar.py``).

* :class:`CrossbarSpec` — the geometry / peripheral configuration of one
  memristive (ePCM) or photonic (oPCM) crossbar tile, plus its timing
  and energy constants.
* :class:`TileGrid` — how a logical (rows x cols) weight matrix is cut
  into crossbar tiles, with the counters the cost model consumes.
* :func:`adc_quantize` / :func:`readout_noise` — the tile readout.

The functional behaviour (what numbers come out) is implemented in
``tacitmap.py`` / ``custbinarymap.py``; this module is geometry+physics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

Technology = Literal["ePCM", "oPCM"]


@dataclasses.dataclass(frozen=True)
class CrossbarSpec:
    """One VMM-capable crossbar tile and its peripherals.

    Timing/energy constants and their provenance:

    * ``t_vmm_ns`` — one full VMM step (drive rows, settle, convert all
      columns through the shared ADC). 100 ns for ePCM follows
      ISAAC/PUMA; oPCM uses 80 ns: photonic propagation is ~ps, so the
      readout remains ADC-limited but the row drive + settle collapses.
    * ``t_row_read_ns`` — one PCSA differential row read (10 ns).
    * ``e_adc_pj`` — energy per 8-bit ADC conversion (2 pJ, ISAAC ADC).
    * ``e_pcsa_fj`` — energy per PCSA sense (50 fJ, differential SA).
    * ``e_cell_read_fj`` — per-cell read energy (1 fJ ePCM, 0.1 fJ oPCM).
    * ``p_tia_mw`` — TIA power per output column (Eq. 2: 2 mW).
    * ``wdm_k`` — WDM capacity (number of wavelengths; K = 16 for
      current technology, 1 for anything electronic).
    """

    rows: int = 256
    cols: int = 256
    technology: Technology = "ePCM"
    adc_bits: int = 9  # ceil(log2(256 rows)) + 1 — lossless popcount range
    n_adc: int = 2
    wdm_k: int = 1
    # timing (ns)
    t_vmm_ns: float = 100.0
    t_row_read_ns: float = 10.0
    t_write_ns: float = 100.0
    # energy / power
    e_adc_pj: float = 2.0
    e_pcsa_fj: float = 50.0
    e_cell_read_fj: float = 1.0
    p_tia_mw: float = 2.0
    p_laser_mw: float = 50.0

    def __post_init__(self):
        if self.technology == "ePCM" and self.wdm_k != 1:
            raise ValueError("WDM is a photonic feature; ePCM crossbars have K=1")

    # -- derived -----------------------------------------------------------
    @property
    def adc_levels(self) -> int:
        return 2**self.adc_bits

    def vmm_energy_pj(self, active_rows: int, active_cols: int, k: int = 1) -> float:
        """Energy of one VMM (or K-way MMM) step on this tile."""
        cell = active_rows * active_cols * k * self.e_cell_read_fj * 1e-3  # fJ->pJ
        conv = active_cols * k * self.e_adc_pj
        return cell + conv


EPCM_TILE = CrossbarSpec(technology="ePCM")

OPCM_TILE = CrossbarSpec(
    technology="oPCM",
    wdm_k=16,            # §IV-A2: current technology supports K=16
    t_vmm_ns=80.0,       # photonic row-drive collapses; ADC-limited readout
    e_cell_read_fj=0.1,  # absorptive photonic read
)


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """A logical (rows x cols) binary matrix cut into crossbar tiles.

    ``rows`` is the *crossbar* row count required by the mapping (for
    TacitMap that is 2m: vector + complement), ``cols`` the number of
    stored weight vectors.
    """

    rows: int
    cols: int
    spec: CrossbarSpec

    @property
    def row_tiles(self) -> int:
        return max(1, math.ceil(self.rows / self.spec.rows))

    @property
    def col_tiles(self) -> int:
        return max(1, math.ceil(self.cols / self.spec.cols))

    @property
    def n_tiles(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def n_devices(self) -> int:
        """Total memristor/oPCM cells provisioned (for area/fairness checks)."""
        return self.n_tiles * self.spec.rows * self.spec.cols


def adc_quantize(pc: torch.Tensor, spec: CrossbarSpec, active_rows: int) -> torch.Tensor:
    """Quantize an analog popcount through the tile ADC.

    With ``adc_bits >= ceil(log2(active_rows)) + 1`` this is exact (the
    popcount of up to ``rows`` cells is an integer < 2**adc_bits), which
    is how the paper sizes ADCs. A smaller ADC quantizes uniformly:
    ``round(pc / scale) * scale``, rounding half to even as the
    reference's ``jnp.round`` does. The scale ``R / (2^bits - 1)`` is
    not a power of two, so the quotient must be a true division: it is
    taken by a 0-dim tensor on ``pc``'s device, because CUDA turns a
    division by a Python scalar into a multiply by its reciprocal, which
    rounds differently.
    """
    if active_rows < spec.adc_levels:
        return pc  # exact integer range — bit-true readout
    scale = torch.full((), active_rows / (spec.adc_levels - 1), dtype=pc.dtype, device=pc.device)
    return torch.round(pc / scale) * scale


def readout_noise(
    pc: torch.Tensor, sigma: float, generator: torch.Generator | None
) -> torch.Tensor:
    """Optional additive Gaussian readout noise (σ in popcount LSBs),
    drawn from ``generator`` (on ``pc``'s device).

    The paper's robustness argument (§II-C) is that binary PCM states
    are maximally separated, so realistic noise does not flip results.
    No engine path draws noise; the reference's ``jax.random`` stream
    cannot be matched, so only its statistics are (mean 0, std σ).
    """
    if generator is None or sigma == 0.0:
        return pc
    noise = torch.randn(pc.shape, generator=generator, dtype=torch.float32, device=pc.device)
    return pc + sigma * noise

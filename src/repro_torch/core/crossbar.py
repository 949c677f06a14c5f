"""Crossbar tile specification (counterpart of the ``CrossbarSpec`` part
of ``repro/core/crossbar.py``).

Engines bind a tile spec; the packed and reference engines of this slice
only carry it (their arithmetic does not depend on it). The tile
geometry, ADC model and ``TileGrid`` arrive with the paper-simulator
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

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


EPCM_TILE = CrossbarSpec(technology="ePCM")

OPCM_TILE = CrossbarSpec(
    technology="oPCM",
    wdm_k=16,            # §IV-A2: current technology supports K=16
    t_vmm_ns=80.0,       # photonic row-drive collapses; ADC-limited readout
    e_cell_read_fj=0.1,  # absorptive photonic read
)

"""CustBinaryMap: the SotA baseline mapping (Hirtzlin et al. [15])
(counterpart of ``repro/core/custbinarymap.py``).

2T2R rows: each weight vector is stored *horizontally* in a memory row,
bit-interleaved with its complement (x, x̄ in the two devices of each
2T2R cell). A precharge sense amplifier (PCSA) per bitline column reads
the XNOR of the driven input against ONE stored weight vector per step;
popcount then happens in digital peripherals (a 5-bit counter per
column + a tree across arrays).

Functionally the result equals ``popcount(XNOR(a, w_j))`` — the mapping
is lossless, like TacitMap. The difference is *throughput*: one weight
vector per step ("at most one single vector operation at a time", §I),
so a layer with n output vectors costs n steps (vs TacitMap's 1); the
step count is reported separately (:func:`steps_for`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bnn
from repro_torch.core.crossbar import EPCM_TILE, CrossbarSpec, TileGrid


@dataclasses.dataclass
class MappedLayerCBM:
    """Weight vectors stored row-wise, bit-interleaved with complements.

    ``rows`` has shape (n, 2m): row j = interleave(w_j, w̄_j). The
    interleaving matches Fig. 2-(a): device pair (x, x̄) per 2T2R cell.
    """

    rows: torch.Tensor
    m: int
    n: int
    spec: CrossbarSpec
    grid: TileGrid


def interleave_complement(w_row_bits: torch.Tensor) -> torch.Tensor:
    """(..., m) -> (..., 2m) with [w0, w̄0, w1, w̄1, ...] interleaving."""
    stacked = torch.stack([w_row_bits, 1 - w_row_bits], dim=-1)
    return stacked.reshape(*w_row_bits.shape[:-1], 2 * w_row_bits.shape[-1])


def map_weights(w_bits: torch.Tensor, spec: CrossbarSpec = EPCM_TILE) -> MappedLayerCBM:
    """Map a {0,1} weight matrix (m, n) row-wise (one vector per row)."""
    m, n = w_bits.shape
    rows = interleave_complement(w_bits.T)  # (n, 2m)
    # fairness bookkeeping: same device count as TacitMap — n rows of 2m
    # cells. Rows per array = spec.rows; a vector spans ceil(2m/cols)
    # arrays horizontally.
    grid = TileGrid(rows=n, cols=2 * m, spec=spec)
    return MappedLayerCBM(rows=rows, m=m, n=n, spec=spec, grid=grid)


def apply(layer: MappedLayerCBM, a_bits: torch.Tensor) -> torch.Tensor:
    """PCSA readout: XNOR of input with every stored row, then popcount.

    ``a_bits``: (..., m). Returns (..., n) popcounts in fp32. Each of the
    n rows costs one sequential step in hardware (:func:`steps_for`).

    PCSA sensing of a 2T2R pair is the XNOR bit: with the interleaved
    encoding, ``a·w + ā·w̄`` over one device pair is 1 iff a == w. The
    reference forms those (..., n, m) bits and then sums over m; here one
    fp32 product contracts the pair axis and m together, which gives the
    same integers (each below 2^24) without the (..., n, m) tensor —
    8 x 5632 x 2048 fp32 is 369 MB for one tinyllama-1.1b w1 call of 8
    decode rows.
    """
    if a_bits.shape[-1] != layer.m:
        raise ValueError(f"input length {a_bits.shape[-1]} != mapped m={layer.m}")
    drive = interleave_complement(a_bits.to(torch.float32))  # (..., 2m)
    return torch.matmul(drive, layer.rows.to(torch.float32).T)


def binary_matmul(
    a_signs: torch.Tensor, w_signs: torch.Tensor, spec: CrossbarSpec = EPCM_TILE
) -> torch.Tensor:
    """±1 binary matmul through the CustBinaryMap path."""
    m = a_signs.shape[-1]
    mapped = map_weights(bnn.signs_to_bits(w_signs).to(torch.int32), spec)
    pc = apply(mapped, bnn.signs_to_bits(a_signs))
    return 2 * pc - m


def steps_for(m: int, n: int, n_inputs: int, spec: CrossbarSpec = EPCM_TILE) -> int:
    """Sequential steps: one vector operation at a time (§I critique (b)).

    Per input vector, all n stored weight vectors are read out one row
    per step. The digital popcount is pipelined (counters run during the
    next row read), so it does not add steps, only a small drain latency
    that is folded into the per-step time.
    """
    del m, spec
    return n_inputs * n

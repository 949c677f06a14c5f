"""TacitMap: the paper's data mapping, as a functional tiled-crossbar
simulator (counterpart of ``repro/core/tacitmap.py``).

Given a binary weight matrix ``W`` (m, n) in {0,1}:

1. stack the complement below it -> (2m, n)   (Fig. 2-(b))
2. cut into crossbar tiles of ``spec.rows x spec.cols``
3. for an input bit-vector ``a`` (m,): drive ``[a ; ā]`` onto the rows;
   every tile performs one analog MAC per column; per-tile column sums
   pass through that tile's ADC; row-tile partials are summed digitally.

The result is ``popcount(XNOR(a, w_j))`` for every stored column ``j`` in
ONE step — the mapping's whole point. Bit-exact against
``bnn.tacitmap_vmm`` when the ADC is sized losslessly (the default).

The MAC runs in fp32 on {0,1} operands: every partial and total is an
integer below 2^24 (at most 2m), so any summation order — and TF32,
which holds 0 and 1 exactly — gives the same bits.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import bnn
from repro_torch.core.crossbar import EPCM_TILE, CrossbarSpec, TileGrid, adc_quantize, readout_noise


@dataclasses.dataclass
class MappedLayer:
    """A binary weight matrix mapped onto a tiled crossbar array.

    ``tiles`` has shape (row_tiles, R, col_tiles, C): the physical cell
    states ({0,1} conductances / PCM phases), zero-padded outside the
    logical (2m, n) region. Padding cells contribute 0 to column sums by
    construction (input pad bits are driven as 0), so no masking is
    needed at readout.
    """

    tiles: torch.Tensor
    m: int  # logical vector length (rows used = 2m)
    n: int  # stored weight vectors (columns used)
    spec: CrossbarSpec
    grid: TileGrid

    @property
    def steps_per_input(self) -> int:
        """Sequential crossbar steps per input vector: 1 (all tiles parallel)."""
        return 1


def layer_from_cells(
    cells: torch.Tensor, m: int, n: int, spec: CrossbarSpec = EPCM_TILE
) -> MappedLayer:
    """Lay programmed complement cell states (2m, n) onto the tile grid.

    The single source of truth for the pad/reshape layout, used by
    :func:`map_weights` (raw path) and the prepared-weights execute path
    (``repro_torch.core.engine``). When the grid divides (2m, n) the
    tiles are a view of ``cells``; otherwise a zero-padded copy.
    """
    grid = TileGrid(rows=2 * m, cols=n, spec=spec)
    R, C = spec.rows, spec.cols
    pad_r = grid.row_tiles * R - 2 * m
    pad_c = grid.col_tiles * C - n
    padded = F.pad(cells, (0, pad_c, 0, pad_r)) if pad_r or pad_c else cells
    tiles = padded.reshape(grid.row_tiles, R, grid.col_tiles, C)
    return MappedLayer(tiles=tiles, m=m, n=n, spec=spec, grid=grid)


def map_weights(w_bits: torch.Tensor, spec: CrossbarSpec = EPCM_TILE) -> MappedLayer:
    """Map a {0,1} weight matrix (m, n) onto crossbar tiles, TacitMap-style."""
    m, n = w_bits.shape
    return layer_from_cells(bnn.stack_complement_weights(w_bits), m, n, spec)


def apply(
    layer: MappedLayer,
    a_bits: torch.Tensor,
    *,
    noise_sigma: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Drive input bit-vectors through the mapped crossbar.

    ``a_bits``: (..., m) in {0,1}. Returns popcount(XNOR) of shape
    (..., n) in fp32. Every input vector costs ONE crossbar step; the
    batch dimension models sequential steps (ePCM) or WDM wavelengths
    (oPCM — see ``wdm.py``). One batched product per row tile gives the
    (row_tiles, ..., col_tiles * C) partials, each tile's columns pass
    its ADC, and the partials add up across row tiles.
    """
    if a_bits.shape[-1] != layer.m:
        raise ValueError(f"input length {a_bits.shape[-1]} != mapped m={layer.m}")
    spec = layer.spec
    R = spec.rows
    rt, ct = layer.grid.row_tiles, layer.grid.col_tiles
    lead = a_bits.shape[:-1]
    drive = bnn.concat_complement_input(a_bits.reshape(-1, layer.m).to(torch.float32))
    pad = rt * R - drive.shape[-1]
    if pad:
        drive = F.pad(drive, (0, pad))
    drive = drive.reshape(-1, rt, R).transpose(0, 1)  # (rt, B, R)
    tiles = layer.tiles.to(torch.float32).reshape(rt, R, ct * spec.cols)
    # analog MAC: per row-tile partial column sums
    partial = torch.bmm(drive, tiles)  # (rt, B, ct * C)
    # each tile's columns go through that tile's ADC (active rows = R)
    partial = adc_quantize(partial, spec, active_rows=R)
    partial = readout_noise(partial, noise_sigma, generator)
    # digital partial-sum accumulation across row tiles
    out = partial.sum(dim=0)
    return out[:, : layer.n].reshape(*lead, layer.n)


def binary_matmul(
    a_signs: torch.Tensor, w_signs: torch.Tensor, spec: CrossbarSpec = EPCM_TILE, **kw
) -> torch.Tensor:
    """±1 binary matmul executed through the full crossbar simulation."""
    m = a_signs.shape[-1]
    mapped = map_weights(bnn.signs_to_bits(w_signs).to(torch.int32), spec)
    pc = apply(mapped, bnn.signs_to_bits(a_signs), **kw)
    return 2 * pc - m


def steps_for(m: int, n: int, n_inputs: int, spec: CrossbarSpec = EPCM_TILE) -> int:
    """Sequential VMM steps TacitMap needs for ``n_inputs`` vectors.

    All row/col tiles fire in parallel (spatial architecture, digital
    partial-sum adders), so the count is just the input count — compare
    ``custbinarymap.steps_for``.
    """
    del m, n, spec
    return n_inputs

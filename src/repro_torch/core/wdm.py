"""WDM (wavelength-division multiplexing) — EinsteinBarrier's extra axis
(counterpart of ``repro/core/wdm.py``).

K input vectors are encoded on K wavelengths by the transmitter (laser →
comb → DMUX → VOAs → MUX, Fig. 6) and driven through the SAME crossbar
in one step: a VMM becomes an MMM of size (K x 2m x n), Fig. 5-(b).

Functionally this is a batched ``tacitmap.apply``; the value of this
module is the grouping/step accounting and the "one step per K-group"
execution used by the serving engine and the cost model. As in the
reference, it computes through the crossbar simulator, not through the
WDM MMM kernel (``kernels/wdm_mmm.py``), which no engine calls.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import tacitmap
from repro_torch.core.tacitmap import MappedLayer


def group_inputs(a_bits: torch.Tensor, k: int) -> tuple[torch.Tensor, int]:
    """Pack a stream of input vectors (B, m) into WDM groups (G, k, m).

    Returns the padded groups and the number of *real* vectors B. The
    pad vectors are zeros — they ride unused wavelengths and their
    outputs are discarded, exactly like idle comb lines in hardware.
    """
    B, m = a_bits.shape
    g = math.ceil(B / k)
    pad = g * k - B
    padded = F.pad(a_bits, (0, 0, 0, pad)) if pad else a_bits
    return padded.reshape(g, k, m), B


def mmm(layer: MappedLayer, groups: torch.Tensor) -> torch.Tensor:
    """Execute one MMM per WDM group: (G, k, m) -> (G, k, n).

    Each group is ONE crossbar step (all k wavelengths simultaneous).
    """
    return tacitmap.apply(layer, groups)


def wdm_apply(layer: MappedLayer, a_bits: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Full WDM pipeline: group -> MMM per group -> unpack. (B, m) -> (B, n)."""
    k = k or layer.spec.wdm_k
    groups, b = group_inputs(a_bits, k)
    out = mmm(layer, groups)
    return out.reshape(-1, out.shape[-1])[:b]


def steps_for(n_inputs: int, k: int) -> int:
    """Crossbar activations with WDM capacity k: ceil(B / k)."""
    return math.ceil(n_inputs / k)


def effective_speedup(n_inputs: int, k: int) -> float:
    """Achieved WDM parallelism (≤ k; < k when groups are ragged).

    The paper observes ~15x average for K=16 — raggedness plus
    non-WDM-able work is why the technology's K is not fully realized.
    """
    return n_inputs / steps_for(n_inputs, k)

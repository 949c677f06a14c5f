"""EinsteinBarrier: spatial accelerator hierarchy, placement and schedule
(counterpart of ``repro/core/einsteinbarrier.py``).

Fig. 4: Node → Tile → ECore → VCore. A VCore is one VMM-capable oPCM
crossbar (+DAC/ADC/TIA periphery); an ECore groups VCores behind one
WDM transmitter (§IV-A3); Tiles group ECores with shared scratch; Nodes
group Tiles. This module places a network's layers onto that hierarchy
(weights resident, PUMA-style), checks capacity, and produces the
per-layer schedule the cost model prices.

The *functional* result of executing a placement is produced by
``tacitmap.apply`` / ``wdm.wdm_apply`` — the hierarchy only decides how
many crossbars exist and how work is sequenced.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import costmodel
from repro_torch.core.crossbar import CrossbarSpec, OPCM_TILE, TileGrid
from repro_torch.core.networks import LayerDesc, NetworkDesc


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """Capacity of one EinsteinBarrier node."""

    vcores_per_ecore: int = 32
    ecores_per_tile: int = 8
    tiles_per_node: int = 16
    spec: CrossbarSpec = OPCM_TILE

    @property
    def vcores_per_node(self) -> int:
        return self.vcores_per_ecore * self.ecores_per_tile * self.tiles_per_node


@dataclasses.dataclass(frozen=True)
class LayerPlacement:
    layer: LayerDesc
    grid: TileGrid          # logical tiling of the (stacked) weight matrix
    replication: int        # extra weight copies for position parallelism
    vcores: int             # crossbars consumed = grid.n_tiles * replication
    ecore_span: int         # ECores this layer spans (ceil over transmitter groups)


@dataclasses.dataclass(frozen=True)
class Placement:
    network: NetworkDesc
    layers: tuple[LayerPlacement, ...]
    hierarchy: HierarchyConfig

    @property
    def total_vcores(self) -> int:
        return sum(p.vcores for p in self.layers)

    @property
    def nodes_needed(self) -> int:
        return max(1, math.ceil(self.total_vcores / self.hierarchy.vcores_per_node))

    @property
    def utilization(self) -> float:
        """Fraction of provisioned cells holding real (non-pad) weights."""
        used = sum(
            (2 if p.layer.binary else 1) * p.layer.m * p.layer.n * p.replication
            for p in self.layers
        )
        provisioned = sum(
            p.grid.n_devices * p.replication for p in self.layers
        )
        return used / provisioned if provisioned else 0.0


def place(
    net: NetworkDesc,
    hierarchy: HierarchyConfig | None = None,
    params: costmodel.CIMParams = costmodel.EINSTEINBARRIER,
) -> Placement:
    """Place every layer's (stacked) weight matrix onto VCores.

    Binary layers map TacitMap-style (2m rows); edge layers map their m
    rows with bit-sliced hi-res weights (edge_bits column slices).
    """
    h = hierarchy or HierarchyConfig(spec=params.tile)
    placements = []
    for layer in net.layers:
        rows = (2 if layer.binary else 1) * layer.m
        cols = layer.n * (1 if layer.binary else params.edge_bits)
        grid = TileGrid(rows=rows, cols=cols, spec=h.spec)
        if layer.positions > 1:
            cap = params.conv_replication if layer.binary else params.edge_conv_replication
            repl = min(cap, layer.positions)
        else:
            repl = 1
        vcores = grid.n_tiles * repl
        ecore_span = max(1, math.ceil(vcores / h.vcores_per_ecore))
        placements.append(
            LayerPlacement(layer=layer, grid=grid, replication=repl, vcores=vcores, ecore_span=ecore_span)
        )
    return Placement(network=net, layers=tuple(placements), hierarchy=h)


def schedule_summary(placement: Placement, params: costmodel.CIMParams) -> list[dict]:
    """Per-layer schedule: steps, latency, energy for one batch."""
    out = []
    for p in placement.layers:
        out.append(
            {
                "layer": p.layer.name,
                "binary": p.layer.binary,
                "vcores": p.vcores,
                "steps": costmodel.layer_steps(params, p.layer),
                "latency_ns": costmodel.layer_latency_ns(params, p.layer),
                "energy_pj": costmodel.layer_energy_pj(params, p.layer),
            }
        )
    return out

"""Tick scheduler: a placed plan -> ordered tile activations + cost
(counterpart of ``repro/mapping/schedule.py``).

A :class:`~repro_torch.mapping.allocator.MappingPlan` says *where* every weight
block lives; this module says *when* each tile fires and what that
costs:

* **Phases** — per input vector (or WDM K-group), a layer's tiles fire
  in parallel waves: all tiles holding exactly one of the layer's blocks
  fire in phase 0; a tile co-hosting j blocks of the same layer (tile
  budget over-subscription) fires again in phases 1..j-1. A layer's
  serialized step count per vector is therefore
  ``LayerPlan.steps_per_vector == len(phases)``.
* **Steps** — the stream of ``batch x positions`` input vectors is
  WDM-grouped by the design's K (``Engine.steps_for`` through the
  registry, the same seam the cost model uses), then multiplied by the
  phase serialization.
* **Latency / energy** — per-layer estimates via ``repro_torch.core.costmodel``
  (``layer_energy_pj`` dispatches the registered binary-energy counter;
  latency charges the tile's VMM step time per sequential step), so a
  plan's numbers and the paper-figure numbers come from one place.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import costmodel
from repro_torch.mapping.allocator import LayerPlan, MappingPlan


@dataclasses.dataclass(frozen=True)
class LayerSchedule:
    """Activation order + cost for ONE placed layer instance."""

    layer: str                          # instance name
    n_blocks: int
    phases: tuple[tuple[int, ...], ...] # tiles firing per serialized pass
    groups: int                         # WDM K-group activations per stream
    steps: int                          # total sequential steps (groups x phases)
    latency_ns: float                   # for params.batch inferences
    energy_pj: float

    @property
    def steps_per_vector(self) -> int:
        return len(self.phases)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-tick activation schedule + per-layer costs for a whole plan."""

    plan: MappingPlan
    params: costmodel.CIMParams
    layers: tuple[LayerSchedule, ...]

    @property
    def total_steps(self) -> int:
        return sum(l.steps for l in self.layers)

    @property
    def total_latency_ns(self) -> float:
        """Batch latency: the spatial pipeline streams one batch through
        all layers, so layer times add (costmodel convention)."""
        return sum(l.latency_ns for l in self.layers)

    @property
    def total_energy_pj(self) -> float:
        return sum(l.energy_pj for l in self.layers)

    def layer(self, name: str) -> LayerSchedule:
        for l in self.layers:
            if l.layer == name:
                return l
        raise KeyError(f"no layer instance {name!r} in schedule")


def phases_of(lp: LayerPlan) -> tuple[tuple[int, ...], ...]:
    """Order one layer's tile activations into parallel waves.

    Tiles holding a single block of this layer all fire together; a tile
    with j co-resident blocks (placement order preserved) contributes to
    the first j waves.
    """
    passes: dict[int, int] = {}     # tile -> blocks seen so far
    waves: list[list[int]] = []
    for b in lp.blocks:
        p = passes.get(b.tile, 0)
        passes[b.tile] = p + 1
        if p == len(waves):
            waves.append([])
        waves[p].append(b.tile)
    return tuple(tuple(sorted(w)) for w in waves)


def schedule(
    plan: MappingPlan,
    params: costmodel.CIMParams | None = None,
    batch: int | None = None,
) -> Schedule:
    """Order every layer's tile activations and price them.

    ``params`` defaults to the CIM design matching the plan's tile spec
    (ePCM -> TacitMap-ePCM, oPCM+WDM -> EinsteinBarrier); ``batch``
    overrides the design's streaming batch.
    """
    params = params or costmodel.params_for_spec(plan.spec)
    if params.tile is not plan.spec:
        params = dataclasses.replace(params, tile=plan.spec)
    if batch is not None:
        params = dataclasses.replace(params, batch=batch)

    eng = params.engine()
    rows = []
    for lp in plan.layers:
        ir = lp.ir
        desc = ir.to_layer_desc()
        phases = phases_of(lp)
        # the costmodel's stream convention: conv layers replicate
        # weights across spare tiles (position parallelism), so plan
        # numbers and the paper-figure numbers stay comparable
        stream = costmodel.position_stream(params, desc)
        groups = eng.steps_for(ir.m, ir.n, stream)
        steps = groups * len(phases)
        # latency: every sequential step is one tile-array VMM pass
        latency_ns = steps * plan.spec.t_vmm_ns
        # energy through the cost model's registered per-backend counter
        # (serialization reorders activations, it does not add any)
        energy_pj = costmodel.layer_energy_pj(params, desc)
        rows.append(
            LayerSchedule(
                layer=lp.name, n_blocks=lp.n_blocks, phases=phases,
                groups=groups, steps=steps,
                latency_ns=latency_ns, energy_pj=energy_pj,
            )
        )
    return Schedule(plan=plan, params=params, layers=tuple(rows))

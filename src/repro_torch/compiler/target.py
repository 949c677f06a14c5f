"""The hardware target: the knobs of the map -> program -> execute
pipeline in one frozen, eagerly validated artifact (counterpart of
``repro/compiler/target.py``).

Validation is EAGER and errors are NAMED: an inconsistent target (a
mapping policy on a non-tiled engine, a plan compiled for different
tiles than the target binds, a K-group wider than the placed tiles' WDM
capacity, a fault model on the plain reference path) fails at compile
time with a :class:`TargetError` subclass, not as a silently dropped
knob deep in serving.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.crossbar import CrossbarSpec
from repro_torch.faults.model import FaultModel, FaultModelError


class TargetError(ValueError):
    """An inconsistent or unsupported :class:`HardwareTarget`."""


class PlanEngineMismatchError(TargetError):
    """A mapping plan / policy / tile budget paired with an engine that
    does not execute placements (only ``tiled`` consumes a plan)."""


class SpecMismatchError(TargetError):
    """The target's tile spec disagrees with the plan it binds."""


class GroupSizeError(TargetError):
    """A K-group width the target's hardware cannot multiplex."""


@dataclasses.dataclass(frozen=True)
class HardwareTarget:
    """Where and how a BNN executes.

    * ``engine`` — a backend registered in :mod:`repro_torch.core.engine`
      (``reference`` | ``tacitmap`` | ``wdm`` | ``packed`` | ``tiled`` |
      ``custbinarymap``).
    * ``spec`` — the crossbar tile spec; ``None`` uses the engine's
      default tile (ePCM or oPCM per its capability row).
    * ``mapping_policy`` / ``tile_budget`` — compile an explicit
      layer->tile :class:`~repro_torch.mapping.allocator.MappingPlan`
      under this allocator policy (and optional physical-tile cap) and
      execute per it. Only meaningful for the plan-driven ``tiled``
      engine.
    * ``group_size`` — explicit K-group width for batched decode
      (``None`` = auto: plan WDM capacity > engine capability > one
      group spanning the pool).
    * ``prepare_weights`` — program every binarized projection at
      compile time (``lm.program_weights``) so decode streams only
      activations; ``False`` re-runs the weight-side transforms every
      call (the raw-weights baseline).
    * ``mesh_axis`` — the mesh axis the ``tiled`` engine's tile axis
      shards over; recorded (the port has no mesh yet).
    * ``fused`` — route prepared projections through the fused BitLinear
      kernel on engines that support it (``packed``); ``False`` keeps the
      unfused chain. Bit-exact either way.
    * ``spare_tiles`` — provision that many extra physical tiles in the
      compiled plan as fault-remap destinations. Implies a plan, so only
      meaningful with the ``tiled`` engine.
    * ``fault_model`` — a :class:`repro_torch.faults.FaultModel`: wrap
      the resolved backend in a :class:`repro_torch.faults.FaultyEngine`
      that deterministically injects the model's stuck cells, drift,
      dead lanes and tile failures. A null model is bit-identical to the
      unwrapped engine.
    """

    engine: str = "reference"
    spec: CrossbarSpec | None = None
    mapping_policy: str | None = None
    tile_budget: int | None = None
    group_size: int | None = None
    prepare_weights: bool = True
    mesh_axis: str | None = None
    fused: bool = True
    spare_tiles: int = 0
    fault_model: FaultModel | None = None

    def __post_init__(self):
        # normalize the CLI's "0 = auto" convention to None
        if self.group_size == 0:
            object.__setattr__(self, "group_size", None)

    @property
    def wants_plan(self) -> bool:
        """True when this target asks for an explicit MappingPlan."""
        return (
            self.mapping_policy is not None
            or self.tile_budget is not None
            or self.spare_tiles > 0
        )

    def validate(self) -> "HardwareTarget":
        """Eager static validation (no model needed); returns self.
        ``compile()`` adds the plan-dependent checks (spec mismatch, K
        vs plan capacity)."""
        from repro_torch.core import engine as engine_lib

        if self.engine not in engine_lib.list_engines():
            raise TargetError(
                f"unknown engine {self.engine!r}; registered: "
                f"{', '.join(engine_lib.list_engines())}"
            )
        if self.mapping_policy is not None:
            from repro_torch.mapping import POLICIES

            if self.mapping_policy not in POLICIES:
                raise TargetError(
                    f"unknown mapping policy {self.mapping_policy!r}; "
                    f"known: {', '.join(POLICIES)}"
                )
        if self.wants_plan and self.engine != "tiled":
            raise PlanEngineMismatchError(
                f"mapping_policy/tile_budget compile a layer->tile plan for "
                f"the plan-driven 'tiled' engine, but the target's engine is "
                f"{self.engine!r} — it would silently ignore the placement. "
                f"Use engine='tiled' (or drop the mapping fields)."
            )
        if self.tile_budget is not None and self.tile_budget < 1:
            raise TargetError(f"tile_budget must be >= 1, got {self.tile_budget}")
        if self.group_size is not None and self.group_size < 1:
            raise GroupSizeError(
                f"group_size must be >= 1 (or None for auto), got {self.group_size}"
            )
        if not self.fused and self.engine != "packed":
            raise TargetError(
                f"fused=False selects the unfused baseline of the 'packed' "
                f"engine's fused BitLinear kernel, but the target's engine is "
                f"{self.engine!r} — the knob would be silently dropped"
            )
        if self.spare_tiles < 0:
            raise TargetError(f"spare_tiles must be >= 0, got {self.spare_tiles}")
        if self.fault_model is not None:
            try:
                self.fault_model.validate()
            except FaultModelError as e:
                raise TargetError(f"invalid fault_model: {e}") from e
            if self.engine == "reference":
                raise TargetError(
                    "fault_model requires a crossbar backend to wrap, but "
                    "engine='reference' executes the plain ±1 matmul with no "
                    "engine object — pick tacitmap/wdm/packed/tiled/"
                    "custbinarymap to inject faults"
                )
        if self.mesh_axis is not None and self.engine != "tiled":
            raise TargetError(
                f"mesh_axis={self.mesh_axis!r} names the mesh axis the "
                "plan-driven 'tiled' engine shards its tile axis over, but "
                f"the target's engine is {self.engine!r} — it would silently "
                "ignore the hint"
            )
        return self

    def describe(self) -> str:
        """One line naming every pipeline choice this target pins."""
        spec = (
            "default"
            if self.spec is None
            else f"{self.spec.technology} {self.spec.rows}x{self.spec.cols}"
            + (f" K={self.spec.wdm_k}" if self.spec.wdm_k > 1 else "")
        )
        parts = [f"engine={self.engine}", f"spec={spec}"]
        if self.mapping_policy is not None:
            parts.append(f"policy={self.mapping_policy}")
        if self.tile_budget is not None:
            parts.append(f"tile_budget={self.tile_budget}")
        parts.append(f"K={'auto' if self.group_size is None else self.group_size}")
        parts.append(f"prepared={self.prepare_weights}")
        if self.engine == "packed":
            parts.append(f"fused={self.fused}")
        if self.mesh_axis is not None:
            parts.append(f"mesh_axis={self.mesh_axis}")
        if self.spare_tiles:
            parts.append(f"spares={self.spare_tiles}")
        if self.fault_model is not None:
            parts.append("faults=" + self.fault_model.describe().removeprefix("[faults] "))
        return "[target] " + " ".join(parts)

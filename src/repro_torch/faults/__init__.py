"""Device fault injection and fault tolerance (counterpart of
``repro/faults``).

Two halves, one package:

* **Injection** — :class:`FaultModel` (deterministic, seedable
  stuck-at-SET/RESET masks per physical tile, epoch-monotone
  conductance drift, dead WDM lanes, whole-tile failures) applied by
  :class:`FaultyEngine`, a decorator over any registry backend that
  honors the same ``prepare`` / ``binary_vmm`` / ``binary_mmm``
  contract and corrupts outputs with the algebraically exact delta of
  reading faulted cells. A null model is bit-identical to the plain
  engine by construction.
* **Tolerance** — detection via the TacitMap complement-row
  consistency invariant (``FaultyEngine.consistency_probe`` /
  ``locate``), fault-aware remapping onto a spare-tile pool
  (``repro_torch.mapping.remap_plan`` + ``CompiledModel.remap``), and
  graceful serving degradation (:class:`HealthMonitor`, created by the
  serving engine; only spare exhaustion fails requests — as
  ``serving.DegradedServiceError`` — never the engine).

Wiring: ``HardwareTarget(engine="tiled", mapping_policy=...,
spare_tiles=2, fault_model=FaultModel(...))`` threads everything
through ``compile()``; the shared CLI exposes ``--fault-rate`` /
``--fault-seed`` / ``--spare-tiles``.
"""

from repro_torch.faults.engine import (
    CELL_DATA_ENGINES,
    FaultInjectionError,
    FaultyEngine,
)
from repro_torch.faults.model import (
    FaultMap,
    FaultModel,
    FaultModelError,
)
from repro_torch.faults.monitor import HealthMonitor

__all__ = [
    "CELL_DATA_ENGINES",
    "FaultInjectionError",
    "FaultMap",
    "FaultModel",
    "FaultModelError",
    "FaultyEngine",
    "HealthMonitor",
]

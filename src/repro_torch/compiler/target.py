"""The hardware target: the knobs of the program -> execute pipeline in
one frozen, eagerly validated artifact (counterpart of
``repro/compiler/target.py``, main-path fields).

Validation is EAGER and errors are NAMED: an inconsistent target fails
at compile time with a :class:`TargetError` subclass, not as a silently
dropped knob deep in serving. The mapping-plan, mesh and fault fields of
the reference arrive with the slices that port them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.crossbar import CrossbarSpec


class TargetError(ValueError):
    """An inconsistent or unsupported :class:`HardwareTarget`."""


class GroupSizeError(TargetError):
    """A K-group width the target's hardware cannot multiplex."""


@dataclasses.dataclass(frozen=True)
class HardwareTarget:
    """Where and how a BNN executes.

    * ``engine`` — a backend registered in :mod:`repro_torch.core.engine`
      (``reference`` | ``packed``).
    * ``spec`` — the crossbar tile spec; ``None`` uses the engine's
      default tile.
    * ``group_size`` — explicit K-group width for batched decode
      (``None`` = auto: engine capability, else one group spanning the
      pool).
    * ``prepare_weights`` — program every binarized projection at
      compile time (``lm.program_weights``) so decode streams only
      activations; ``False`` re-runs the weight-side transforms every
      call (the raw-weights baseline).
    * ``fused`` — route prepared projections through the fused BitLinear
      kernel on engines that support it (``packed``); ``False`` keeps the
      unfused chain. Bit-exact either way.
    """

    engine: str = "reference"
    spec: CrossbarSpec | None = None
    group_size: int | None = None
    prepare_weights: bool = True
    fused: bool = True

    def __post_init__(self):
        # normalize the CLI's "0 = auto" convention to None
        if self.group_size == 0:
            object.__setattr__(self, "group_size", None)

    def validate(self) -> "HardwareTarget":
        """Eager static validation (no model needed); returns self."""
        from repro_torch.core import engine as engine_lib

        if self.engine in engine_lib.PENDING_ENGINES:
            raise TargetError(
                f"engine {self.engine!r} is not ported yet: it arrives with "
                f"{engine_lib.PENDING_ENGINES[self.engine]}; ported engines: "
                f"{', '.join(engine_lib.list_engines())}"
            )
        if self.engine not in engine_lib.list_engines():
            raise TargetError(
                f"unknown engine {self.engine!r}; registered: "
                f"{', '.join(engine_lib.list_engines())}"
            )
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
        return self

"""One-call hardware compilation: ``compile(cfg, params, target)``."""

from repro_torch.compiler.cli import (
    add_fleet_args,
    add_obs_args,
    add_scheduler_args,
    add_target_args,
    obs_from_args,
    scheduler_from_args,
    target_from_args,
)
from repro_torch.compiler.pipeline import CompiledModel, TargetPrice, compile, resolve_engine
from repro_torch.compiler.target import (
    GroupSizeError,
    HardwareTarget,
    PlanEngineMismatchError,
    SpecMismatchError,
    TargetError,
)

__all__ = [
    "CompiledModel",
    "GroupSizeError",
    "HardwareTarget",
    "PlanEngineMismatchError",
    "SpecMismatchError",
    "TargetError",
    "TargetPrice",
    "add_fleet_args",
    "add_obs_args",
    "add_scheduler_args",
    "add_target_args",
    "compile",
    "obs_from_args",
    "resolve_engine",
    "scheduler_from_args",
    "target_from_args",
]

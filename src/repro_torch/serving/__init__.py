"""Continuous-batching serving: the slot-pool engine and its scheduler."""

from repro_torch.serving.engine import BatchPlanner, GroupPlan, ServingEngine, ServingStats
from repro_torch.serving.scheduler import (
    DegradedServiceError,
    PrefixGraft,
    Request,
    RequestRejectedError,
    RequestScheduler,
    RequestState,
    RequestStatus,
    SchedulerConfig,
    SchedulerConfigError,
    SchedulerExhaustedError,
    SchedulerStats,
    SlotSnapshot,
)

__all__ = [
    "BatchPlanner",
    "DegradedServiceError",
    "GroupPlan",
    "PrefixGraft",
    "Request",
    "RequestRejectedError",
    "RequestScheduler",
    "RequestState",
    "RequestStatus",
    "SchedulerConfig",
    "SchedulerConfigError",
    "SchedulerExhaustedError",
    "SchedulerStats",
    "ServingEngine",
    "ServingStats",
    "SlotSnapshot",
]

"""Continuous-batching serving: the slot-pool engine and its scheduler."""

from repro_torch.serving.engine import BatchPlanner, GroupPlan, ServingEngine, ServingStats
from repro_torch.serving.scheduler import (
    Request,
    RequestScheduler,
    RequestState,
    RequestStatus,
    SchedulerConfig,
    SchedulerStats,
    SlotSnapshot,
)

__all__ = [
    "BatchPlanner",
    "GroupPlan",
    "Request",
    "RequestScheduler",
    "RequestState",
    "RequestStatus",
    "SchedulerConfig",
    "SchedulerStats",
    "ServingEngine",
    "ServingStats",
    "SlotSnapshot",
]

"""Fleet serving (counterpart of ``repro/fleet``): N replicas of one
compiled target behind a KV-prefix-affinity router.

* :class:`~repro_torch.fleet.replica.Replica` -- one
  ``CompiledModel.serve()`` plus per-replica identity, load score and
  snapshot trust watermark.
* :class:`~repro_torch.fleet.router.FleetRouter` -- token-block hash
  chains over a two-tier (fleet-global / replica-local) prefix index;
  policies ``prefix`` | ``least-loaded`` | ``round-robin``.
* :class:`~repro_torch.fleet.pool.FleetEngine` -- the client-facing
  pool: the same ``submit``/``step``/``drain``/``stream`` loop, plus
  prefix grafting on affinity hits and failover off degraded replicas.

FINISHED generations are identical to solo single-replica runs for
every policy, replica count and engine, grafted admissions and
failover included.
"""

from repro_torch.fleet.pool import FleetEngine, FleetRequestState, FleetStats
from repro_torch.fleet.replica import Replica
from repro_torch.fleet.router import (
    DEFAULT_BLOCK,
    ROUTING_POLICIES,
    FleetRouter,
    PrefixEntry,
    PrefixIndex,
    RouteDecision,
    RoutingConfigError,
    chain_hashes,
)

__all__ = [
    "DEFAULT_BLOCK",
    "ROUTING_POLICIES",
    "FleetEngine",
    "FleetRequestState",
    "FleetRouter",
    "FleetStats",
    "PrefixEntry",
    "PrefixIndex",
    "Replica",
    "RouteDecision",
    "RoutingConfigError",
    "chain_hashes",
]

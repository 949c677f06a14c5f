"""One fleet replica (counterpart of ``repro/fleet/replica.py``): a
compiled target's serving engine + scheduler, wrapped with the
identity, load score and clean-tick watermark the router and pool
consume.

The program-once CIM premise makes a replica cheap to reason about:
its crossbars were written once in ``compile()`` and only requests
move. Each replica owns its OWN :class:`~repro_torch.compiler.CompiledModel`
and its own programmed artifacts, so one replica's degradation never
perturbs another. The health monitor arrives with the faults slice;
until then ``serving.health`` is None and every snapshot is trusted.
"""

from __future__ import annotations

from repro_torch.serving.scheduler import (
    Request,
    RequestState,
    SchedulerConfig,
    SlotSnapshot,
)


class Replica:
    """``CompiledModel.serve()`` + per-replica identity and health."""

    def __init__(
        self,
        rid: int,
        compiled,
        *,
        max_batch: int = 4,
        max_len: int = 256,
        scheduler: SchedulerConfig | None = None,
    ):
        self.rid = int(rid)
        self.compiled = compiled
        self.serving = compiled.serve(
            max_batch=max_batch, max_len=max_len, scheduler=scheduler
        )

    # -- health --------------------------------------------------------------

    @property
    def scheduler(self):
        return self.serving.scheduler

    @property
    def healthy(self) -> bool:
        """False once this replica's service degraded (fault tolerance
        out of moves) — it then rejects all new work."""
        return self.scheduler.degraded_reason is None

    @property
    def degraded_reason(self) -> str | None:
        return self.scheduler.degraded_reason

    def trusts(self, snap: SlotSnapshot) -> bool:
        """Is a snapshot taken on THIS replica bit-trusted after its
        degradation? Trusted iff taken at or before the health
        monitor's last probe-clean tick (no persistent corruption
        existed then). A replica without fault injection never
        corrupts, so every snapshot is trusted."""
        if self.serving.health is None:
            return True
        return snap.tick <= self.serving.health.last_clean_tick

    # -- load ----------------------------------------------------------------

    def load_score(self) -> float:
        """The router's load signal, lower = freer. Committed KV tokens
        plus slot-capacity-weighted queue depth dominate (absolute
        occupancy now); the mean TTFT and end-to-end latency gauges
        break ties toward historically faster replicas."""
        s = self.scheduler
        occupancy = s.kv_committed() + len(s.waiting) * self.serving.slot_capacity
        st = s.stats()
        return occupancy + st.ticks_to_first_token + st.request_latency_ticks

    def pending(self) -> bool:
        """Work left: queued/running requests, or terminal states a
        mid-tick degrade parked for the next ``step()``."""
        return not self.scheduler.idle() or self.scheduler.pending_terminal()

    # -- thin serving delegates ----------------------------------------------

    def submit(self, request: Request) -> RequestState:
        return self.serving.submit(request)

    def adopt(self, request: Request, *, generated=(), snapshot=None):
        return self.scheduler.adopt(
            request, generated=generated, snapshot=snapshot
        )

    def step(self) -> list[RequestState]:
        return self.serving.step()

    def stats(self):
        return self.serving.stats()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "healthy" if self.healthy else "degraded"
        return (
            f"<Replica {self.rid} {self.compiled.target.engine} {state} "
            f"running={len(self.scheduler.running)} "
            f"waiting={len(self.scheduler.waiting)}>"
        )

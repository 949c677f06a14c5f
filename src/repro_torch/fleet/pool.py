"""``FleetEngine`` (counterpart of ``repro/fleet/pool.py``; its routing,
failover and degrade events and replica counters go through
:mod:`repro_torch.obs`): N replicas of one compiled target behind the
prefix-affinity router, with the same ``submit``/``step``/``drain``/
``stream`` client loop as a single
:class:`~repro_torch.serving.ServingEngine`.

Every submission is routed once (longest prefix match then load, per
the configured policy); every ``step()`` fans one scheduling tick
across the replicas that have work. Two fleet-only behaviours sit on
top of the single-replica contract:

* **Prefix grafting** — on a prefix-affinity hit the admitted request
  carries a :class:`~repro_torch.serving.scheduler.PrefixGraft` of the
  matching library entry's KV rows, so the replica prefills only the
  suffix (bit-identical to the full prefill, by the
  ``prefill_continue`` invariant). Each replica's prefill feeds its
  library back through ``prefill_observer``.
* **Failover** — when a replica degrades
  (:class:`~repro_torch.serving.scheduler.DegradedServiceError` territory),
  its FAILED requests are re-admitted on healthy replicas instead of
  surfacing the failure: requests holding a preemption snapshot at or
  below the degraded replica's clean-tick watermark resume from the
  snapshot (the cross-pool portability primitive); everything else
  re-prefills and regenerates the same tokens from scratch. Only when
  no healthy replica can take a request does its FAILED state surface.

The serving invariant one level up, tested in tests/test_torch_fleet.py:
for every routing policy x replica count x engine, every FINISHED
request's generation is identical to running it alone on one replica
-- routing, grafting and failover are semantically invisible.
"""

from __future__ import annotations

import dataclasses

from repro_torch import obs
from repro_torch.fleet.replica import Replica
from repro_torch.fleet.router import DEFAULT_BLOCK, FleetRouter, RoutingConfigError
from repro_torch.serving.engine import ServingStats
from repro_torch.serving.scheduler import (
    DegradedServiceError,
    PrefixGraft,
    Request,
    RequestRejectedError,
    RequestState,
    RequestStatus,
    SchedulerConfig,
    SchedulerExhaustedError,
)


@dataclasses.dataclass(frozen=True)
class FleetStats:
    """One frozen snapshot of the fleet's counters: routing, grafting
    and failover totals plus every replica's nested ServingStats."""

    n_replicas: int
    routing: str
    submitted: int
    finished: int
    rejected: int
    expired: int
    failed: int                 # FAILED states that could NOT fail over
    failovers: int              # requests re-admitted off a degraded replica
    salvaged: int               # failovers resumed from a trusted snapshot
    prefix_hits: int            # routing decisions that grafted a prefix
    prefix_hit_rate: float      # hits / submissions
    grafted_tokens: int         # prompt tokens elided fleet-wide
    prefill_tokens: int         # prompt tokens actually prefilled fleet-wide
    ticks: int                  # decode ticks summed over replicas
    decoded: int                # slot-tokens decoded fleet-wide
    healthy_replicas: int
    replicas: tuple[ServingStats, ...]


class FleetRequestState:
    """The client's view of one fleet request — stable across failover.

    Failover re-admits the request on another replica, producing a new
    underlying :class:`RequestState`; this proxy rebinds to it, so the
    object ``submit`` returned keeps reporting live progress. All
    RequestState attributes (``status``, ``generated``, ``done``,
    ``terminal``, ...) delegate to the current binding.
    """

    def __init__(self, request: Request, state: RequestState, replica: int):
        self.request = request
        self.replica = replica       # replica currently holding it
        self.failovers = 0
        self._st = state

    def _rebind(self, state: RequestState, replica: int) -> None:
        self._st = state
        self.replica = replica
        self.failovers += 1

    @property
    def state(self) -> RequestState:
        """The current underlying per-replica state."""
        return self._st

    def __getattr__(self, name):
        # delegate everything RequestState exposes (status, generated,
        # done, terminal, rid, latency_ticks, ...)
        return getattr(self.__dict__["_st"], name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"<FleetRequestState rid={self._st.rid} "
            f"status={self._st.status.value} replica={self.replica} "
            f"failovers={self.failovers}>"
        )


class FleetEngine:
    """N :class:`~repro_torch.fleet.replica.Replica` s behind one router.

    Build from one compiled target (``FleetEngine.build(cfg, params,
    target, n_replicas=...)`` compiles and programs each replica's own
    copy — the program-once premise, once per replica) or pass
    pre-built replicas (heterogeneous fleets: e.g. one fault-injected
    replica among clean ones, for failover tests).
    """

    def __init__(
        self,
        replicas: list[Replica],
        *,
        routing: str = "prefix",
        block_size: int = DEFAULT_BLOCK,
        prefix_capacity: int = 32,
    ):
        if not replicas:
            raise RoutingConfigError("a fleet needs >= 1 replica")
        rids = [r.rid for r in replicas]
        if len(set(rids)) != len(rids):
            raise RoutingConfigError(f"duplicate replica ids: {sorted(rids)}")
        self.replicas: dict[int, Replica] = {
            r.rid: r for r in sorted(replicas, key=lambda r: r.rid)
        }
        self.router = FleetRouter(
            self.replicas, policy=routing,
            block_size=block_size, capacity=prefix_capacity,
        )
        self.routing = routing
        # the prefix library only feeds (and is only consulted by) the
        # prefix policy, and only on stacks continuation can slice
        self._graft_ok = routing == "prefix" and all(
            r.serving.supports_prefix_graft for r in replicas
        )
        for r in replicas:
            if self._graft_ok:
                r.serving.prefill_observer = (
                    lambda st, rows, rid=r.rid: self.router.observe_prefill(
                        rid, st.request.prompt, rows
                    )
                )
            r.serving.on_degrade = (
                lambda reason, rid=r.rid: self._on_replica_degrade(rid, reason)
            )
        self._states: list[FleetRequestState] = []
        self._by_state: dict[int, FleetRequestState] = {}   # id(RequestState)
        self._counts = {
            "submitted": 0, "finished": 0, "rejected": 0, "expired": 0,
            "failed": 0, "failovers": 0, "salvaged": 0,
        }

    @classmethod
    def build(
        cls,
        cfg,
        params,
        target,
        *,
        n_replicas: int = 2,
        max_batch: int = 4,
        max_len: int = 256,
        scheduler: SchedulerConfig | None = None,
        routing: str = "prefix",
        block_size: int = DEFAULT_BLOCK,
        prefix_capacity: int = 32,
        device=None,
    ) -> "FleetEngine":
        """Compile + program ``n_replicas`` copies of one target on
        ``device`` (default ``cuda``) and stand the fleet up around
        them."""
        from repro_torch import compiler as compiler_lib

        if n_replicas < 1:
            raise RoutingConfigError(
                f"n_replicas must be >= 1, got {n_replicas}"
            )
        replicas = [
            Replica(
                rid,
                compiler_lib.compile(cfg, params, target, device=device),
                max_batch=max_batch, max_len=max_len, scheduler=scheduler,
            )
            for rid in range(n_replicas)
        ]
        return cls(
            replicas, routing=routing, block_size=block_size,
            prefix_capacity=prefix_capacity,
        )

    # -- health --------------------------------------------------------------

    def _healthy(self) -> list[Replica]:
        return [r for r in self.replicas.values() if r.healthy]

    def _on_replica_degrade(self, rid: int, reason: str) -> None:
        self.router.forget_replica(rid)
        obs.event(
            "fleet.degrade", track="fleet", replica=rid, reason=reason,
        )
        obs.gauge_set(
            "repro_fleet_replicas_healthy", len(self._healthy()),
            "replicas accepting work now",
        )

    # -- client API ----------------------------------------------------------

    def submit(self, request: Request) -> FleetRequestState:
        """Route and enqueue one request; returns its fleet state
        (possibly REJECTED — e.g. every replica degraded)."""
        self._counts["submitted"] += 1
        healthy = self._healthy()
        if not healthy:
            # let the lowest-rid replica's scheduler reject it with the
            # named degraded reason — same surface as a solo engine
            rep = next(iter(self.replicas.values()))
            st = rep.submit(request)
            return self._track(request, st, rep.rid)
        loads = {r.rid: r.load_score() for r in healthy}
        decision = self.router.route(request.prompt, loads)
        routed = request
        if self._graft_ok and decision.graft_length > 0:
            routed = dataclasses.replace(
                request,
                prefix=PrefixGraft(
                    length=decision.graft_length, rows=decision.entry.rows
                ),
            )
        obs.event(
            "fleet.route", track="fleet", rid=request.rid,
            replica=decision.replica, policy=decision.policy,
            matched_tokens=decision.matched_tokens,
            graft_length=decision.graft_length,
        )
        obs.count(
            "repro_fleet_routed_total", 1, "requests routed",
            policy=decision.policy, replica=decision.replica,
        )
        st = self.replicas[decision.replica].submit(routed)
        return self._track(request, st, decision.replica)

    def _track(
        self, request: Request, st: RequestState, rid: int
    ) -> FleetRequestState:
        fst = FleetRequestState(request, st, rid)
        self._states.append(fst)
        if st.terminal:
            self._count_terminal(st)
        else:
            self._by_state[id(st)] = fst
        return fst

    def _count_terminal(self, st: RequestState) -> None:
        key = {
            RequestStatus.FINISHED: "finished",
            RequestStatus.REJECTED: "rejected",
            RequestStatus.EXPIRED: "expired",
            RequestStatus.FAILED: "failed",
        }.get(st.status)
        if key is not None:
            self._counts[key] += 1

    def step(self) -> list[FleetRequestState]:
        """One fleet tick: every replica with work runs one scheduling
        tick; FAILED states of degraded replicas fail over to healthy
        ones. Returns the fleet states that became terminal."""
        out: list[FleetRequestState] = []
        for rid in sorted(self.replicas):
            rep = self.replicas[rid]
            if not rep.pending():
                continue
            for st in rep.step():
                fst = self._by_state.pop(id(st), None)
                if fst is None:
                    continue
                if st.status is RequestStatus.FAILED and self._failover(fst):
                    continue
                self._count_terminal(st)
                out.append(fst)
        return out

    def _failover(self, fst: FleetRequestState) -> bool:
        """Re-admit a FAILED request on a healthy replica. True when it
        was adopted (the request stays in flight); False surfaces the
        failure (no healthy replica, or none would admit it)."""
        failed_st = fst.state
        source = self.replicas[fst.replica]
        snap = failed_st.snapshot
        trusted = snap is not None and source.trusts(snap)
        healthy = self._healthy()
        if trusted:
            # resume from the clean-watermark snapshot: carried tokens +
            # restored KV rows, on the freest healthy replica
            candidates = sorted(healthy, key=lambda r: (r.load_score(), r.rid))
            for rep in candidates:
                st = rep.adopt(
                    fst.request, generated=failed_st.generated, snapshot=snap
                )
                if st.status is not RequestStatus.REJECTED:
                    self._record_failover(fst, st, rep.rid, salvaged=True)
                    return True
            return False
        if not healthy:
            return False
        # restart from scratch — re-route (the prompt's prefix may live
        # in a healthy replica's library) and regenerate; determinism
        # makes the regenerated tokens identical to the lost ones
        loads = {r.rid: r.load_score() for r in healthy}
        decision = self.router.route(fst.request.prompt, loads)
        routed = fst.request
        if self._graft_ok and decision.graft_length > 0:
            routed = dataclasses.replace(
                fst.request,
                prefix=PrefixGraft(
                    length=decision.graft_length, rows=decision.entry.rows
                ),
            )
        st = self.replicas[decision.replica].submit(routed)
        if st.status is RequestStatus.REJECTED:
            return False
        self._record_failover(fst, st, decision.replica, salvaged=False)
        return True

    def _record_failover(
        self, fst: FleetRequestState, st: RequestState, rid: int,
        salvaged: bool,
    ) -> None:
        obs.event(
            "fleet.failover", track="fleet", rid=fst.request.rid,
            source=fst.replica, target=rid, salvaged=salvaged,
        )
        obs.count(
            "repro_fleet_failovers_total", 1,
            "requests re-admitted off a degraded replica",
        )
        fst._rebind(st, rid)
        self._counts["failovers"] += 1
        if salvaged:
            self._counts["salvaged"] += 1
        if st.terminal:
            self._count_terminal(st)
        else:
            self._by_state[id(st)] = fst

    def idle(self) -> bool:
        return not any(r.pending() for r in self.replicas.values())

    def drain(self, max_ticks: int = 10_000) -> list[FleetRequestState]:
        """Step until every replica is idle; raises
        :class:`SchedulerExhaustedError` on tick exhaustion."""
        if max_ticks < 1:
            raise ValueError(
                f"max_ticks must be >= 1 (the drain safety bound), "
                f"got {max_ticks}"
            )
        out: list[FleetRequestState] = []
        for _ in range(max_ticks):
            if self.idle():
                return out
            out += self.step()
        if self.idle():
            return out
        stuck = {
            rid: [st.rid for st in r.scheduler.waiting]
            + [st.rid for st in r.scheduler.running.values()]
            for rid, r in self.replicas.items() if r.pending()
        }
        raise SchedulerExhaustedError(
            f"fleet did not drain after {max_ticks} ticks; undrained "
            f"request ids per replica: {stuck}"
        )

    def stream(self, request: Request):
        """Submit and iterate the request's tokens as they decode.

        The whole fleet makes progress under the hood. Raises
        :class:`RequestRejectedError` on admission rejection and
        :class:`DegradedServiceError` only when the request FAILED with
        no healthy replica to fail over to. Failover mid-stream is
        seamless: a snapshot resume continues the token sequence; a
        from-scratch restart regenerates the identical prefix before
        new tokens appear.
        """
        fst = self.submit(request)
        if fst.status is RequestStatus.REJECTED:
            raise RequestRejectedError(
                f"request {request.rid} rejected: {fst.reject_reason}"
            )
        sent = 0
        while not fst.terminal:
            self.step()
            while sent < len(fst.generated):
                yield fst.generated[sent]
                sent += 1
        if fst.status is RequestStatus.FAILED:
            raise DegradedServiceError(
                f"request {request.rid} failed: {fst.fail_reason}"
            )
        while sent < len(fst.generated):
            yield fst.generated[sent]
            sent += 1

    # -- reporting -----------------------------------------------------------

    def stats(self) -> FleetStats:
        c = self._counts
        per_replica = tuple(
            self.replicas[rid].stats() for rid in sorted(self.replicas)
        )
        return FleetStats(
            n_replicas=len(self.replicas),
            routing=self.routing,
            submitted=c["submitted"],
            finished=c["finished"],
            rejected=c["rejected"],
            expired=c["expired"],
            failed=c["failed"],
            failovers=c["failovers"],
            salvaged=c["salvaged"],
            prefix_hits=self.router.prefix_hits,
            prefix_hit_rate=(
                self.router.prefix_hits / c["submitted"]
                if c["submitted"] else 0.0
            ),
            grafted_tokens=sum(s.grafted_tokens for s in per_replica),
            prefill_tokens=sum(s.prefill_tokens for s in per_replica),
            ticks=sum(s.ticks for s in per_replica),
            decoded=sum(s.decoded for s in per_replica),
            healthy_replicas=len(self._healthy()),
            replicas=per_replica,
        )

    def price(self, n_active: int = 16):
        """Fleet pricing: replicas x the single target's
        :meth:`~repro_torch.compiler.CompiledModel.price` through the
        cost model (every replica programs its own crossbars; they tick
        in parallel). Modeled figures for the target's crossbar."""
        from repro_torch.core import costmodel

        base = next(iter(self.replicas.values())).compiled.price(n_active)
        return costmodel.fleet_price(base, len(self.replicas), n_active=n_active)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"<FleetEngine {len(self.replicas)} replica(s) "
            f"routing={self.routing} healthy={len(self._healthy())}>"
        )

"""Serving-side health monitor: detect -> quarantine -> remap -> degrade
(counterpart of ``repro/faults/monitor.py``).

Sits inside :class:`~repro_torch.serving.engine.ServingEngine` (created
automatically when the compiled model's backend is a
:class:`~repro_torch.faults.engine.FaultyEngine`) and closes the fault
tolerance loop at a sampled per-tick rate:

1. **Detect** — every ``check_interval`` ticks, run the compiled
   model's consistency sweep (:meth:`CompiledModel.scan_faults`) over
   all resident artifacts. A clean sweep advances ``last_clean_tick``
   — the watermark the restart logic trusts: a probe-clean tick means
   no *persistent* cell corruption existed at or before it, so
   preemption snapshots taken then are bit-exact.
2. **Quarantine + remap** — faulty tiles go to
   :meth:`CompiledModel.remap`: only the affected blocks move to clean
   spare tiles (BIST-selected via ``FaultyEngine.tile_is_clean``) and
   only those tiles reprogram (priced through the costmodel seam).
   The serving engine rebinds its executor, and every
   in-flight request whose state postdates ``last_clean_tick`` restarts
   from scratch (its output may carry corrupted tokens); clean
   snapshots are kept and resume bit-exactly.
3. **Shrink K** — dead WDM lanes are a capacity loss, not a
   correctness loss: the monitor rebinds the serving engine's K-group
   width to the surviving wavelengths (bit-exact by the grouping
   invariant), no restart needed.
4. **Degrade** — only when tolerance is out of moves (spares
   exhausted, no remap path, or the bounded ``max_remaps`` retry
   budget spent) does the scheduler *degrade*: in-flight and queued
   requests FAIL with a named reason (surfaced as
   :class:`~repro_torch.serving.scheduler.DegradedServiceError` on the
   streaming path) and new submissions are rejected — the engine
   object itself never dies.

Retry/backoff: each successful remap pushes the next sweep out by
``backoff_ticks * remaps`` extra ticks, so a fault storm cannot make
the loop thrash remap/reprogram every tick.
"""

from __future__ import annotations

from repro_torch import obs


class HealthMonitor:
    """Sampled fault sweep + bounded remap-and-restart over one
    :class:`~repro_torch.serving.engine.ServingEngine`."""

    def __init__(
        self,
        serving,
        *,
        check_interval: int = 4,
        max_remaps: int = 4,
        backoff_ticks: int = 2,
    ):
        if check_interval < 1:
            raise ValueError(f"check_interval must be >= 1, got {check_interval}")
        if max_remaps < 0:
            raise ValueError(f"max_remaps must be >= 0, got {max_remaps}")
        self.serving = serving
        self.compiled = serving.compiled
        self.check_interval = int(check_interval)
        self.max_remaps = int(max_remaps)
        self.backoff_ticks = int(backoff_ticks)
        self.last_clean_tick = -1     # newest tick a sweep came back clean
        self.remaps = 0
        self.degraded = False
        self.quarantined: set[int] = set()
        self._known_dead_lanes: set[int] = set()
        self._next_check = self.check_interval

    # -- the per-tick hook --------------------------------------------------

    def after_tick(self) -> None:
        """Called by the serving engine at the end of every decode tick
        (one integer compare when no sweep is due)."""
        if self.degraded:
            return
        tick = self.serving._counts["ticks"]
        if tick < self._next_check:
            return
        self._next_check = tick + self.check_interval
        sweep = self.compiled.scan_faults()
        new_lanes = set(sweep.lanes) - self._known_dead_lanes
        if new_lanes:
            self._known_dead_lanes |= new_lanes
            self._shrink_k(new_lanes)
        if not sweep.tiles:
            self.last_clean_tick = tick
            return
        self._handle_tiles(sweep, tick)

    # -- responses ----------------------------------------------------------

    def _shrink_k(self, new_lanes: set[int]) -> None:
        """Dead wavelengths: rebind the serving K to the survivors —
        bit-exact (the grouping invariant), so nothing restarts."""
        old_k = self.serving.group_k
        self.serving._rebind()
        obs.event(
            "fault.k_shrink", track="serve", lanes=sorted(new_lanes),
            k_before=old_k, k_after=self.serving.group_k,
        )

    def _handle_tiles(self, sweep, tick: int) -> None:
        from repro_torch.compiler.target import TargetError
        from repro_torch.faults.engine import FaultInjectionError
        from repro_torch.mapping import SpareTilesExhaustedError

        with obs.span(
            "degraded_tick", track="serve", tick=tick,
            tiles=len(sweep.tiles),
        ):
            if self.remaps >= self.max_remaps:
                self._degrade(
                    f"remap retry budget exhausted ({self.max_remaps}) with "
                    f"tiles {sorted(sweep.tiles)} still faulty"
                )
                return
            try:
                report = self.compiled.remap(sweep)
            except (SpareTilesExhaustedError, TargetError,
                    FaultInjectionError) as e:
                self._degrade(str(e))
                return
            self.remaps += 1
            self.quarantined |= set(sweep.tiles)
            self.serving._rebind()
            restarted = self.serving.scheduler.restart_in_flight(
                clean_before=self.last_clean_tick,
                reason=f"remap off faulty tiles {sorted(sweep.tiles)}",
            )
            # backoff: each remap pushes the next sweep further out so a
            # fault storm can't thrash reprogramming every tick
            self._next_check = (
                tick + self.check_interval + self.backoff_ticks * self.remaps
            )
            obs.event(
                "fault.remap", track="serve", tick=tick,
                tiles=sorted(sweep.tiles), moves=len(report.moves),
                restarted=restarted, spares_left=report.spares_left,
            )

    def _degrade(self, reason: str) -> None:
        self.degraded = True
        obs.event("fault.degrade", track="serve", reason=reason)
        obs.count(
            "repro_degraded_total", 1,
            "serving engines entering degraded service",
        )
        self.serving.scheduler.degrade(reason)
        # replica-level signal: a fleet pool subscribes here to
        # mark the replica unhealthy and fail its requests over; FAILED
        # states keep their snapshots, so the pool can salvage the ones
        # at or below last_clean_tick
        if self.serving.on_degrade is not None:
            self.serving.on_degrade(reason)

"""Production request scheduler: admission control, KV-budget queues,
SLOs and preemption in front of the slot-pool serving engine (the port's
own copy of ``repro/serving/scheduler.py``, telemetry calls included,
through :mod:`repro_torch.obs`).

The paper's resident-weight premise means independent requests stream
through the programmed crossbar with zero data-movement overhead — the
host's job is purely to keep the slot pool saturated under heavy,
bursty traffic. This module is that host-side request path, modeled on
rtp-llm's ``FIFOScheduler`` (waiting/running queues, a KV-block budget
with a reserve ratio, partial/whole fallback under cache pressure):

* **Typed requests**: :class:`Request` is the immutable submission
  (prompt, token budget, ``priority``, ``deadline_ticks``, streaming
  callback); all mutable progress — generated tokens, status,
  admission/first-token ticks, preemption snapshots — lives in the
  :class:`RequestState` the scheduler returns from ``submit``.
* **Admission control**: a request is admitted only when a slot is
  free AND its KV need fits the remaining cache-token budget
  (``pool slots x slot capacity``, minus a configurable
  ``kv_reserve_ratio`` held back for decode growth). ``whole``
  admission commits the full ``prompt_len + max_new_tokens`` need up
  front; ``partial`` admits on the prompt footprint alone and grows the
  commitment per tick — the optimistic fallback under pressure,
  reconciled by preemption when the pool overcommits.
* **Queue policies**: ``fifo`` (priority, then submission order — pure
  FIFO at equal priority, head-of-line blocking included) and
  ``deadline`` (earliest absolute deadline first). Requests that can
  never fit are REJECTED gracefully at submit; requests whose
  ``deadline_ticks`` elapse — waiting or mid-decode — are EXPIRED and
  returned with their partial output, never silently starved.
* **Preemption**: when the budget overcommits (partial admission) or a
  strictly-higher-priority request cannot be admitted, the
  lowest-priority most-recently-admitted victim is evicted back to
  waiting. Eviction snapshots the slot's exact KV rows; re-admission
  restores them byte-for-byte, so a preempted request's generation is
  bit-identical to an undisturbed run. The reconcile loop never evicts
  the last running request, so an over-subscribed load always makes
  forward progress — no deadlocks by construction.
* **Streaming**: every emitted token fires the request's ``on_token``
  callback in order; :meth:`RequestScheduler.stream` wraps
  submit-and-step into a per-request token iterator.
* **Typed stats**: :meth:`RequestScheduler.stats` returns one frozen
  :class:`SchedulerStats` snapshot (admission latency, queue depth,
  ticks-to-first-token, rejections, expirations, preemptions, KV
  commitment) — the serving engine nests it inside its
  :class:`~repro_torch.serving.engine.ServingStats`.

The scheduler drives a *slot pool* — any object exposing the small
executor surface :class:`ServingEngine` implements (``n_slots`` /
``slot_capacity`` / ``acquire_slot`` / ``release_slot`` /
``prefill_into`` / ``decode_tick`` / ``slot_exhausted`` /
``evict_slot`` / ``restore_slot``). The invariant, tested in
tests/test_scheduler.py: for any policy, budget, admission mode and
preemption pattern, every request's generated tokens are byte-identical
to running it alone.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable

import numpy as np

from repro_torch import obs

POLICIES = ("fifo", "deadline")
ADMISSION_MODES = ("whole", "partial")


class SchedulerConfigError(ValueError):
    """An inconsistent :class:`SchedulerConfig`."""


class RequestRejectedError(RuntimeError):
    """A streamed request was rejected at admission control."""


class SchedulerExhaustedError(RuntimeError):
    """``drain()`` hit its tick cap with requests still in flight."""


class DegradedServiceError(RuntimeError):
    """A streamed request FAILED because the service degraded (fault
    tolerance out of moves: spare tiles exhausted / remap budget spent).
    Individual requests fail with this named error — the engine object
    itself stays alive and keeps rejecting new work gracefully."""


class RequestStatus(enum.Enum):
    WAITING = "waiting"        # queued, not yet admitted
    RUNNING = "running"        # holds a slot, decoding
    PREEMPTED = "preempted"    # evicted back to waiting, KV snapshotted
    FINISHED = "finished"      # hit its token budget (or cache capacity)
    REJECTED = "rejected"      # graceful admission-control rejection
    EXPIRED = "expired"        # deadline_ticks elapsed before finishing
    FAILED = "failed"          # service degraded with the request in flight


TERMINAL = (
    RequestStatus.FINISHED,
    RequestStatus.REJECTED,
    RequestStatus.EXPIRED,
    RequestStatus.FAILED,
)


@dataclasses.dataclass(frozen=True)
class PrefixGraft:
    """Cached KV rows for a shared prompt prefix (PR 10 fleet routing).

    ``rows`` is a prefill-shaped cache pytree with the batch axis
    squeezed (attention KV leaves ``(R, L, KV, D)``) covering at least
    the first ``length`` prompt positions, taken from an earlier
    prefill of a prompt sharing those tokens. A pool that supports
    continuation (:meth:`ServingEngine.supports_prefix_graft`) admits
    the request by prefilling only the suffix — bit-identical to a full
    prefill, by the ``prefill_continue`` invariant. ``length`` must be
    strictly below the prompt length: the last prompt position always
    computes fresh logits for the first emitted token.
    """

    length: int
    rows: Any


@dataclasses.dataclass(frozen=True, eq=False)
class Request:
    """One immutable client submission.

    Progress (generated tokens, status, timing) is NOT here — it lives
    in the :class:`RequestState` that ``submit`` returns, so a request
    object can be re-submitted or compared without aliasing mutable
    state (the pre-scheduler ``Request`` mixed both).
    """

    rid: int
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int
    priority: int = 0                   # higher = more important
    deadline_ticks: int | None = None   # SLO: ticks from submit to finish
    on_token: Callable[[int, int, int], None] | None = None
    # on_token(rid, token, index) — fired per emitted token, in order
    prefix: PrefixGraft | None = None   # shared-prefix KV to graft at
    #                                     admission (fleet router affinity
    #                                     hit); pools without continuation
    #                                     support ignore it

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    def kv_need(self, slot_capacity: int) -> int:
        """Cache rows a full run writes: the prompt plus one row per
        decode tick (``max_new_tokens - 1`` of them), clamped to the
        slot — beyond it the engine finishes the request early."""
        return min(self.prompt_len + self.max_new_tokens - 1, slot_capacity)


@dataclasses.dataclass(frozen=True)
class SlotSnapshot:
    """A preempted request's exact execution state: the slot's KV/state
    rows plus position and last token. Restoring it into any free slot
    resumes decode bit-identically."""

    pos: int
    tok: int
    rows: Any       # pytree of per-slot cache rows (device arrays)
    tick: int = -1  # pool tick the snapshot was taken at (fault-tolerance
    #                 watermark: snapshots older than the last probe-clean
    #                 tick are trusted across a remap; newer ones restart)


@dataclasses.dataclass
class RequestState:
    """The mutable half of a request: progress, status, timing."""

    request: Request
    seq: int                             # global submission order
    submit_tick: int
    status: RequestStatus = RequestStatus.WAITING
    generated: list[int] = dataclasses.field(default_factory=list)
    committed: int = 0                   # KV tokens held against the budget
    admitted_tick: int | None = None     # first admission
    first_token_tick: int | None = None
    finish_tick: int | None = None
    preemptions: int = 0
    reject_reason: str | None = None
    fail_reason: str | None = None
    snapshot: SlotSnapshot | None = None

    # -- convenience views ---------------------------------------------------
    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        return self.status is RequestStatus.FINISHED

    @property
    def latency_ticks(self) -> int | None:
        """End-to-end ticks from submit to the terminal status (None
        while in flight) — the fleet router's per-replica load signal."""
        if self.finish_tick is None:
            return None
        return self.finish_tick - self.submit_tick

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL

    def emit(self, token: int) -> None:
        """Record one generated token and stream it to the client."""
        self.generated.append(int(token))
        if self.request.on_token is not None:
            self.request.on_token(self.rid, int(token), len(self.generated) - 1)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Every scheduling knob, validated eagerly.

    * ``policy`` — waiting-queue order: ``fifo`` (priority then
      submission order) or ``deadline`` (earliest absolute deadline
      first, then priority).
    * ``admission`` — ``whole`` commits a request's full KV need at
      admission (never preempted for budget); ``partial`` admits on the
      prompt footprint and grows per tick, preempting the youngest
      lowest-priority request when the pool overcommits.
    * ``kv_reserve_ratio`` — fraction of the KV-token budget held back
      from admission (headroom for decode growth / prefix reuse).
    * ``max_waiting`` — queue-depth cap; submissions beyond it are
      REJECTED instead of growing the queue without bound.
    * ``preempt`` — allow priority/budget preemption at all. With
      ``False``, over-budget partial pools simply stop admitting.
    """

    policy: str = "fifo"
    admission: str = "whole"
    kv_reserve_ratio: float = 0.0
    max_waiting: int | None = None
    preempt: bool = True

    def validate(self) -> "SchedulerConfig":
        if self.policy not in POLICIES:
            raise SchedulerConfigError(
                f"unknown scheduling policy {self.policy!r}; "
                f"known: {', '.join(POLICIES)}"
            )
        if self.admission not in ADMISSION_MODES:
            raise SchedulerConfigError(
                f"unknown admission mode {self.admission!r}; "
                f"known: {', '.join(ADMISSION_MODES)}"
            )
        if not 0.0 <= self.kv_reserve_ratio <= 1.0:
            raise SchedulerConfigError(
                f"kv_reserve_ratio must be in [0, 1], got {self.kv_reserve_ratio}"
            )
        if self.max_waiting is not None and self.max_waiting < 1:
            raise SchedulerConfigError(
                f"max_waiting must be >= 1 (or None for unbounded), "
                f"got {self.max_waiting}"
            )
        return self


@dataclasses.dataclass(frozen=True)
class SchedulerStats:
    """One frozen snapshot of the scheduler's counters."""

    policy: str
    admission: str
    submitted: int
    admitted: int               # admissions incl. resumptions
    finished: int
    rejected: int
    expired: int
    preempted: int
    resumed: int
    failed: int                 # FAILED by service degradation
    restarted: int              # requeued-from-scratch after fault remaps
    degraded_reason: str | None  # non-None once the service degraded
    queue_depth: int            # waiting now
    running: int                # slots held now
    max_queue_depth: int
    kv_budget: int              # pool slots x slot capacity (tokens)
    kv_usable: int              # budget minus the reserve
    kv_committed: int           # tokens held by running requests now
    admission_wait_ticks: float  # mean ticks from submit to first admission
    ticks_to_first_token: float  # mean ticks from submit to first output
    request_latency_ticks: float  # mean submit->FINISHED ticks (end to end)


class RequestScheduler:
    """Waiting/running queues + admission control over a slot pool.

    ``submit(request) -> RequestState`` enqueues (or gracefully
    rejects); ``step()`` runs one tick — expire deadlines, admit per
    policy and budget, reconcile over-commitment, one grouped decode —
    and returns the states that reached a terminal status this tick;
    ``drain()`` steps until idle. ``stats()`` snapshots the counters.
    """

    def __init__(self, pool, config: SchedulerConfig | None = None):
        self.pool = pool
        self.config = (config or SchedulerConfig()).validate()
        self.waiting: list[RequestState] = []
        self.running: dict[int, RequestState] = {}   # slot -> state
        self.tick_count = 0
        self._seq = 0
        self._counts = {
            "submitted": 0, "admitted": 0, "finished": 0, "rejected": 0,
            "expired": 0, "preempted": 0, "resumed": 0, "failed": 0,
            "restarted": 0,
        }
        # fault tolerance: set by degrade() — new submissions are then
        # rejected with this reason; terminal states produced OUTSIDE
        # step() (degrade mid-tick) queue here until the next step()
        self.degraded_reason: str | None = None
        self._async_terminal: list[RequestState] = []
        self._max_queue_depth = 0
        self._wait_ticks = [0, 0.0]   # [n admitted, total submit->admit ticks]
        self._ttft = [0, 0.0]         # [n first tokens, total ticks]
        self._latency = [0, 0.0]      # [n finished, total submit->finish ticks]

    # -- budget -------------------------------------------------------------

    @property
    def kv_budget(self) -> int:
        """The pool's total KV capacity in cache tokens."""
        return self.pool.n_slots * self.pool.slot_capacity

    @property
    def kv_usable(self) -> int:
        """Budget minus the configured reserve."""
        return int(self.kv_budget * (1.0 - self.config.kv_reserve_ratio))

    def kv_committed(self) -> int:
        return sum(st.committed for st in self.running.values())

    def _need(self, st: RequestState) -> int:
        """KV tokens an admission of ``st`` commits right now."""
        req = st.request
        full = req.kv_need(self.pool.slot_capacity)
        if self.config.admission == "whole":
            return full
        # partial: rows already written (prompt + generated-1) + one
        # tick of growth headroom — grows as the request decodes
        return min(req.prompt_len + max(len(st.generated), 1), full)

    # -- client API ---------------------------------------------------------

    def submit(self, request: Request) -> RequestState:
        """Enqueue a request; returns its state (possibly REJECTED)."""
        st = RequestState(
            request=request, seq=self._seq, submit_tick=self.tick_count
        )
        self._seq += 1
        self._counts["submitted"] += 1
        obs.event(
            "request.submit", track="sched", rid=request.rid,
            prompt_len=request.prompt_len,
            max_new_tokens=request.max_new_tokens, tick=self.tick_count,
        )
        obs.count("repro_requests_submitted_total", 1, "client submissions")
        reason = self._rejection_reason(request)
        if reason is not None:
            st.status = RequestStatus.REJECTED
            st.reject_reason = reason
            st.finish_tick = self.tick_count
            self._counts["rejected"] += 1
            obs.event(
                "request.reject", track="sched", rid=request.rid,
                reason=reason, tick=self.tick_count,
            )
            obs.count(
                "repro_requests_terminal_total", 1,
                "requests reaching a terminal status", status="rejected",
            )
            return st
        self.waiting.append(st)
        self._max_queue_depth = max(self._max_queue_depth, len(self.waiting))
        return st

    def _rejection_reason(self, req: Request) -> str | None:
        if self.degraded_reason is not None:
            return f"service degraded: {self.degraded_reason}"
        if req.max_new_tokens < 1:
            return f"max_new_tokens must be >= 1, got {req.max_new_tokens}"
        if req.prompt_len + 1 > self.pool.slot_capacity:
            return (
                f"prompt of {req.prompt_len} tokens cannot decode in a "
                f"{self.pool.slot_capacity}-token slot"
            )
        min_need = (
            req.kv_need(self.pool.slot_capacity)
            if self.config.admission == "whole"
            else req.prompt_len + 1
        )
        if min_need > self.kv_usable:
            return (
                f"KV need of {min_need} tokens exceeds the usable budget "
                f"({self.kv_usable} of {self.kv_budget} after "
                f"reserve={self.config.kv_reserve_ratio})"
            )
        if (
            self.config.max_waiting is not None
            and len(self.waiting) >= self.config.max_waiting
        ):
            return f"waiting queue full (max_waiting={self.config.max_waiting})"
        return None

    def idle(self) -> bool:
        return not self.waiting and not self.running

    def step(self) -> list[RequestState]:
        """One scheduling tick, inside the ``scheduler.step`` profiler range.
        Returns states that became terminal."""
        with obs.range("scheduler.step"):
            out = list(self._async_terminal)
            self._async_terminal.clear()
            out += self._expire()
            self._admit()
            if self.config.admission == "partial":
                self._reconcile_budget()
            if obs.enabled():
                obs.gauge_set(
                    "repro_queue_depth", len(self.waiting),
                    "requests waiting after this tick's admissions",
                )
                obs.gauge_set(
                    "repro_running_slots", len(self.running), "slots held now"
                )
                obs.gauge_set(
                    "repro_kv_committed_tokens", self.kv_committed(),
                    "KV tokens held by running requests",
                )
                obs.observe(
                    "repro_queue_depth_ticks", len(self.waiting),
                    "waiting-queue depth sampled per tick",
                    buckets=obs.TICK_BUCKETS,
                )
            # a 1-token request is satisfied by its prefill alone — collect
            # it before the decode so it neither burns a lane nor overshoots
            out.extend(self._collect_finished())
            if self.running:
                self.pool.decode_tick(self.running)
                for st in self.running.values():
                    if self.config.admission == "partial":
                        st.committed = self._need(st)
            # first-token bookkeeping BEFORE collecting finished: a request
            # that finishes in its admission tick still has a TTFT
            for st in self.running.values():
                if st.first_token_tick is None and st.generated:
                    st.first_token_tick = self.tick_count
                    self._ttft[0] += 1
                    self._ttft[1] += self.tick_count - st.submit_tick
                    obs.observe(
                        "repro_ttft_ticks", self.tick_count - st.submit_tick,
                        "ticks from submit to first output token",
                        buckets=obs.TICK_BUCKETS,
                    )
            out.extend(self._collect_finished())
            self.tick_count += 1
            return out

    def drain(self, max_ticks: int = 10_000) -> list[RequestState]:
        """Step until idle; raises :class:`SchedulerExhaustedError`
        (with queue-depth and budget context) on tick exhaustion."""
        if max_ticks < 1:
            raise ValueError(
                f"max_ticks must be >= 1 (the drain safety bound), "
                f"got {max_ticks}"
            )
        out: list[RequestState] = []
        for _ in range(max_ticks):
            if self.idle():
                return out
            out += self.step()
        if self.idle():
            return out
        stuck = [st.rid for st in self.waiting] + [
            st.rid for st in self.running.values()
        ]
        raise SchedulerExhaustedError(
            f"scheduler did not drain after {max_ticks} ticks; undrained "
            f"request ids: {stuck} (queue_depth={len(self.waiting)}, "
            f"running={len(self.running)}, kv_committed={self.kv_committed()}"
            f"/{self.kv_usable} usable of {self.kv_budget} budget, "
            f"policy={self.config.policy}, admission={self.config.admission})"
        )

    def stream(self, request: Request):
        """Submit and iterate the request's tokens as they decode.

        Drives ``step()`` under the hood (other in-flight requests make
        progress too); raises :class:`RequestRejectedError` if admission
        control rejects, and stops when the request reaches a terminal
        state (EXPIRED streams end after the partial output).
        """
        st = self.submit(request)
        if st.status is RequestStatus.REJECTED:
            raise RequestRejectedError(
                f"request {request.rid} rejected: {st.reject_reason}"
            )
        sent = 0
        while not st.terminal:
            self.step()
            while sent < len(st.generated):
                yield st.generated[sent]
                sent += 1
        if st.status is RequestStatus.FAILED:
            raise DegradedServiceError(
                f"request {request.rid} failed: {st.fail_reason}"
            )
        while sent < len(st.generated):
            yield st.generated[sent]
            sent += 1

    def adopt(
        self,
        request: Request,
        *,
        generated: "list[int] | tuple[int, ...]" = (),
        snapshot: SlotSnapshot | None = None,
    ) -> RequestState:
        """Enqueue a request that already made progress elsewhere — the
        fleet failover path (PR 10): a healthy replica adopts a request
        off a degraded one, carrying the tokens it already streamed and
        (when the source's clean-tick watermark trusts it) the KV
        snapshot to resume from. With a snapshot, admission restores the
        rows instead of prefilling and decode continues bit-exactly;
        without one the request re-prefills and regenerates the same
        tokens from scratch. Carried tokens do NOT re-fire ``on_token``
        (the client already received them)."""
        st = self.submit(request)
        if st.status is RequestStatus.REJECTED:
            return st
        if generated:
            st.generated = list(generated)
        if snapshot is not None:
            st.snapshot = snapshot
        return st

    def pending_terminal(self) -> bool:
        """Terminal states produced outside ``step()`` (mid-tick
        degrade) waiting to be surfaced by the next ``step()``."""
        return bool(self._async_terminal)

    def stats(self) -> SchedulerStats:
        c = self._counts
        return SchedulerStats(
            policy=self.config.policy,
            admission=self.config.admission,
            submitted=c["submitted"],
            admitted=c["admitted"],
            finished=c["finished"],
            rejected=c["rejected"],
            expired=c["expired"],
            preempted=c["preempted"],
            resumed=c["resumed"],
            failed=c["failed"],
            restarted=c["restarted"],
            degraded_reason=self.degraded_reason,
            queue_depth=len(self.waiting),
            running=len(self.running),
            max_queue_depth=self._max_queue_depth,
            kv_budget=self.kv_budget,
            kv_usable=self.kv_usable,
            kv_committed=self.kv_committed(),
            admission_wait_ticks=(
                self._wait_ticks[1] / self._wait_ticks[0]
                if self._wait_ticks[0] else 0.0
            ),
            ticks_to_first_token=(
                self._ttft[1] / self._ttft[0] if self._ttft[0] else 0.0
            ),
            request_latency_ticks=(
                self._latency[1] / self._latency[0] if self._latency[0] else 0.0
            ),
        )

    # -- fault tolerance (PR 9) ----------------------------------------------

    def restart_in_flight(self, *, clean_before: int = -1, reason: str = "fault") -> int:
        """Requeue every in-flight request whose state may carry
        corrupted output after a fault + remap.

        Preemption snapshots taken at or before ``clean_before`` (the
        health monitor's last probe-clean pool tick) are trusted and
        resume bit-exactly; everything running now, and every snapshot
        newer than the watermark, restarts from scratch (cleared output,
        fresh prefill). ``first_token_tick`` is kept so TTFT is not
        double-counted. Returns the number of requests reset."""
        n = 0
        for slot, st in list(self.running.items()):
            del self.running[slot]
            self.pool.release_slot(slot)
            self._reset(st)
            self.waiting.append(st)
            n += 1
        for st in self.waiting:
            if st.snapshot is not None and st.snapshot.tick > clean_before:
                self._reset(st)
                n += 1
        if n:
            self._counts["restarted"] += n
            self._max_queue_depth = max(self._max_queue_depth, len(self.waiting))
            obs.event(
                "request.restart", track="sched", n=n, reason=reason,
                clean_before=clean_before, tick=self.tick_count,
            )
        return n

    def _reset(self, st: RequestState) -> None:
        """Back to square one: WAITING, no output, no snapshot (the
        request re-prefills on next admission)."""
        st.status = RequestStatus.WAITING
        st.generated.clear()
        st.committed = 0
        st.snapshot = None

    def degrade(self, reason: str) -> list[RequestState]:
        """Graceful degradation: FAIL every in-flight and queued request
        with a named reason and reject all future submissions. The pool
        and scheduler objects stay alive — callers observe
        :class:`DegradedServiceError` per request, never a dead engine."""
        self.degraded_reason = reason
        out: list[RequestState] = []
        for slot, st in list(self.running.items()):
            del self.running[slot]
            self.pool.release_slot(slot)
            out.append(self._terminate(st, RequestStatus.FAILED, reason))
        for st in list(self.waiting):
            self.waiting.remove(st)
            out.append(self._terminate(st, RequestStatus.FAILED, reason))
        self._async_terminal.extend(out)
        return out

    # -- scheduling internals ------------------------------------------------

    def _order_key(self, st: RequestState):
        req = st.request
        if self.config.policy == "deadline":
            deadline = (
                st.submit_tick + req.deadline_ticks
                if req.deadline_ticks is not None else math.inf
            )
            return (deadline, -req.priority, st.seq)
        return (-req.priority, st.seq)

    def _expire(self) -> list[RequestState]:
        """Time out waiting AND running requests past their SLO."""
        out = []
        for st in list(self.waiting):
            dl = st.request.deadline_ticks
            if dl is not None and self.tick_count - st.submit_tick >= dl:
                self.waiting.remove(st)
                out.append(self._terminate(st, RequestStatus.EXPIRED))
        for slot, st in list(self.running.items()):
            dl = st.request.deadline_ticks
            if dl is not None and self.tick_count - st.submit_tick >= dl:
                del self.running[slot]
                self.pool.release_slot(slot)
                out.append(self._terminate(st, RequestStatus.EXPIRED))
        return out

    def _terminate(
        self, st: RequestState, status: RequestStatus, reason: str | None = None
    ) -> RequestState:
        st.status = status
        st.finish_tick = self.tick_count
        st.committed = 0
        if status is not RequestStatus.FAILED:
            # FAILED keeps its preemption snapshot: a fleet pool salvages
            # clean-watermark snapshots off a degraded replica (PR 10)
            st.snapshot = None
        latency = self.tick_count - st.submit_tick
        if status is RequestStatus.FINISHED:
            self._latency[0] += 1
            self._latency[1] += latency
        obs.observe(
            "repro_request_latency_ticks", latency,
            "ticks from submit to a terminal status (end-to-end latency)",
            buckets=obs.TICK_BUCKETS, status=status.value,
        )
        key = {
            RequestStatus.FINISHED: "finished",
            RequestStatus.EXPIRED: "expired",
            RequestStatus.FAILED: "failed",
        }[status]
        if status is RequestStatus.FAILED:
            st.fail_reason = reason
        self._counts[key] += 1
        event = {
            "finished": "request.finish",
            "expired": "request.expire",
            "failed": "request.fail",
        }[key]
        obs.event(
            event, track="sched", rid=st.rid, tick=self.tick_count,
            n_generated=len(st.generated),
        )
        obs.count(
            "repro_requests_terminal_total", 1,
            "requests reaching a terminal status", status=status.value,
        )
        return st

    def _admit(self) -> None:
        """Move waiting requests into slots, strictly in policy order.

        Head-of-line blocking is intentional (FIFO semantics): when the
        head cannot be admitted — no slot, no budget, no preemptable
        victim — admission stops for the tick rather than admitting a
        later (smaller) request past it.
        """
        while self.waiting:
            # re-sorted every iteration: preemption inside _make_room
            # re-queues victims, which must take their policy position
            self.waiting.sort(key=self._order_key)
            st = self.waiting[0]
            need = self._need(st)
            if not self._make_room(st, need):
                return
            slot = self.pool.acquire_slot()
            self.waiting.pop(0)
            st.committed = need
            st.status = RequestStatus.RUNNING
            self._counts["admitted"] += 1
            if st.admitted_tick is None:
                st.admitted_tick = self.tick_count
                self._wait_ticks[0] += 1
                self._wait_ticks[1] += self.tick_count - st.submit_tick
                obs.observe(
                    "repro_admission_wait_ticks",
                    self.tick_count - st.submit_tick,
                    "ticks from submit to first admission",
                    buckets=obs.TICK_BUCKETS,
                )
            if st.snapshot is not None:
                self.pool.restore_slot(slot, st.snapshot)
                st.snapshot = None
                self._counts["resumed"] += 1
                obs.event(
                    "request.resume", track="sched", rid=st.rid,
                    slot=slot, tick=self.tick_count,
                )
            else:
                obs.event(
                    "request.admit", track="sched", rid=st.rid,
                    slot=slot, committed=need, tick=self.tick_count,
                )
                self.pool.prefill_into(slot, st)
            self.running[slot] = st

    def _make_room(self, st: RequestState, need: int) -> bool:
        """Free a slot and budget for ``st``, preempting strictly-lower
        priority victims when allowed. True when admission can proceed."""
        def fits() -> bool:
            return (
                self.pool.free_slots > 0
                and self.kv_committed() + need <= self.kv_usable
            )

        while not fits():
            if not self.config.preempt:
                return False
            victim = self._victim(max_priority=st.request.priority)
            if victim is None:
                return False
            self._preempt(victim)
        return True

    def _victim(self, max_priority: int | None = None) -> int | None:
        """The slot to evict: lowest priority, most recently admitted.
        ``max_priority`` restricts to strictly lower priorities (priority
        preemption must not evict a peer)."""
        candidates = [
            (st.request.priority, -(st.admitted_tick or 0), -st.seq, slot)
            for slot, st in self.running.items()
            if max_priority is None or st.request.priority < max_priority
        ]
        if not candidates:
            return None
        return min(candidates)[3]

    def _preempt(self, slot: int) -> None:
        """Evict one running request back to waiting, KV snapshotted."""
        st = self.running.pop(slot)
        st.snapshot = self.pool.evict_slot(slot)
        st.status = RequestStatus.PREEMPTED
        st.preemptions += 1
        st.committed = 0
        self._counts["preempted"] += 1
        obs.event(
            "request.preempt", track="sched", rid=st.rid,
            slot=slot, tick=self.tick_count,
        )
        obs.count("repro_preemptions_total", 1, "slots evicted back to waiting")
        self.waiting.append(st)
        self._max_queue_depth = max(self._max_queue_depth, len(self.waiting))

    def _reconcile_budget(self) -> None:
        """Partial admission grew past the budget: evict the youngest
        lowest-priority requests until within it. The LAST running
        request is never evicted, so the pool always makes forward
        progress (no deadlock, no preemption livelock)."""
        while self.kv_committed() > self.kv_usable and len(self.running) > 1:
            victim = self._victim()
            if victim is None:  # pragma: no cover - all priorities equal
                return
            self._preempt(victim)

    def _collect_finished(self) -> list[RequestState]:
        out = []
        for slot, st in list(self.running.items()):
            req = st.request
            out_of_budget = len(st.generated) >= req.max_new_tokens
            out_of_cache = self.pool.slot_exhausted(slot)
            if out_of_budget or out_of_cache:
                del self.running[slot]
                self.pool.release_slot(slot)
                out.append(self._terminate(st, RequestStatus.FINISHED))
        return out

"""Scheduler-fronted continuous-batching serving engine (counterpart of
``repro/serving/engine.py``: the slot pool and its K-group decode).

* :class:`ServingEngine` is the **slot pool executor** over a
  :class:`repro_torch.compiler.CompiledModel`: KV caches allocated once
  at (max_batch, max_len), requests claim a free slot, prefill writes
  their prompt KV into it, decode advances the active slots with
  per-slot positions, finished slots are freed and reused.
* :class:`repro_torch.serving.scheduler.RequestScheduler` is the
  request path in front of it (queues, KV budget, SLOs, preemption);
  ``submit`` / ``step`` / ``drain`` / ``stream`` delegate to it.

Each tick the :class:`BatchPlanner` groups the active slots into
K-groups (ragged tails repeat a real slot) and the engine runs one
gather -> decode -> scatter over them. The caches are preallocated
tensors updated IN PLACE: the decode writes its new K/V rows into the
gathered rows (or straight into the pool when every slot is active) and
the scatter copies them back -- where the reference donates its cache
buffers to XLA to the same end. Evicting a slot copies its exact cache
rows out; restoring them into any free slot resumes greedy decode
bit-identically.

The invariant, as in the reference: any interleaving of submissions,
any group size, any engine, any preemption pattern and telemetry on or
off produce the same generations as running each request alone.

With a telemetry session active (:mod:`repro_torch.obs`), each prefill
records a ``prefill`` span and each tick a ``decode_tick`` span on the
``serve`` track, both fenced on the caches (so they end after the device
work), plus the reference's latency histograms and counters; with
telemetry off a tick pays one ``None`` check and no device
synchronization beyond its own.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.faults import FaultyEngine, HealthMonitor
from repro_torch.models import lm as lm_lib
from repro_torch.serving.scheduler import (
    Request,
    RequestScheduler,
    RequestState,
    SchedulerConfig,
    SchedulerStats,
    SlotSnapshot,
)


@dataclasses.dataclass(frozen=True)
class ServingStats:
    """One frozen snapshot of the serving engine's counters."""

    ticks: int                  # gathered decode launches
    decoded: int                # real slot-tokens decoded
    mmm_groups: int             # K-groups issued to a registry backend
    pad_lanes: int              # idle lanes from ragged tails
    prefills: int
    prefill_tokens: int         # prompt tokens actually prefilled
    grafted_tokens: int         # prompt tokens elided by prefix grafts
    evictions: int              # preemption snapshots taken
    restores: int               # snapshots restored into a slot
    programmed: int             # projections made resident in compile()
    program_s: float            # one-time programming wall time
    scheduler: SchedulerStats
    caches: dict[str, dict[str, int]]   # backend cache counters ({} on the plain path)


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One tick's unit of work: active slots arranged into K-groups."""

    slots: tuple[int, ...]        # real active slots, in slot order
    k: int                        # group size

    @property
    def n_active(self) -> int:
        return len(self.slots)

    @property
    def n_groups(self) -> int:
        return math.ceil(self.n_active / self.k)

    @property
    def n_lanes(self) -> int:
        return self.n_groups * self.k

    @property
    def n_pad(self) -> int:
        """Idle lanes in the ragged tail carrying no slot."""
        return self.n_lanes - self.n_active

    def gather_indices(self) -> np.ndarray:
        """(n_lanes,) slot indices for the gathered decode batch; the
        ragged tail repeats the last real slot (outputs discarded)."""
        idx = np.empty((self.n_lanes,), np.int64)
        idx[: self.n_active] = self.slots
        idx[self.n_active:] = self.slots[-1]
        return idx


class BatchPlanner:
    """Collects active slots into K-groups each tick: ceil(active/K)
    groups, ragged tail padded, or ``None`` when nothing is active."""

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"group size must be >= 1, got {k}")
        self.k = int(k)

    def plan(self, active_slots: list[int]) -> GroupPlan | None:
        if not active_slots:
            return None
        return GroupPlan(slots=tuple(sorted(active_slots)), k=self.k)


class ServingEngine:
    """Slot-pool executor + scheduler front over a ``CompiledModel``
    (construct with ``compile(cfg, params, target).serve()``)."""

    def __init__(
        self,
        compiled,
        *,
        max_batch: int = 4,
        max_len: int = 256,
        scheduler: SchedulerConfig | None = None,
    ):
        self.compiled = compiled
        self.device = compiled.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.engine_name = compiled.target.engine
        self.group_k = compiled.group_size_for(max_batch)
        self.planner = BatchPlanner(self.group_k)
        self._exec = compiled.executor(max_batch)
        self._counts = {
            "ticks": 0, "decoded": 0, "mmm_groups": 0, "pad_lanes": 0,
            "prefills": 0, "prefill_tokens": 0, "grafted_tokens": 0,
            "evictions": 0, "restores": 0,
        }
        cfg = compiled.cfg
        # prefix grafting: a continuation prefill slices cached KV at a
        # token boundary, which only attention mixers support (and only
        # the token-prompt path can hash)
        self.supports_prefix_graft = (
            all(kind.mixer == "attn" for kind in cfg.pattern) and cfg.frontend != "vision"
        )
        # fleet hooks: `prefill_observer(state, prompt_rows)` is called
        # after every prefill with the prompt's batch-squeezed cache rows
        # (the router's prefix-library feed); `on_degrade(reason)` fires
        # when the health monitor degrades this engine
        self.prefill_observer = None
        self.on_degrade = None
        self.caches = compiled.init_cache(max_batch, max_len)
        self.pos = np.zeros((max_batch,), np.int64)        # next write position
        self.tok = np.zeros((max_batch,), np.int64)        # last emitted token
        self._free = set(range(max_batch))
        self.scheduler = RequestScheduler(self, scheduler)
        # fault tolerance: a fault-injecting backend gets a health
        # monitor (sampled consistency sweeps, quarantine + remap, K
        # shrink on dead lanes, graceful degradation)
        self.health = HealthMonitor(self) if isinstance(compiled.engine, FaultyEngine) else None

    def _rebind(self) -> None:
        """Resynchronize with the compiled model after it changed under
        us (a fault remap re-placed the plan, dead lanes shrank K): a new
        K, planner and executor. The prefill and decode entry points read
        the compiled model's refreshed params on every call."""
        self.group_k = self.compiled.group_size_for(self.max_batch)
        self.planner = BatchPlanner(self.group_k)
        self._exec = self.compiled.executor(self.max_batch)

    # -- client API (delegates to the request scheduler) ---------------------

    def submit(self, request: Request) -> RequestState:
        """Enqueue a request; returns its (possibly REJECTED) state."""
        return self.scheduler.submit(request)

    def step(self) -> list[RequestState]:
        """One scheduling tick; returns newly terminal states."""
        return self.scheduler.step()

    def drain(self, max_ticks: int = 10_000) -> list[RequestState]:
        """Step until idle (``SchedulerExhaustedError`` on tick exhaustion)."""
        return self.scheduler.drain(max_ticks)

    def stream(self, request: Request):
        """Submit and iterate the request's tokens as they decode."""
        return self.scheduler.stream(request)

    def idle(self) -> bool:
        """True when nothing is queued or running."""
        return self.scheduler.idle()

    def stats(self) -> ServingStats:
        backend = self._exec.cache_stats() if self._exec is not None else {}
        return ServingStats(
            **self._counts,
            programmed=self.compiled.programmed,
            program_s=self.compiled.program_s,
            scheduler=self.scheduler.stats(),
            caches=backend,
        )

    # -- slot-pool surface (driven by RequestScheduler) ----------------------

    @property
    def n_slots(self) -> int:
        return self.max_batch

    @property
    def slot_capacity(self) -> int:
        """KV rows one slot holds — the scheduler's budget unit."""
        return self.max_len

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def acquire_slot(self) -> int:
        if not self._free:
            raise RuntimeError("no free slot (scheduler admitted past the pool)")
        slot = min(self._free)
        self._free.remove(slot)
        return slot

    def release_slot(self, slot: int) -> None:
        self.pos[slot] = 0
        self.tok[slot] = 0
        self._free.add(slot)

    @torch.no_grad()
    def prefill_into(self, slot: int, st: RequestState) -> None:
        """Prefill the request's prompt, write its caches into the slot
        (K/V rows by time prefix, Mamba conv tails and state whole) and
        emit the first (argmax) token onto the state.

        A request carrying a :class:`~repro_torch.serving.scheduler
        .PrefixGraft` (a fleet prefix-affinity hit) skips the shared
        prefix: the donated rows stand in for positions ``[0, length)``
        and only the suffix runs, through ``prefill_continue`` --
        bit-identical to the full prefill."""
        plen = st.request.prompt_len
        prompt = torch.as_tensor(np.asarray(st.request.prompt, np.int64))[None, :]
        graft = st.request.prefix
        use_graft = graft is not None and self.supports_prefix_graft and 0 < graft.length < plen
        with obs.span(
            "prefill", track="serve", engine=self.engine_name,
            slot=slot, rid=st.request.rid, prompt_len=plen,
            grafted=graft.length if use_graft else 0,
        ) as sp:
            if use_graft:
                pre_rows = {
                    name: {key: r[:, None, : graft.length].to(self.device)
                           for key, r in kv.items()}
                    for name, kv in graft.rows.items()
                }
                logits, pre = self.compiled.prefill_continue(prompt[:, graft.length:], pre_rows)
                self._counts["grafted_tokens"] += graft.length
                self._counts["prefill_tokens"] += plen - graft.length
            else:
                logits, pre = self.compiled.prefill(prompt)
                self._counts["prefill_tokens"] += plen
            for name, kv in pre.items():
                for key, src in kv.items():
                    lm_lib.graft_cache_(self.caches[name][key][:, slot : slot + 1], src, key)
            st.emit(int(torch.argmax(logits[0])))
            sp.fence(self.caches)
        self.pos[slot] = plen
        self.tok[slot] = st.generated[-1]
        self._counts["prefills"] += 1
        if self.prefill_observer is not None:
            # full-prompt rows either way (a continuation returns prefix
            # + suffix), so the prefix library extends its chains from
            # grafted admissions too
            self.prefill_observer(
                st, {name: {key: c[:, 0] for key, c in kv.items()} for name, kv in pre.items()}
            )
        if obs.enabled():
            obs.observe(
                "repro_prefill_latency_seconds", sp.duration_s,
                "prompt prefill wall time (graft fenced)",
                engine=self.engine_name,
            )
            obs.count(
                "repro_prefills_total", 1, "prompt prefills run",
                engine=self.engine_name,
            )

    def slot_exhausted(self, slot: int) -> bool:
        """True when the next decode write would run off the slot."""
        return self.pos[slot] + 1 >= self.max_len

    @torch.no_grad()
    def evict_slot(self, slot: int) -> SlotSnapshot:
        """Copy the slot's exact cache rows (new tensors) out of the pool
        and free the slot."""
        rows = {
            name: {key: c[:, slot].clone() for key, c in kv.items()}
            for name, kv in self.caches.items()
        }
        snap = SlotSnapshot(
            pos=int(self.pos[slot]), tok=int(self.tok[slot]), rows=rows,
            tick=self._counts["ticks"],
        )
        self.release_slot(slot)
        self._counts["evictions"] += 1
        return snap

    @torch.no_grad()
    def restore_slot(self, slot: int, snap: SlotSnapshot) -> None:
        """Write a preemption snapshot into a (possibly different) free
        slot. The full row is restored — the stale region beyond ``pos``
        is masked by attention as for a reused slot."""
        for name, kv in snap.rows.items():
            for key, src in kv.items():
                self.caches[name][key][:, slot] = src.to(self.device)
        self.pos[slot] = snap.pos
        self.tok[slot] = snap.tok
        self._counts["restores"] += 1

    def decode_tick(self, running: dict[int, RequestState]) -> None:
        """One K-grouped decode over the running slots: plan, gather ->
        decode -> scatter, then emit each slot's token.

        With telemetry on (:mod:`repro_torch.obs`), each tick records a
        ``decode_tick`` span fenced on the caches after the scatter
        (engine, K, active/group/pad lanes, cache hit/miss deltas) plus
        the tick-latency histogram and lane counters; with telemetry off
        the tick pays one ``None`` check and no extra synchronization.
        A health monitor (fault-injecting targets) runs after the tick
        on both paths.
        """
        plan = self.planner.plan(list(running))
        if plan is None:
            return
        if not obs.enabled():
            self._run_tick(plan, running)
            if self.health is not None:
                self.health.after_tick()
            return
        before = self._cache_totals()
        with obs.span(
            "decode_tick", track="serve", engine=self.engine_name,
            k=plan.k, n_active=plan.n_active, n_groups=plan.n_groups,
            n_pad=plan.n_pad,
        ) as sp:
            self._run_tick(plan, running)
            sp.fence(self.caches)
            after = self._cache_totals()
            sp.set(
                cache_hits=after[0] - before[0],
                cache_misses=after[1] - before[1],
            )
        obs.observe(
            "repro_tick_latency_seconds", sp.duration_s,
            "K-grouped decode tick wall time (cache scatter fenced)",
            engine=self.engine_name, k=plan.k,
        )
        obs.count(
            "repro_decode_ticks_total", 1, "gathered decode launches",
            engine=self.engine_name,
        )
        obs.count(
            "repro_decoded_tokens_total", plan.n_active,
            "real slot-tokens decoded", engine=self.engine_name,
        )
        if self._exec is not None:
            obs.count(
                "repro_mmm_groups_total", plan.n_groups,
                "K-groups issued to a registry backend",
                engine=self.engine_name,
            )
        if plan.n_pad:
            obs.count(
                "repro_pad_lanes_total", plan.n_pad,
                "idle wavelengths from ragged tails",
                engine=self.engine_name,
            )
        if self.health is not None:
            self.health.after_tick()

    def _cache_totals(self) -> tuple[int, int]:
        """(hits, misses) summed over the backend's caches — the span's
        per-tick delta source (only read with telemetry on)."""
        if self._exec is None:
            return (0, 0)
        stats = self._exec.cache_stats().values()
        return (
            sum(s.get("hits", 0) for s in stats),
            sum(s.get("misses", 0) for s in stats),
        )

    def _run_tick(self, plan: GroupPlan, running: dict[int, RequestState]) -> None:
        """The tick body: gather -> decode -> scatter, counters, token
        emission."""
        idx = plan.gather_indices()
        if int(self.pos[idx].max()) >= self.max_len:
            raise RuntimeError(
                f"decode would write past the {self.max_len}-row slot "
                f"(positions {self.pos[idx].tolist()}); the scheduler's "
                "slot_exhausted check must finish such requests first"
            )
        with torch.no_grad():
            if plan.n_active == self.max_batch and plan.n_pad == 0:
                # identity plan: decode straight into the pool
                logits, _ = self.compiled.decode_step(self.tok, self.pos, self.caches)
            else:
                lanes = torch.as_tensor(idx, device=self.device)
                gathered = {
                    name: {key: c.index_select(1, lanes) for key, c in kv.items()}
                    for name, kv in self.caches.items()
                }
                logits, gathered = self.compiled.decode_step(
                    self.tok[idx], self.pos[idx], gathered
                )
                # pad lanes repeat a real slot and computed identical
                # rows, so the duplicate indices write equal values
                for name, kv in gathered.items():
                    for key, src in kv.items():
                        self.caches[name][key].index_copy_(1, lanes, src)
            nxt = torch.argmax(logits[: plan.n_active], dim=-1).cpu().numpy()
        self._counts["ticks"] += 1
        self._counts["decoded"] += plan.n_active
        if self._exec is not None:
            self._counts["mmm_groups"] += plan.n_groups
        self._counts["pad_lanes"] += plan.n_pad
        for lane, slot in enumerate(plan.slots):
            running[slot].emit(int(nxt[lane]))
            self.pos[slot] += 1
            self.tok[slot] = nxt[lane]

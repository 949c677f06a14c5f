"""``compile(cfg, params, target) -> CompiledModel`` (counterpart of
``repro/compiler/pipeline.py``: validate -> map -> resolve -> program).

1. **Validate** the target eagerly (named :class:`TargetError`\\ s —
   plan+engine mismatch, spec mismatch, K over plan capacity, an
   enc-dec config on any engine but ``reference``: enc-dec models serve
   through ``cfg.bnn_engine`` directly, ``models/encdec.py``).
2. **Map**: compile an explicit layer->tile
   :class:`~repro_torch.mapping.allocator.MappingPlan`
   (``mapping.compile_plan``) when the target names a policy, budget or
   spares, or bind a pre-compiled plan passed by the caller.
3. **Resolve** the execution backend from the registry (``tiled`` binds
   the plan) and flip the config to ``quant="bnn"`` for non-reference
   engines.
4. **Program**: the one-time crossbar write (``lm.program_weights``), so
   decode streams only activations; the MoE expert stacks and Mamba
   projections, plain bf16 products, get their bf16 copies here once.

With a telemetry session active (:mod:`repro_torch.obs`) each stage
records a span on the ``compile`` track, named as the reference's:
``compile.validate``, ``compile.map`` (with the plan's ``policy`` and
``n_tiles`` when there is one), ``compile.resolve`` and
``compile.program`` (ending after the device's programming work; with
``resident_bytes``, the port's own, where bf16 copies were made) under
the root ``compile``. The returned :class:`CompiledModel` is what every
consumer drives: ``prefill()`` / ``prefill_continue()`` /
``decode_step()`` for batch loops, ``serve()`` for a
continuous-batching ``ServingEngine``, ``price()`` for the cost model's
plan + programming + per-tick readout report and ``describe()`` for
the placement and pricing tables. ``price()`` and ``describe()`` are the
cost model's figures for an ePCM/oPCM crossbar, not times of the device
the model runs on. A target with a ``fault_model`` wraps the backend in
a :class:`~repro_torch.faults.FaultyEngine`; the compiled model then
sweeps (``scan_faults``), reprograms (``refresh_faults``) and re-places
(``remap``) its artifacts.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any

import torch

from repro_torch import obs
from repro_torch.compiler.decode_graph import DecodeGraphs
from repro_torch.compiler.target import (
    GroupSizeError,
    HardwareTarget,
    PlanEngineMismatchError,
    SpecMismatchError,
    TargetError,
)
from repro_torch.core import engine as engine_lib
from repro_torch.core.crossbar import EPCM_TILE, OPCM_TILE, CrossbarSpec
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import lm as lm_lib


def _default_spec(engine_name: str) -> CrossbarSpec:
    """The tile catalogue entry an engine defaults to (its capability row)."""
    try:
        info = engine_lib.engine_info(engine_name)
    except ValueError:
        return EPCM_TILE
    return OPCM_TILE if info.default_spec == "oPCM" else EPCM_TILE


def resolve_engine(target: HardwareTarget, cfg=None, plan=None):
    """A target's execution backend (``None`` = the plain ±1 matmul path).

    The ``tiled`` engine binds ``plan`` when given one, else places ad
    hoc under ``target.mapping_policy`` (falling back to the plan's, then
    the config's policy). A ``target.fault_model`` wraps the backend in a
    :class:`~repro_torch.faults.FaultyEngine`."""
    if target.engine in ("", "reference"):
        return None
    kw: dict[str, Any] = {}
    if target.engine == "packed":
        kw = {"fused": target.fused}
    if target.engine == "tiled":
        # ad-hoc fallback placements (projection shapes absent from the
        # plan) land under the SAME policy the plan/config reports
        policy = target.mapping_policy
        if policy is None and plan is not None:
            policy = plan.policy
        if policy is None and cfg is not None:
            policy = getattr(cfg, "mapping_policy", None)
        kw = {"plan": plan, "policy": policy or "tacitmap"}
        if target.mesh_axis is not None:
            kw["mesh_axis"] = target.mesh_axis
    base = engine_lib.get_engine(target.engine, target.spec, **kw)
    if target.fault_model is not None:
        from repro_torch.faults.engine import FaultyEngine

        base = FaultyEngine(base, target.fault_model)
    return base


def compile(cfg, params, target: HardwareTarget, *, plan=None, device=None) -> "CompiledModel":
    """Compile a model onto a hardware target: validate -> map -> resolve
    -> program, on ``device`` (default ``cuda``; ``params`` move there).
    ``params`` is a :class:`repro_torch.models.lm.LM`, or ``None`` for a
    price-only compilation (``price()``/``describe()`` work, execution
    entry points raise); a model whose parameters require grad is
    compiled from a detached copy, so training on after compile() leaves
    the compiled model as it was. ``plan`` binds a pre-compiled
    :class:`~repro_torch.mapping.allocator.MappingPlan` instead of
    compiling one from ``target.mapping_policy``."""
    dev = resolve_device(device)
    with obs.span("compile", track="compile",
                  engine=target.engine, model=getattr(cfg, "name", "?")) as root:
        cm = _compile_staged(cfg, params, target, plan, dev)
        root.set(programmed=cm.programmed, program_s=cm.program_s)
        return cm


def _compile_staged(cfg, params, target: HardwareTarget, plan, dev) -> "CompiledModel":
    with obs.span("compile.validate", track="compile"):
        target = target.validate()
        if cfg.is_encdec and target.engine != "reference":
            raise TargetError(
                f"{cfg.name}: hardware targets compile the decoder-only LM "
                "projection stack; enc-dec models serve through "
                "cfg.bnn_engine directly"
            )

    # -- map: the explicit layer->tile placement ---------------------------
    with obs.span("compile.map", track="compile") as map_span:
        plan = _map_stage(cfg, target, plan)
        if plan is not None:
            map_span.set(policy=plan.policy, n_tiles=plan.n_tiles)

    # -- resolve: registry backend + bnn config ----------------------------
    with obs.span("compile.resolve", track="compile") as res_span:
        base, cfg = _resolve_stage(cfg, target, plan)
        res_span.set(backend=base.name if base is not None else "none")

    # -- program: the one-time crossbar write ------------------------------
    programmed, program_s = 0, 0.0
    if params is not None:
        params = params.to(dev)
        if any(p.requires_grad for p in params.parameters()):
            # a model in training: hold copies, so that an optimizer step
            # after compile() moves neither the compiled model's shared
            # tensors (embedding, norms, biases, head) nor its latent ones
            params = copy.deepcopy(params).requires_grad_(False)
        if base is not None and target.prepare_weights:
            with obs.span("compile.program", track="compile") as prog_span:
                t0 = time.perf_counter()
                with torch.no_grad():
                    params, programmed = lm_lib.program_weights(params, cfg, base)
                # the span's fence, and what makes program_s device time
                # with telemetry off too
                synchronize(dev)
                program_s = time.perf_counter() - t0
                prog_span.set(programmed=programmed, program_s=program_s)
                resident = lm_lib.resident_bytes(params)
                if resident:
                    prog_span.set(resident_bytes=resident)
    return CompiledModel(
        cfg=cfg, params=params, target=target, plan=plan, engine=base,
        programmed=programmed, program_s=program_s, device=dev,
    )


def _map_stage(cfg, target: HardwareTarget, plan):
    if plan is not None:
        if target.engine != "tiled":
            raise PlanEngineMismatchError(
                f"a MappingPlan was passed but the target's engine is "
                f"{target.engine!r} — only the plan-driven 'tiled' engine "
                "executes a placement"
            )
        if target.spec is not None and plan.spec != target.spec:
            raise SpecMismatchError(
                f"plan was compiled for {plan.spec.technology} "
                f"{plan.spec.rows}x{plan.spec.cols} tiles but the target "
                f"binds {target.spec.technology} "
                f"{target.spec.rows}x{target.spec.cols} — recompile the plan "
                "on the target's spec"
            )
        # a bound plan already fixed the allocator choices; a target
        # naming different ones would be a silent knob drop
        if target.mapping_policy is not None and target.mapping_policy != plan.policy:
            raise TargetError(
                f"target names mapping_policy={target.mapping_policy!r} but "
                f"binds a plan compiled under {plan.policy!r} — drop the "
                "field or recompile the plan under the target's policy"
            )
        if target.tile_budget is not None and target.tile_budget != plan.tile_budget:
            raise TargetError(
                f"target names tile_budget={target.tile_budget} but binds a "
                f"plan compiled with tile_budget={plan.tile_budget} — drop "
                "the field or recompile the plan under the target's budget"
            )
        if target.spare_tiles and len(plan.spares) != target.spare_tiles:
            raise TargetError(
                f"target names spare_tiles={target.spare_tiles} but binds a "
                f"plan provisioning {len(plan.spares)} spare(s) — drop the "
                "field or recompile the plan with the target's spare budget"
            )
    elif target.wants_plan:
        from repro_torch.mapping import compile_plan

        plan = compile_plan(
            cfg,
            spec=target.spec or _default_spec(target.engine),
            policy=target.mapping_policy or cfg.mapping_policy or "tacitmap",
            tile_budget=target.tile_budget,
            spare_tiles=target.spare_tiles,
        )
    return plan


def _resolve_stage(cfg, target: HardwareTarget, plan):
    base = resolve_engine(target, cfg, plan)
    if base is not None:
        # a hardware backend executes the binarized projections; for
        # tiled, pin the policy so any ad-hoc fallback placement matches
        # the plan's policy
        upd: dict[str, Any] = {"quant": "bnn", "bnn_engine": target.engine}
        if target.engine == "tiled" and (target.mapping_policy or plan is not None):
            upd["mapping_policy"] = (
                target.mapping_policy if target.mapping_policy is not None else plan.policy
            )
        cfg = dataclasses.replace(cfg, **upd)

    # -- K-group capacity: reject widths the hardware cannot multiplex ----
    if target.group_size is not None:
        cap = None
        if plan is not None:
            cap, what = plan.preferred_group_size(), "the plan's placed tiles"
        elif base is not None and base.info.native_mmm:
            cap, what = base.preferred_group_size(), f"engine {base.name!r}"
        if cap is not None and target.group_size > cap:
            raise GroupSizeError(
                f"group_size={target.group_size} exceeds the WDM capacity "
                f"K={cap} of {what} — more K-groups cannot ride one "
                "crossbar step than the tile has wavelengths"
            )
    return base, cfg


@dataclasses.dataclass(frozen=True)
class RemapReport:
    """``CompiledModel.remap()``: what moved and what reprogramming cost.

    ``cost`` is a ``costmodel.ProgrammingCost`` covering only the moved
    blocks — incremental remapping's point is that untouched tiles keep
    their cells."""

    moves: tuple          # mapping.BlockMove per relocated block
    cost: Any             # costmodel.ProgrammingCost of the reprogram
    failed_tiles: frozenset[int]
    spares_left: int


@dataclasses.dataclass(frozen=True)
class TargetPrice:
    """``CompiledModel.price()``: the cost model's three seams in one
    report — plan execution, one-time programming, per-tick readout.
    Every figure is modeled for the target's ePCM/oPCM crossbar."""

    target: HardwareTarget
    design: str           # CIM design the tile spec implies
    policy: str
    n_tiles: int          # physical tiles provisioned (the area axis)
    utilization: float
    k: int                # WDM capacity of the priced tiles
    binary_steps: int
    latency_s: float      # per inference (plan schedule + edge layers)
    energy_j: float
    programming_cells: int
    programming_uj: float  # one-time PCM write energy
    programming_us: float
    tick_latency_ns: float  # one K-grouped decode tick, all binary layers
    tick_energy_pj: float
    break_even_ticks: float  # ticks until the write has paid for itself
    plan_cost: Any        # the full costmodel.PlanCost (per-layer rows)

    def summary(self) -> str:
        return (
            f"[price] {self.plan_cost.model} on {self.design} "
            f"(policy={self.policy}, {self.n_tiles} tiles, K={self.k}): "
            f"{self.latency_s * 1e6:.2f} us/inf, {self.energy_j * 1e6:.3f} uJ/inf; "
            f"program {self.programming_uj:.2f} uJ / {self.programming_us:.1f} us "
            f"(break-even {self.break_even_ticks:.0f} ticks); "
            f"tick {self.tick_latency_ns * 1e-3:.2f} us / {self.tick_energy_pj:.1f} pJ"
        )


class CompiledModel:
    """The artifact ``compile()`` returns: model + target, executable.

    * :meth:`prefill` / :meth:`prefill_continue` / :meth:`decode_step` —
      LM entry points with the target's K-grouped executor bound, each
      inside a profiler range (``model.prefill``, ``model.decode_step``);
    * :meth:`serve` — a bound continuous-batching ``ServingEngine``;
    * :meth:`price` — plan + programming + per-tick readout in one
      :class:`TargetPrice` (works without params);
    * :meth:`describe` — placement + pricing tables (``mapping.report``).

    Tensors live on :attr:`device`. ``decode_step`` writes into the
    caches it is given, in place.
    """

    def __init__(self, *, cfg, params, target, plan, engine, programmed, program_s, device):
        self.cfg = cfg
        self.params = params
        self.target = target
        self.plan = plan
        self.engine = engine          # resolved base backend (None = plain ±1 matmul)
        self.programmed = programmed  # projection instances programmed
        self.program_s = program_s    # programming wall time
        self.device = device
        self._executors: dict[int, engine_lib.GroupedEngine | None] = {}
        self.decode_graphs = DecodeGraphs()
        self._price_plan = plan

    @property
    def spec(self) -> CrossbarSpec:
        if self.engine is not None:
            return self.engine.spec
        if self.plan is not None:
            return self.plan.spec
        return self.target.spec or _default_spec(self.target.engine)

    def group_size_for(self, batch: int) -> int:
        """The K the BatchPlanner/executor uses for a ``batch``-slot pool
        (explicit target K > plan WDM capacity > engine capability > one
        group spanning the pool; clamped to the pool and, under fault
        injection, to the surviving WDM lanes)."""
        k = engine_lib.resolve_group_size(
            self.engine, self.target.group_size, batch, plan=self.plan
        )
        cap_fn = getattr(self.engine, "effective_group_cap", None)
        if callable(cap_fn):
            cap = cap_fn()
            if cap is not None:
                k = max(1, min(k, cap))
        return k

    def executor(self, batch: int):
        """The K-grouped execution adapter for a ``batch``-slot pool
        (``None`` on the plain reference path), one per K."""
        k = self.group_size_for(batch)
        if k not in self._executors:
            self._executors[k] = (
                engine_lib.GroupedEngine(self.engine, k) if self.engine is not None else None
            )
        return self._executors[k]

    def _require_params(self):
        if self.params is None:
            raise TargetError(
                "this model was compiled without params; re-run "
                "compile(cfg, params, target) to execute"
            )

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(device=self.device, dtype=torch.int64)

    @torch.no_grad()
    def prefill(self, tokens, extra_embeds=None):
        """(B, S) tokens -> (last-position logits (B, V), prompt caches).
        ``extra_embeds`` (B, L, d) prepends modality-frontend embeddings
        (a VLM's patch embeddings); the caches then cover L + S positions."""
        self._require_params()
        with obs.range("model.prefill"):
            tokens = self._tokens(tokens)
            if extra_embeds is not None:
                extra_embeds = torch.as_tensor(extra_embeds)
            ex = self.executor(int(tokens.shape[0]))
            return lm_lib.prefill(self.params, tokens, self.cfg, extra_embeds=extra_embeds,
                                  engine=ex)

    @torch.no_grad()
    def prefill_continue(self, tokens, prefix_caches: dict):
        """Suffix tokens (B, S) over prefill-shaped ``prefix_caches`` ->
        (last-position logits, full-prompt caches), bit-identical to
        :meth:`prefill` of the whole prompt (the prefix-graft path)."""
        self._require_params()
        with obs.range("model.prefill"):
            tokens = self._tokens(tokens)
            ex = self.executor(int(tokens.shape[0]))
            return lm_lib.prefill_continue(self.params, tokens, prefix_caches, self.cfg,
                                           engine=ex)

    def decode_step(self, token, pos, caches):
        """token (B,), pos scalar or (B,), caches -> (logits, caches);
        the caches are updated in place and returned. A step whose
        shapes and cache addresses repeat is replayed as a CUDA graph
        (:mod:`repro_torch.compiler.decode_graph`); the logits are the
        caller's either way."""
        self._require_params()
        with obs.range("model.decode_step"):
            grad = torch.is_grad_enabled()
            with torch.no_grad():
                return self.decode_graphs.step(self, token, pos, caches, grad=grad)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return lm_lib.init_cache(self.cfg, batch, max_len, device=self.device)

    @torch.no_grad()
    def graft_prefill_caches(self, caches: dict, pre_caches: dict) -> dict:
        """Copy prefill-sized caches into serving-capacity caches from
        :meth:`init_cache`, in place: attention K/V rows into the time
        prefix, Mamba conv tails and states whole (``lm.graft_cache_``)."""
        for slot, kv in pre_caches.items():
            for name, src in kv.items():
                lm_lib.graft_cache_(caches[slot][name], src, name)
        return caches

    def serve(self, *, max_batch: int = 4, max_len: int = 256, scheduler=None):
        """A scheduler-fronted continuous-batching ``ServingEngine`` bound
        to this model (``scheduler``: a ``SchedulerConfig``)."""
        self._require_params()
        from repro_torch.serving.engine import ServingEngine  # serving imports compiler

        return ServingEngine(self, max_batch=max_batch, max_len=max_len, scheduler=scheduler)

    # -- fault tolerance ----------------------------------------------------

    def _fault_engine(self):
        from repro_torch.faults.engine import FaultyEngine

        return self.engine if isinstance(self.engine, FaultyEngine) else None

    def _fault_artifacts(self) -> list:
        """Every resident PreparedWeights in the programmed model. The
        port programs each block's projections apart, where the reference
        stacks each projection over its repeats into one artifact: here
        there are ``7 * n_layers`` (plus one [q|k|v] per layer on a fused
        engine) against the reference's 7 (plus 1). Sweeps union tiles
        over them, so their results are the reference's."""
        if self.params is None:
            return []
        return [p.prepared for _, p in lm_lib.programmed_projections(self.params)]

    def _refresh_artifacts(self):
        """Re-derive every resident artifact under the wrapper's current
        fault state / inner engine (the reprogramming step)."""
        return lm_lib.map_prepared(self.params, self.engine.refresh)

    def scan_faults(self):
        """One consistency sweep over all resident artifacts: the
        :class:`repro_torch.faults.FaultMap` of physical tiles holding
        corrupted cells plus the dead WDM lanes. Empty (falsy) on a
        non-fault-injecting target."""
        from repro_torch.faults import FaultMap

        eng = self._fault_engine()
        if eng is None:
            return FaultMap()
        tiles = eng.locate(self._fault_artifacts())
        if tiles:
            obs.count(
                "repro_faults_detected_total", len(tiles),
                "faulty physical tiles flagged by consistency sweeps",
            )
        return FaultMap(tiles=tiles, lanes=eng.dead_lanes())

    def refresh_faults(self) -> None:
        """Reprogram all artifacts after the fault state changed
        (``engine.fail_tile`` / ``engine.advance_drift``) so execution
        observes the new state."""
        if self._fault_engine() is None:
            raise TargetError(
                "refresh_faults() needs a fault-injecting target "
                "(HardwareTarget(fault_model=...))"
            )
        if self.params is not None:
            self.params = self._refresh_artifacts()
        self._executors.clear()
        self.decode_graphs.clear()

    def remap(self, fault_map) -> RemapReport:
        """Move only the blocks resident on the fault map's tiles onto
        clean spares, rebind the (re-placed) inner engine under the same
        fault state, and reprogram the refreshed artifacts.

        Raises :class:`repro_torch.mapping.SpareTilesExhaustedError` when
        the clean-spare pool can't cover the displaced blocks, and
        :class:`TargetError` when the target has no fault wrapper or no
        plan to re-place."""
        from repro_torch.mapping import remap_plan

        eng = self._fault_engine()
        if eng is None:
            raise TargetError(
                "remap() needs a fault-injecting target "
                "(HardwareTarget(fault_model=...))"
            )
        if self.plan is None:
            raise TargetError(
                "remap() re-places an explicit MappingPlan — compile with "
                "the 'tiled' engine and spare_tiles/mapping_policy set"
            )
        tiles = frozenset(getattr(fault_map, "tiles", fault_map))
        with obs.span("remap", track="compile", tiles=sorted(tiles)) as sp:
            new_plan, delta = remap_plan(self.plan, tiles, tile_ok=eng.tile_is_clean)
            inner = resolve_engine(
                dataclasses.replace(self.target, fault_model=None), self.cfg, new_plan
            )
            self.plan = new_plan
            self._price_plan = new_plan
            self.engine = eng.rebind(inner)
            if self.params is not None:
                self.params = self._refresh_artifacts()
            # cached executors wrap the old engine, graphs the old
            # artifacts — drop them
            self._executors.clear()
            self.decode_graphs.clear()
            sp.set(moves=len(delta.moves), spares_left=len(new_plan.spares))
        obs.count("repro_remaps_total", 1, "fault-driven incremental remaps")
        return RemapReport(
            moves=delta.moves,
            cost=delta.cost,
            failed_tiles=tiles,
            spares_left=len(new_plan.spares),
        )

    # -- pricing / reporting ------------------------------------------------

    def pricing_plan(self):
        """The plan the cost model prices: the bound plan, else one
        compiled lazily on the target's spec/policy (pricing is static —
        a reference or wdm target still prices the paper's mapping). The
        telemetry crosscheck (:mod:`repro_torch.obs.crosscheck`) prices
        traced decode ticks on it."""
        if self._price_plan is None:
            from repro_torch.mapping import compile_plan

            self._price_plan = compile_plan(
                self.cfg,
                spec=self.target.spec or self.spec,
                policy=self.target.mapping_policy
                or getattr(self.cfg, "mapping_policy", None)
                or "tacitmap",
                tile_budget=self.target.tile_budget,
            )
        return self._price_plan

    def price(self, n_active: int = 16) -> TargetPrice:
        """Plan execution + one-time programming + per-tick readout, in
        one report (``n_active`` = serving slots per decode tick); the
        cost model's figures for the target's crossbar."""
        from repro_torch.core import costmodel

        plan = self.pricing_plan()
        cost = costmodel.price_plan(plan)
        prog = costmodel.plan_programming_cost(plan)
        tick = costmodel.plan_decode_tick(plan, n_active)
        return TargetPrice(
            target=self.target,
            design=cost.design,
            policy=plan.policy,
            n_tiles=plan.n_tiles,
            utilization=plan.utilization(),
            k=plan.preferred_group_size(),
            binary_steps=cost.binary_steps,
            latency_s=cost.latency_s,
            energy_j=cost.energy_j,
            programming_cells=prog.cells,
            programming_uj=prog.energy_pj * 1e-6,
            programming_us=prog.time_ns * 1e-3,
            tick_latency_ns=tick.latency_ns,
            tick_energy_pj=tick.energy_pj,
            break_even_ticks=prog.energy_pj / max(tick.energy_pj, 1e-12),
            plan_cost=cost,
        )

    def describe(self) -> str:
        """Placement + pricing tables for this target (mapping.report)."""
        from repro_torch.mapping import report

        plan = self.pricing_plan()
        price = self.price()  # carries the plan_cost format_priced needs
        lines = [self.target.describe(), report.summarize(plan)]
        lines.append(report.format_priced(price.plan_cost))
        lines.append(price.summary())
        if self.programmed:
            lines.append(
                f"[program] {self.programmed} projection instance(s) resident "
                f"in {self.target.engine} form ({self.program_s * 1e3:.1f} ms "
                "one-time PCM write)"
            )
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        eng = self.engine.name if self.engine is not None else "reference"
        planned = self.plan.policy if self.plan is not None else "-"
        return (
            f"<CompiledModel {self.cfg.name} engine={eng} plan={planned} "
            f"device={self.device} programmed={self.programmed}>"
        )

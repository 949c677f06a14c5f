"""``compile(cfg, params, target) -> CompiledModel`` (counterpart of
``repro/compiler/pipeline.py``: validate -> map -> resolve -> program).

1. **Validate** the target eagerly (named :class:`TargetError`\\ s —
   plan+engine mismatch, spec mismatch, K over plan capacity) and the
   config (this slice serves attention-only dense stacks).
2. **Map**: compile an explicit layer->tile
   :class:`~repro_torch.mapping.allocator.MappingPlan`
   (``mapping.compile_plan``) when the target names a policy, budget or
   spares, or bind a pre-compiled plan passed by the caller.
3. **Resolve** the execution backend from the registry (``tiled`` binds
   the plan) and flip the config to ``quant="bnn"`` for non-reference
   engines.
4. **Program**: the one-time crossbar write (``lm.program_weights``), so
   decode streams only activations.

With a telemetry session active (:mod:`repro_torch.obs`) each stage
records a span on the ``compile`` track, named as the reference's:
``compile.validate``, ``compile.map`` (with the plan's ``policy`` and
``n_tiles`` when there is one), ``compile.resolve`` and
``compile.program`` (ending after the device's programming work) under
the root ``compile``. The returned :class:`CompiledModel` is what every
consumer drives: ``prefill()`` / ``prefill_continue()`` /
``decode_step()`` for batch loops, ``serve()`` for a
continuous-batching ``ServingEngine``, ``price()`` for the cost model's
plan + programming + per-tick readout report and ``describe()`` for
the placement and pricing tables. ``price()`` and ``describe()`` are the
cost model's figures for an ePCM/oPCM crossbar, not times of the device
the model runs on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch import obs
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
from repro_torch.models.config import require_servable


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
    the config's policy)."""
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
    return engine_lib.get_engine(target.engine, target.spec, **kw)


def compile(cfg, params, target: HardwareTarget, *, plan=None, device=None) -> "CompiledModel":
    """Compile a model onto a hardware target: validate -> map -> resolve
    -> program, on ``device`` (default ``cuda``; ``params`` move there).
    ``params`` is a :class:`repro_torch.models.lm.LM`, or ``None`` for a
    price-only compilation (``price()``/``describe()`` work, execution
    entry points raise). ``plan`` binds a pre-compiled
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
        require_servable(cfg)

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
      LM entry points with the target's K-grouped executor bound;
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
        group spanning the pool; clamped to the pool)."""
        return engine_lib.resolve_group_size(
            self.engine, self.target.group_size, batch, plan=self.plan
        )

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
    def prefill(self, tokens):
        """(B, S) tokens -> (last-position logits (B, V), prompt caches)."""
        self._require_params()
        tokens = self._tokens(tokens)
        ex = self.executor(int(tokens.shape[0]))
        return lm_lib.prefill(self.params, tokens, self.cfg, engine=ex)

    @torch.no_grad()
    def prefill_continue(self, tokens, prefix_caches: dict):
        """Suffix tokens (B, S) over prefill-shaped ``prefix_caches`` ->
        (last-position logits, full-prompt caches), bit-identical to
        :meth:`prefill` of the whole prompt (the prefix-graft path)."""
        self._require_params()
        tokens = self._tokens(tokens)
        ex = self.executor(int(tokens.shape[0]))
        return lm_lib.prefill_continue(self.params, tokens, prefix_caches, self.cfg, engine=ex)

    @torch.no_grad()
    def decode_step(self, token, pos, caches):
        """token (B,), pos scalar or (B,), caches -> (logits, caches);
        the caches are updated in place and returned."""
        self._require_params()
        token = self._tokens(token)
        pos = torch.as_tensor(pos).to(device=self.device, dtype=torch.int64)
        ex = self.executor(int(token.shape[0]))
        return lm_lib.decode_step(self.params, token, pos, caches, self.cfg, engine=ex)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return lm_lib.init_cache(self.cfg, batch, max_len, device=self.device)

    @torch.no_grad()
    def graft_prefill_caches(self, caches: dict, pre_caches: dict) -> dict:
        """Copy prefill-sized caches into the time prefix of serving-
        capacity caches from :meth:`init_cache`, in place."""
        for slot, kv in pre_caches.items():
            for name, src in kv.items():
                dst = caches[slot][name]
                dst[:, :, : src.shape[2]] = src.to(dst.dtype)
        return caches

    def serve(self, *, max_batch: int = 4, max_len: int = 256, scheduler=None):
        """A scheduler-fronted continuous-batching ``ServingEngine`` bound
        to this model (``scheduler``: a ``SchedulerConfig``)."""
        self._require_params()
        from repro_torch.serving.engine import ServingEngine  # serving imports compiler

        return ServingEngine(self, max_batch=max_batch, max_len=max_len, scheduler=scheduler)

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

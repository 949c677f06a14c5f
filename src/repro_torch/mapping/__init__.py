"""Mapping compiler: model -> explicit layer-to-tile placement plan
(counterpart of ``repro/mapping``; framework-free, the port's own copy).

The paper's core contribution is a *data mapping* — TacitMap decides how
binarized layers land on crossbar tiles and (with WDM) wavelengths.
This package makes that decision an explicit, static compilation
artifact instead of an implicit convention baked into each engine:

* :mod:`repro_torch.mapping.ir`        — the layer IR (``LayerIR``/``ModelIR``)
  extracted from a ``ModelConfig`` (LM projection stacks, scan repeats
  expanded) or a paper ``NetworkDesc`` (MLP/CNN workloads).
* :mod:`repro_torch.mapping.allocator` — the placement planner: complement-row
  TacitMap layout cut into ``CrossbarSpec`` tiles and assigned to a
  physical tile pool under a policy (``tacitmap`` | ``column-major`` |
  ``greedy`` load balancing), with WDM wavelength sets recorded per
  layer. Produces a :class:`~repro_torch.mapping.allocator.MappingPlan`.
* :mod:`repro_torch.mapping.schedule`  — orders per-tick tile activations into
  parallel phases and prices each layer via ``repro_torch.core.costmodel``.
* :mod:`repro_torch.mapping.report`    — human-readable plan/pricing reports.

Consumers: the ``tiled`` execution engine (``repro_torch.core.engine``) slices
operands per the plan's block order; the serving engine's BatchPlanner
consults ``plan.preferred_group_size()``; ``launch/serve.py
--mapping-policy`` compiles a plan at startup; ``costmodel.price_plan``
prices one directly.

Worked example
--------------

Compile qwen1.5-0.5b onto oPCM tiles, schedule it, price it, and run the
binarized matmuls through the plan-driven ``tiled`` engine::

    from repro_torch.configs import get_config
    from repro_torch.core import costmodel
    from repro_torch.core.crossbar import OPCM_TILE
    from repro_torch.core.engine import get_engine
    from repro_torch.mapping import allocate, report, schedule

    plan = allocate(get_config("qwen1.5-0.5b"), spec=OPCM_TILE,
                    policy="greedy", tile_budget=4096)
    sch = schedule.schedule(plan)          # tile phases + step counts
    # (or: from repro_torch.mapping import schedule_plan; sch = schedule_plan(plan))
    cost = costmodel.price_plan(plan)      # latency/energy per inference
    print(report.summarize(plan))          # tiles/util/K/balance one-liner
    print(report.format_priced(cost))

    eng = get_engine("tiled", plan=plan)   # executes per the placement
    out = eng.binary_vmm(a_signs, w_signs) # bit-exact vs "reference"

    # the one-call replacement (compiles the plan, binds the engine,
    # programs the weights, consults the plan's WDM capacity for K):
    cm = repro_torch.compiler.compile(cfg, params,
                                HardwareTarget(engine="tiled",
                                               mapping_policy="greedy",
                                               tile_budget=4096))
    se = cm.serve(max_batch=8, max_len=256)
"""

from repro_torch.mapping.allocator import (  # noqa: F401
    POLICIES,
    BlockMove,
    BlockPlacement,
    LayerPlan,
    MappingPlan,
    RemapDelta,
    SpareTilesExhaustedError,
    allocate,
    balance_ratio,
    remap_plan,
    required_tiles,
)
from repro_torch.mapping.ir import (  # noqa: F401
    LayerIR,
    ModelIR,
    adhoc_layer,
    from_model_config,
    from_network_desc,
    to_ir,
)
from repro_torch.mapping import report  # noqa: F401
from repro_torch.mapping import schedule as _schedule_mod
from repro_torch.mapping.schedule import LayerSchedule, Schedule  # noqa: F401

# compile_plan is the one-call public entry point consumers use;
# schedule_plan orders+prices a compiled plan (the submodule stays
# reachable as repro_torch.mapping.schedule — the function is NOT re-exported
# under the same name to avoid shadowing it)
compile_plan = allocate
schedule_plan = _schedule_mod.schedule

"""Human-readable mapping-plan reports (counterpart of
``repro/mapping/report.py``).

``format_plan`` renders the compilation artifact the way a hardware
mapping document would: the provisioned tile pool, per-layer placement
geometry (grid, blocks, tiles, serialization), and — when priced — the
schedule's step/latency/energy columns. ``launch/serve.py
--mapping-policy`` prints the summary; tests assert the full report
names every placed layer.
"""

from __future__ import annotations

from repro_torch.core import costmodel
from repro_torch.mapping import schedule as schedule_lib
from repro_torch.mapping.allocator import MappingPlan, balance_ratio


def summarize(plan: MappingPlan) -> str:
    """One line: what this plan provisions and how it groups."""
    spec = plan.spec
    budget = "dedicated" if plan.tile_budget is None else f"budget={plan.tile_budget}"
    return (
        f"[mapping] {plan.model.name}: policy={plan.policy} "
        f"tiles={plan.n_tiles} ({spec.technology} {spec.rows}x{spec.cols}, {budget}) "
        f"blocks={plan.n_blocks} util={plan.utilization():.2f} "
        f"K={plan.preferred_group_size()} balance={balance_ratio(plan):.2f}"
    )


def format_plan(
    plan: MappingPlan,
    sch: schedule_lib.Schedule | None = None,
    max_rows: int = 40,
) -> str:
    """Multi-line placement report; pass a schedule to add cost columns.

    Layer instances beyond ``max_rows`` are elided with a summary line
    (LM plans expand scan repeats into hundreds of instances).
    """
    lines = [summarize(plan)]
    priced = {ls.layer: ls for ls in sch.layers} if sch is not None else {}
    header = (
        f"{'layer':<24s} {'mxn':>12s} {'grid':>7s} {'blocks':>6s} "
        f"{'tiles':>6s} {'s/vec':>5s}"
    )
    if priced:
        header += f" {'steps':>7s} {'lat_us':>8s} {'en_nJ':>8s}"
    lines.append(header)
    for lp in plan.layers[:max_rows]:
        row = (
            f"{lp.name:<24s} {f'{lp.ir.m}x{lp.ir.n}':>12s} "
            f"{f'{lp.grid.row_tiles}x{lp.grid.col_tiles}':>7s} "
            f"{lp.n_blocks:6d} {len(lp.tiles):6d} {lp.steps_per_vector:5d}"
        )
        ls = priced.get(lp.name)
        if ls is not None:
            row += f" {ls.steps:7d} {ls.latency_ns * 1e-3:8.2f} {ls.energy_pj * 1e-3:8.2f}"
        lines.append(row)
    hidden = len(plan.layers) - max_rows
    if hidden > 0:
        lines.append(f"... {hidden} more layer instances (same pattern slots, scan repeats)")
    if sch is not None:
        lines.append(
            f"total: {sch.total_steps} steps, "
            f"{sch.total_latency_ns * 1e-6:.3f} ms/batch, "
            f"{sch.total_energy_pj * 1e-6:.3f} uJ/batch "
            f"(design={sch.params.name}, batch={sch.params.batch})"
        )
    return "\n".join(lines)


def format_priced(cost: costmodel.PlanCost) -> str:
    """Render a costmodel.price_plan result (IR-entry aggregates)."""
    lines = [
        f"[mapping] {cost.model} priced on {cost.design} "
        f"(policy={cost.policy}, batch={cost.batch}): "
        f"{cost.latency_s * 1e6:.2f} us/inf, {cost.energy_j * 1e6:.3f} uJ/inf, "
        f"{cost.n_tiles} tiles @ util {cost.utilization:.2f}",
        f"{'layer':<20s} {'mxn':>12s} {'inst':>5s} {'blocks':>6s} "
        f"{'s/vec':>5s} {'steps':>8s} {'lat_us':>8s} {'en_uJ':>8s}",
    ]
    for r in cost.layers:
        mxn = "{m}x{n}".format(m=r["m"], n=r["n"])
        lines.append(
            f"{r['layer']:<20s} {mxn:>12s} "
            f"{r['instances']:5d} {r['blocks']:6d} {r['steps_per_vector']:5d} "
            f"{r['steps']:8d} {r['latency_ns'] * 1e-3:8.2f} "
            f"{r['energy_pj'] * 1e-6:8.3f}"
        )
    return "\n".join(lines)

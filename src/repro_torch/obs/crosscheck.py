"""Measured-vs-modeled pricing cross-check (counterpart of
``repro/obs/crosscheck.py``).

The cost model (:mod:`repro_torch.core.costmodel`) prices every decode
tick analytically — the paper's ~154x TacitMap and ~3113x
EinsteinBarrier claims are exactly such step-count prices. This module
pairs each **traced** decode tick (the ``decode_tick`` spans the serving
engine records, wall-clock fenced by ``torch.cuda.synchronize``) with
its ``scheduled_decode_tick`` / ``plan_decode_tick`` modeled price and
reports the measured/modeled ratio per engine x K.

The ratio is NOT expected to be ~1: the model prices the *photonic
crossbar* (nanosecond readout) while the measurement times a torch
emulation of it on a GPU or CPU — what the ratio buys is a *consistent*
fidelity trajectory (finite, positive, comparable across changes) and a
structural check that modeled cost scales the way the measured tick
does across engine x K.

    rows = crosscheck_serving(se)          # after a traced serve run
    print(format_report(rows))
"""

from __future__ import annotations

import dataclasses
import statistics


@dataclasses.dataclass(frozen=True)
class TickCheck:
    """Measured-vs-modeled decode-tick pricing for one (engine, K)."""

    engine: str
    k: int
    ticks: int                   # traced decode ticks aggregated
    n_active_mean: float         # mean admitted width across those ticks
    measured_ns: float           # median measured tick wall time
    measured_total_ns: float     # summed measured wall time
    modeled_ns: float            # modeled latency of the median tick
    modeled_total_ns: float      # summed modeled latency (per-tick widths)
    ratio: float                 # measured_total / modeled_total

    @property
    def finite(self) -> bool:
        import math

        return math.isfinite(self.ratio) and self.ratio > 0.0


def crosscheck_ticks(tracer, plan, pool: int) -> list[TickCheck]:
    """Pair a tracer's ``decode_tick`` spans with the cost model.

    Every span is priced at ITS admitted width through
    :func:`repro_torch.core.costmodel.scheduled_decode_tick` (which wraps
    ``plan_decode_tick`` at that width), so partially-admitted ticks
    are compared against what they actually issued, not the full pool.
    Returns one row per (engine, K), sorted.
    """
    from repro_torch.core import costmodel

    groups: dict[tuple[str, int], list] = {}
    for sp in tracer.spans("decode_tick"):
        key = (str(sp.attrs.get("engine", "?")), int(sp.attrs.get("k", 1)))
        groups.setdefault(key, []).append(sp)

    params = costmodel.params_for_spec(plan.spec)
    rows = []
    for (engine, k), spans in sorted(groups.items()):
        measured = [sp.duration_ns for sp in spans]
        widths = [min(int(sp.attrs.get("n_active", 1)), pool) for sp in spans]
        modeled = [
            costmodel.scheduled_decode_tick(plan, w, pool, params=params).latency_ns
            for w in widths
        ]
        modeled_total = sum(modeled)
        measured_total = float(sum(measured))
        rows.append(TickCheck(
            engine=engine,
            k=k,
            ticks=len(spans),
            n_active_mean=sum(widths) / len(widths),
            measured_ns=float(statistics.median(measured)),
            measured_total_ns=measured_total,
            modeled_ns=float(statistics.median(modeled)),
            modeled_total_ns=float(modeled_total),
            ratio=measured_total / modeled_total if modeled_total > 0 else float("inf"),
        ))
    return rows


def crosscheck_serving(se, tracer=None) -> list[TickCheck]:
    """Cross-check a serving engine's traced ticks against its compiled
    target's pricing plan (the bound mapping plan when the target has
    one, else the plan ``CompiledModel.price()`` compiles lazily on the
    target's spec/policy). ``tracer`` defaults to the active telemetry
    session's."""
    if tracer is None:
        from repro_torch import obs

        tel = obs.active()
        if tel is None:
            raise ValueError(
                "no active telemetry session and no tracer passed — start "
                "one with repro_torch.obs.start() before serving, or pass the "
                "Tracer that recorded the decode_tick spans"
            )
        tracer = tel.tracer
    plan = se.compiled.pricing_plan()
    return crosscheck_ticks(tracer, plan, pool=se.max_batch)


def format_report(rows: list[TickCheck]) -> str:
    """The printable measured-vs-modeled table."""
    lines = [
        f"{'engine':>10s} {'K':>3s} {'ticks':>6s} {'width':>6s} "
        f"{'measured_us':>12s} {'modeled_ns':>11s} {'ratio':>10s}"
    ]
    for r in rows:
        lines.append(
            f"{r.engine:>10s} {r.k:3d} {r.ticks:6d} {r.n_active_mean:6.1f} "
            f"{r.measured_ns * 1e-3:12.1f} {r.modeled_ns:11.1f} "
            f"{r.ratio:10.1f}"
        )
    lines.append(
        "(ratio = summed measured wall / summed modeled latency; the host "
        "emulates nanosecond photonics, so >>1 is expected — the value is "
        "the trajectory, not the level)"
    )
    return "\n".join(lines)

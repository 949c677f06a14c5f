"""Shared argparse surface for hardware targets, the request scheduler,
the fleet and telemetry (counterpart of ``repro/compiler/cli.py``,
serving and telemetry flags).

    ap = argparse.ArgumentParser()
    add_target_args(ap)
    add_scheduler_args(ap)
    add_fleet_args(ap)
    add_obs_args(ap)
    args = ap.parse_args()
    tel = obs_from_args(args)      # before compile(): its stage spans
    compiled = compile(cfg, params, target_from_args(args))
    se = compiled.serve(scheduler=scheduler_from_args(args))
"""

from __future__ import annotations

import argparse

from repro_torch.compiler.target import HardwareTarget


def add_target_args(
    ap: argparse.ArgumentParser, *, default_engine: str = "reference"
) -> argparse.ArgumentParser:
    """Install the hardware-target flags on a parser."""
    from repro_torch.core import engine as engine_lib
    from repro_torch.mapping import POLICIES

    ap.add_argument(
        "--engine",
        default=default_engine,
        # a typo fails here with the registered names listed
        choices=engine_lib.list_engines(),
        help="execution backend for binarized projections "
        "(registered in repro_torch.core.engine)",
    )
    ap.add_argument(
        "--group-size",
        type=int,
        default=0,
        help="K-group width for batched decode (0 = auto from the mapping "
        "plan / engine's preferred_group_size / batch)",
    )
    ap.add_argument(
        "--mapping-policy",
        default=None,
        choices=POLICIES,
        help="compile a layer->tile MappingPlan under this allocator policy "
        "and execute per it (requires --engine tiled)",
    )
    ap.add_argument(
        "--tile-budget",
        type=int,
        default=None,
        metavar="N",
        help="cap the physical tile pool the mapping plan provisions "
        "(co-resident blocks serialize; requires --engine tiled)",
    )
    ap.add_argument(
        "--spare-tiles",
        type=int,
        default=0,
        metavar="N",
        help="provision N extra physical tiles as fault-remap destinations "
        "in the mapping plan (requires --engine tiled)",
    )
    ap.add_argument(
        "--raw-weights",
        action="store_true",
        help="skip the one-time programming phase and re-run the weight-side "
        "transforms every call (baseline)",
    )
    return ap


def add_scheduler_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Install the serve-time request-scheduler flags on a parser."""
    from repro_torch.serving.scheduler import ADMISSION_MODES, POLICIES

    ap.add_argument(
        "--sched-policy",
        default="fifo",
        choices=POLICIES,
        help="waiting-queue order: fifo (priority then submission) or "
        "deadline (earliest deadline first)",
    )
    ap.add_argument(
        "--admission",
        default="whole",
        choices=ADMISSION_MODES,
        help="KV-budget admission: whole commits prompt+max_new_tokens up "
        "front; partial admits on the prompt footprint and preempts under "
        "pressure",
    )
    ap.add_argument(
        "--kv-reserve",
        type=float,
        default=0.0,
        metavar="RATIO",
        help="fraction of the KV-token budget held back from admission, in [0, 1]",
    )
    ap.add_argument(
        "--max-waiting",
        type=int,
        default=None,
        metavar="N",
        help="waiting-queue depth cap; submissions beyond it are rejected "
        "gracefully (default: unbounded)",
    )
    ap.add_argument(
        "--no-preempt",
        action="store_true",
        help="disable budget/priority preemption",
    )
    return ap


def scheduler_from_args(args: argparse.Namespace):
    """Build (and validate) a SchedulerConfig from parsed scheduler flags."""
    from repro_torch.serving.scheduler import SchedulerConfig

    return SchedulerConfig(
        policy=args.sched_policy,
        admission=args.admission,
        kv_reserve_ratio=args.kv_reserve,
        max_waiting=args.max_waiting,
        preempt=not args.no_preempt,
    ).validate()


def add_fleet_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Install the fleet-serving flags: replica count, routing policy and
    prefix block for :class:`repro_torch.fleet.FleetEngine`."""
    from repro_torch.fleet.router import DEFAULT_BLOCK, ROUTING_POLICIES

    ap.add_argument(
        "--replicas",
        type=int,
        default=1,
        metavar="N",
        help="serve from a fleet of N identically-compiled replicas behind "
        "the prefix-affinity router (1 = plain single-replica serving, no "
        "fleet layer)",
    )
    ap.add_argument(
        "--routing",
        default="prefix",
        choices=ROUTING_POLICIES,
        help="fleet routing policy: prefix (longest KV-prefix match, then "
        "load), least-loaded, or round-robin (only with --replicas > 1)",
    )
    ap.add_argument(
        "--prefix-block",
        type=int,
        default=DEFAULT_BLOCK,
        metavar="TOKENS",
        help="token-block width of the router's chained prefix hashes "
        "(prefix policy only; smaller blocks match shorter shared prefixes "
        "at more index churn)",
    )
    return ap


def add_obs_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Install the shared telemetry flags: either flag turns the
    :mod:`repro_torch.obs` session on for the whole run."""
    ap.add_argument(
        "--trace-out",
        default=None,
        metavar="PATH",
        help="write a Chrome-trace (chrome://tracing / Perfetto) JSON of "
        "compile-stage and per-tick spans to PATH (enables telemetry)",
    )
    ap.add_argument(
        "--metrics-out",
        default=None,
        metavar="PATH",
        help="write a Prometheus-style text snapshot (TTFT, tick latency, "
        "queue depth, cache counters) to PATH (enables telemetry)",
    )
    return ap


def obs_from_args(args: argparse.Namespace):
    """Start a telemetry session when any obs flag was passed; returns
    the :class:`repro_torch.obs.Telemetry` or ``None`` (telemetry stays
    off).

    Call BEFORE ``compile()`` so the pipeline-stage spans are captured;
    export at the end with ``tel.write(trace_out=args.trace_out,
    metrics_out=args.metrics_out)``.
    """
    if getattr(args, "trace_out", None) or getattr(args, "metrics_out", None):
        from repro_torch import obs

        return obs.start()
    return None


def target_from_args(args: argparse.Namespace) -> HardwareTarget:
    """Build (and statically validate) a HardwareTarget from parsed flags."""
    return HardwareTarget(
        engine=args.engine,
        group_size=args.group_size or None,
        mapping_policy=args.mapping_policy,
        tile_budget=args.tile_budget,
        prepare_weights=not args.raw_weights,
        spare_tiles=args.spare_tiles,
    ).validate()

"""The system's program ranges (``repro_torch.obs.RANGES``) in a traced
run's device trace, and the four readings built on them: launches,
dispatch time and idle time per decode step, and the MoE experts'
device time per step.

    python3 bench/ranges.py --workload <name> --seeds 1,2,3 --seconds 51

runs each seed as ``bench/run.py --trace 1`` does (one process, the
same window and profiler stretch) and prints one JSON line per seed:
the run's result line, the traced ``tokens / window`` rate, the four
readings, how many decode steps launched how many kernels, the traced
stretch's idle time split by the innermost program range open on the
host (``idle_by_range``), and the fused BitLinear launches inside
``model.decode_step`` beside those inside the harness's
``bench.decode_step``. Never run by a benchmark run: the harness keeps
no program range (``bench/profile.py`` keeps ``bench.*`` ranges only).

:func:`reduce_ranges` is the reduction on its own, from Chrome-trace
events: a kernel, copy or set belongs to every program range open on
the host when it was launched; the device is idle wherever no kernel,
copy or set runs between the trace's first and last event.
"""

from __future__ import annotations

import bisect
import json
import statistics
import sys
import time
from collections import Counter
from pathlib import Path

T_START = time.perf_counter()

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP = "model.decode_step"
EXPERTS = "moe.experts"
NONE = "none"


class RangeTrace:
    """A device trace reduced by program range.

    * ``intervals``: name -> its ranges' host intervals (us), in order;
    * ``device``: the ranges open at a launch (outermost first) ->
      kernel name -> [device seconds, launches];
    * ``idle``: the ranges open on the host -> device-idle seconds;
    * ``launched``: when each kernel, copy and set was launched (us),
      in order.
    """

    def __init__(self, intervals: dict, device: dict, idle: dict, launched: list):
        self.intervals = intervals
        self.device = device
        self.idle = idle
        self.launched = launched

    def count(self, name: str) -> int:
        return len(self.intervals.get(name, ()))

    def host_s(self, name: str) -> list[float]:
        """The host seconds of each ``name`` range."""
        return [(e - s) * 1e-6 for s, e in self.intervals.get(name, ())]

    def launches_each(self, name: str) -> list[int]:
        """Kernels, copies and sets launched inside each ``name`` range."""
        return [bisect.bisect_right(self.launched, e) - bisect.bisect_left(self.launched, s)
                for s, e in self.intervals.get(name, ())]

    def within(self, *names: str, match=None) -> tuple[float, int]:
        """Device seconds and launches of the kernels (``match(kernel)``
        accepts, all by default) launched inside every range named."""
        s, n = 0.0, 0
        for stack, kernels in self.device.items():
            if all(r in stack for r in names):
                for kernel, (sec, cnt) in kernels.items():
                    if match is None or match(kernel):
                        s += sec
                        n += cnt
        return s, n

    def idle_within(self, name: str) -> float:
        """Device-idle seconds while a ``name`` range is open on the host."""
        return sum(sec for stack, sec in self.idle.items() if name in stack)

    def idle_by_range(self) -> dict[str, float]:
        """Device-idle seconds by the innermost range open on the host
        (``none``: no range open)."""
        out: dict[str, float] = {}
        for stack, sec in self.idle.items():
            key = stack[-1] if stack else NONE
            out[key] = out.get(key, 0.0) + sec
        return out


def _segments(ranges: list[tuple[float, float, str]]) -> list[tuple[float, float, tuple]]:
    """The host timeline cut where a range opens or closes: ``(start,
    end, the ranges open, outermost first)``, covering all time. Ranges
    nest on the one host thread; a child that outlasts its parent by
    the clock's jitter is cut at the parent's end."""
    segs = []
    stack: list[tuple[float, str]] = []   # (end, name)
    cur = float("-inf")

    def emit(t: float) -> None:
        nonlocal cur
        if t > cur:
            segs.append((cur, t, tuple(n for _, n in stack)))
            cur = t

    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    segs.append((cur, float("inf"), ()))
    return segs


def reduce_ranges(events: list[dict], names) -> RangeTrace:
    """Reduce Chrome-trace ``events`` by the program ranges ``names``."""
    names = set(names)
    ranges, dev, launches = [], [], {}
    lo, hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        lo, hi = min(lo, ts), max(hi, ts + dur)
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"], e.get("args", {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat == "user_annotation" and e["name"] in names:
            ranges.append((ts, ts + dur, e["name"]))
    intervals: dict[str, list[tuple[float, float]]] = {}
    for s, e, name in sorted(ranges):
        intervals.setdefault(name, []).append((s, e))
    segs = _segments(ranges)
    starts = [s for s, _, _ in segs]

    def open_at(t: float | None) -> tuple:
        return () if t is None else segs[bisect.bisect_right(starts, t) - 1][2]

    device: dict[tuple, dict[str, list[float]]] = {}
    busy: list[list[float]] = []
    for s, e, name, corr in sorted(dev):
        k = device.setdefault(open_at(launches.get(corr)), {}).setdefault(name, [0.0, 0])
        k[0] += (e - s) * 1e-6
        k[1] += 1
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    idle_spans, t = [], lo
    for s, e in busy:
        if s > t:
            idle_spans.append((t, s))
        t = max(t, e)
    if hi > t:
        idle_spans.append((t, hi))
    idle: dict[tuple, float] = {}
    i = 0
    for s, e in idle_spans:
        while segs[i][1] <= s:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < e:
            a, b, stack = segs[j]
            overlap = min(b, e) - max(a, s)
            if overlap > 0:
                idle[stack] = idle.get(stack, 0.0) + overlap * 1e-6
            j += 1
    launched = sorted(t for t in (launches.get(c) for *_, c in dev) if t is not None)
    return RangeTrace(intervals, device, idle, launched)


def load_events(path: Path) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


# -- the readings --------------------------------------------------------------


def launches_per_step(rt: RangeTrace) -> float | None:
    """Kernels, copies and sets launched inside a ``model.decode_step``
    range, the median over the ranges: the profiler loses the device
    records of the first few launches after it starts (their runtime
    calls are in the trace), which shortens the stretch's first step."""
    each = rt.launches_each(STEP)
    return statistics.median(each) if each else None


def dispatch_ms(rt: RangeTrace) -> float | None:
    """Median host time of a ``model.decode_step`` range: issuing one
    step, unfenced."""
    d = rt.host_s(STEP)
    return statistics.median(d) * 1e3 if d else None


def idle_in_step_share(rt: RangeTrace, window_s: float) -> float | None:
    """Share of the traced stretch in which the device is idle while a
    ``model.decode_step`` range is open on the host."""
    if not rt.count(STEP) or window_s <= 0:
        return None
    return 100.0 * rt.idle_within(STEP) / window_s


def moe_experts_ms(rt: RangeTrace) -> float | None:
    """Device time of the kernels launched inside ``moe.experts`` within
    ``model.decode_step``, per decode step."""
    n = rt.count(STEP)
    sec, launched = rt.within(STEP, EXPERTS)
    return sec * 1e3 / n if n and launched else None


# -- the tool --------------------------------------------------------------------


def _fused(name: str) -> bool:
    return "BitLinearOut" in name or "fused_bnn_kernel" in name


def readings(rt: RangeTrace, trace) -> dict:
    """The four readings and what stands beside them, for one traced run
    (``trace``: the harness's ``profile.DeviceTrace``)."""
    decode_fused = rt.within(STEP, match=_fused)[1]
    harness_fused = trace.kernel_seconds(_fused, within="bench.decode_step")[1]
    return {
        "launches_per_step.decode": launches_per_step(rt),
        "dispatch_ms.decode": dispatch_ms(rt),
        "idle_in_step_share.decode": idle_in_step_share(rt, trace.window_s),
        "moe_experts_ms.decode": moe_experts_ms(rt),
        "busy_ms_per_step": 1e3 * trace.busy_s / rt.count(STEP) if rt.count(STEP) else None,
        "steps": rt.count(STEP),
        "launches_by_step": dict(sorted(Counter(rt.launches_each(STEP)).items())),
        "fused_launches": {"model.decode_step": decode_fused, "bench.decode_step": harness_fused},
        "idle_by_range": dict(sorted(rt.idle_by_range().items(), key=lambda kv: -kv[1])),
        "device_by_range": {" > ".join(stack) or NONE: [sum(v[0] for v in k.values()),
                                                       sum(v[1] for v in k.values())]
                            for stack, k in rt.device.items()},
        "range_counts": {name: len(d) for name, d in rt.intervals.items()},
    }


def traced_runs(cell, seeds, seconds: float, *, device: str = "cuda", smoke: bool = False,
                out_dir: Path | None = None, t_start: float | None = None):
    """One traced run of ``cell`` per seed, as ``bench/run.py --trace 1``
    makes it; yields each run's line (see the module's docstring)."""
    from repro_torch import obs

    from bench import harness, profile

    reduce_chrome_trace = profile.reduce_chrome_trace
    traces = []

    def with_ranges(path, window_s):
        trace = reduce_chrome_trace(path, window_s)
        traces.append((trace, reduce_ranges(load_events(path), obs.RANGES)))
        return trace

    # the harness's reduction as it is, and the program ranges of the same file
    profile.reduce_chrome_trace = with_ranges
    try:
        for seed in seeds:
            traces.clear()
            out = harness.run_cell(cell, seed, seconds, True, device=device,
                                   t_start=t_start or time.perf_counter(), smoke=smoke,
                                   out_dir=out_dir)
            t_start = None
            meta = out["meta"]
            line = {"workload": cell.name, "seed": seed, "result": out["result"],
                    "traced_decode_tok_s": meta["tokens"] / meta["window_s"],
                    "device": meta.get("device_name"), "nvidia_smi": meta.get("nvidia_smi_after"),
                    "trace_work": meta.get("trace_work")}
            if traces:  # the last reduction is the window's (the first, set-up's)
                trace, rt = traces[-1]
                line["ranges"] = readings(rt, trace)
            yield line
    finally:
        profile.reduce_chrome_trace = reduce_chrome_trace


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from run import _environment

    _environment()
    import torch

    torch.set_num_threads(1)
    from bench.spec import load_cell

    seeds = [int(s) for s in args.seeds.split(",")]
    for line in traced_runs(load_cell(args.workload), seeds, args.seconds, t_start=T_START):
        print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

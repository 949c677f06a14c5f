"""One run of one cell: set-up, the measured window, the check, the
result.

Set-up makes the weights from the seed on the device in the layout of
the cell's model module, builds the system's model from them with its
own constructors (the module's ``build``), compiles it onto
its target (programming the binarized projections) and warms up the
cell's shapes. The window runs the traffic's loop for ``seconds``. With
``trace`` the telemetry of the system (``repro_torch.obs`` spans) is on
for the window and ``torch.profiler`` traces its last
``TRACE_SECONDS``. Then the peak memory is read, the system's state is
freed, and the served sample goes through the plain reference.
"""

from __future__ import annotations

import gc
import json
import os
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from bench import check, counts
from bench.drivers import make_driver
from bench.profile import Profiler
from bench.spec import ROOT, Cell, metric_reader, port_config
from bench.weights import make_weights

# the profiler's window within a traced run's window
TRACE_SECONDS = 5.0
# the profiler range around each decode step of the traced stretch
DECODE_RANGE = "bench.decode_step"
# top-level module names that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class TraceControl:
    """Starts the profiler ``TRACE_SECONDS`` before the window closes
    (at its start when it is shorter) and stops it when the window
    closes, so the trace's own write-out falls outside the window.
    While it traces, each of the system's decode steps runs inside a
    ``bench.decode_step`` profiler range, and ``work`` counts those
    steps and their rows (lanes, idle ones included): the kernels a
    decode step launched are then told from a prefill's."""

    def __init__(self, enabled: bool, compiled, out_dir: Path, device):
        self.enabled = enabled
        self.compiled = compiled
        self.device = device
        self.prof = Profiler(out_dir) if enabled else None
        self.active = False
        self.start_at = None
        self.trace = None
        self.work = None

    def begin(self, t0: float, end: float) -> None:
        if self.enabled:
            self.start_at = max(t0, end - TRACE_SECONDS)
            self.after_step(t0)

    def after_step(self, now: float) -> None:
        if self.start_at is not None and not self.active and now >= self.start_at:
            self.start_at = None
            # work queued before the stretch must not run inside it (a
            # lockstep wave does not wait on its decode steps)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._mark_decode_steps()
            self.prof.start()
            self.t0 = time.perf_counter()
            self.active = True

    def _mark_decode_steps(self) -> None:
        step = self.compiled.decode_step
        self.work = [0, 0]

        def decode_step(token, pos, caches):
            self.work[0] += 1
            self.work[1] += int(token.shape[0])
            with torch.profiler.record_function(DECODE_RANGE):
                return step(token, pos, caches)

        self.compiled.decode_step = decode_step

    def end(self, now: float) -> None:
        if not self.active:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self.t0
        del self.compiled.decode_step  # the class's own again
        self.work = tuple(self.work)
        self.active = False
        self.trace = self.prof.stop(window)


class Context:
    """What a metric reader sees."""

    def __init__(self, sz, window, trace, work, spans):
        self.sz = sz
        self.window = window
        self.trace = trace          # profile.DeviceTrace, or None
        self.work = work            # (decode steps, their rows) in the profiled stretch
        self.spans = spans          # name -> [obs Span]
        self.counts = counts

    def median(self, values):
        return statistics.median(values) if values else None


def nvidia_smi() -> dict | None:
    q = "name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return {"query": q, "rows": [line.strip() for line in out.splitlines() if line.strip()]}


def host_probe_ms() -> float:
    """Milliseconds that a fixed stretch of plain Python takes: how fast
    the host runs this process now (the lockstep cell is host paced)."""
    t = time.perf_counter()
    d = {}
    for i in range(200_000):
        d[i & 1023] = i
    return (time.perf_counter() - t) * 1e3


def host_counters() -> dict:
    """The process's CPU seconds and involuntary context switches, and
    the host's stolen CPU time (``/proc/stat``, in seconds over all its
    CPUs), to be differenced across the window."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime, "involuntary_switches": ru.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        out["steal_s"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def commit() -> str | None:
    """The checkout's commit, where it is a git repository."""
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                              text=True, timeout=10, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device, t_start: float,
             smoke: bool = False, out_dir: Path | None = None, control: bool = False) -> dict:
    """Set up, measure, check; ``control`` also reads the check's numbers
    for the control (``bench/readings.py``; never in a benchmark run)."""
    from repro_torch import compiler as compiler_lib
    from repro_torch import obs

    device = torch.device(device)
    out_dir = out_dir or ROOT / "bench_out" / cell.name / f"{seed}_{int(trace)}"
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = port_config(cell.config, smoke=smoke)
    sz = cell.model.sizes(cfg)
    meta = {"workload": cell.name, "seed": seed, "seconds": seconds, "trace": trace,
            "torch": torch.__version__, "cuda": torch.version.cuda, "smoke": smoke,
            "commit": commit()}
    if device.type == "cuda":
        meta["device_name"] = torch.cuda.get_device_name(device)
        meta["device_count"] = torch.cuda.device_count()
        meta["nvidia_smi_before"] = nvidia_smi()
        torch.cuda.reset_peak_memory_stats(device)

    # -- set-up --------------------------------------------------------------
    weights = make_weights(cell.model.layout(sz, cell.config["weights"]), seed, device)
    model = cell.model.build(weights, sz)
    compiled = compiler_lib.compile(
        cfg, model, compiler_lib.HardwareTarget(engine=cell.config["engine"]), device=device)
    driver = make_driver(compiled, cell, seed, sz)
    driver.warmup()
    tracer = TraceControl(trace, compiled, out_dir, device)
    if trace:  # the profiler's own start-up belongs to set-up
        tracer.prof.start()
        tracer.prof.stop(0.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    meta["host_probe_ms_before"] = host_probe_ms()
    host0 = host_counters()

    # -- the window ------------------------------------------------------------
    tel = obs.start() if trace else None
    try:
        window = driver.run(seconds, tracer)
    finally:
        if trace:
            obs.stop()
    host1 = host_counters()
    meta["host_probe_ms_after"] = host_probe_ms()
    meta["window_host"] = {k: host1[k] - host0[k] for k in host1 if k in host0}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        meta["nvidia_smi_after"] = nvidia_smi()
    else:
        peak = 0
    bad = forbidden_modules()
    spans = {}
    if tel is not None:
        for sp in tel.tracer.spans():
            spans.setdefault(sp.name, []).append(sp)
    ctx = Context(sz, window, tracer.trace, tracer.work, spans)
    names = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.per_layer + cell.end_to_end}
    for name in names:
        v = setup_s if name == "setup_s" else metric_reader(name)(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": units[name]}

    # -- the check, with the system's state freed --------------------------------
    kind = cell.limits["kind"]
    if kind == "layerwise":
        captured = driver.capture(-(-int(cell.traffic["check_tokens"]) // driver.gen_len))
    else:
        sequences = driver.sequences()
    driver.release()
    del driver, compiled, model, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if kind == "layerwise":
        judged = captured
        compare = check.layerwise
    else:
        judged = check.sample_sequences(sequences, seed, int(cell.traffic["check_tokens"]))
        compare = check.gaps
    reference = cell.model.Reference
    numbers = compare(reference, weights, sz, cell.config, judged, device)
    control_numbers = compare(reference, weights, sz, cell.config, judged, device,
                              control=True) if control else None
    numbers["failed"] = window["failed"]
    ok, shown = check.judge(numbers, cell.limits)
    shown["failed"] = {"value": window["failed"], "limit": 0}
    ok = ok and window["failed"] == 0

    meta.update({"setup_s": setup_s, "window_s": window["seconds"], "tokens": window["tokens"],
                 "attempted": window["attempted"], "check_numbers": numbers, "peak_bytes": peak})
    for key in ("prefill_s", "decode_step_s"):
        if window.get(key):
            vals = window[key]
            meta[key + "_n"] = len(vals)
            meta[key + "_median"] = statistics.median(vals)
            meta[key + "_max"] = max(vals)
    result = {
        "correct": bool(ok),
        "attempted": int(window["attempted"]),
        "failed": int(window["failed"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": meta.get("device_name", "cpu"),
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace and ctx.trace is not None:
        def top(kernels):
            return dict(sorted(kernels.items(), key=lambda kv: -kv[1][0])[:40])

        meta["trace_kernels"] = top(ctx.trace.kernels)
        meta["trace_within"] = {r: top(k) for r, k in ctx.trace.within.items()}
        meta["trace_work"] = ctx.work
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    result["check"] = shown
    with open(out_dir / "meta.json", "w") as f:
        json.dump(meta, f, indent=1, default=str)
    return {"result": result, "meta": meta, "forbidden": bad, "numbers": numbers,
            "control": control_numbers}

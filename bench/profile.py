"""The device trace of a traced run: ``torch.profiler`` over a window of
the measured loop, exported as a Chrome trace and reduced here to the
numbers the metric readers and the result line take.

* ``busy_s``: the union of the device's kernel, copy and set intervals;
* ``kernels``: seconds and launches per kernel name, and ``within``
  the same for the kernels launched inside each of the harness's own
  profiler ranges (``bench.*``);
* ``device_ops``: the ten names that took most device time;
* ``idle_gaps``: the ten longest stretches with nothing on the device,
  each named by the host operation that launched the work ending it
  (what the host was doing while the device waited).
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the harness's own profiler ranges (``record_function`` names)
RANGE_PREFIX = "bench."


class DeviceTrace:
    def __init__(self, busy_s: float, window_s: float, kernels: dict[str, list[float]],
                 device_ops: list, idle_gaps: list, within: dict | None = None):
        self.busy_s = busy_s
        self.window_s = window_s
        self.kernels = kernels          # name -> [seconds, launches]
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps
        self.within = within or {}      # range -> {name -> [seconds, launches]}

    def kernel_seconds(self, match, within: str | None = None) -> tuple[float, int]:
        """Seconds and launches summed over kernel names ``match(name)``
        accepts; with ``within``, only those launched inside that
        profiler range."""
        kernels = self.kernels if within is None else self.within.get(within, {})
        s, n = 0.0, 0
        for name, (sec, cnt) in kernels.items():
            if match(name):
                s += sec
                n += cnt
        return s, n


def reduce_chrome_trace(path: Path, window_s: float) -> DeviceTrace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = []          # (start_us, end_us, name, correlation)
    launches = {}     # correlation -> runtime call start (us)
    host = []         # (start_us, end_us, name) of host operations
    ranges: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"], e.get("args", {}).get("correlation")))
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((ts, ts + dur, e["name"]))
            if cat == "user_annotation" and e["name"].startswith(RANGE_PREFIX):
                ranges.setdefault(e["name"], []).append((ts, ts + dur))
    dev.sort()
    for spans in ranges.values():
        spans.sort()
    within: dict[str, dict[str, list[float]]] = {r: {} for r in ranges}
    kernels: dict[str, list[float]] = {}
    busy = 0.0
    gaps = []         # (seconds, end_event)
    cur_s = cur_e = None
    for s, e, name, corr in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) * 1e-6
        k[1] += 1
        t = launches.get(corr)
        for r, spans in ranges.items():
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1 if t is not None else -1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                w = within[r].setdefault(name, [0.0, 0])
                w[0] += (e - s) * 1e-6
                w[1] += 1
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append(((s - cur_e) * 1e-6, corr, name))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(key=lambda g: -g[0])
    host.sort()
    starts = [h[0] for h in host]

    def what_host_did(corr, kernel: str) -> str:
        t = launches.get(corr)
        if t is None:
            return f"before {kernel}"
        # the innermost host operation open at the launch
        i = bisect.bisect_right(starts, t)
        best = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            s, e, name = host[j]
            if s <= t <= e and (best is None or s >= best[0]):
                best = (s, name)
                break
        return best[1] if best else f"before {kernel}"

    idle = [[what_host_did(corr, name), sec] for sec, corr, name in gaps[:10]]
    ops = sorted(([n, v[0]] for n, v in kernels.items()), key=lambda x: -x[1])[:10]
    return DeviceTrace(busy * 1e-6, window_s, kernels, ops, idle, within)


class Profiler:
    """``torch.profiler`` over CPU and CUDA activity, started and stopped
    between steps of the measured loop; the Chrome trace goes to
    ``out_dir``."""

    def __init__(self, out_dir: Path):
        self.out_dir = out_dir
        self.prof = None

    def start(self) -> None:
        import torch

        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
            record_shapes=False, with_stack=False, profile_memory=False,
        )
        self.prof.__enter__()

    def stop(self, window_s: float) -> DeviceTrace:
        self.prof.__exit__(None, None, None)
        path = self.out_dir / "device_trace.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        try:
            return reduce_chrome_trace(path, window_s)
        finally:
            path.unlink()

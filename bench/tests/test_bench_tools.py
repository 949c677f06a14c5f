"""The traffic generator, the device-trace reduction and the entry
point's refusal to run without a card."""

import json
import subprocess
import sys
import time
from collections import Counter

import torch

from bench.harness import DECODE_RANGE, TraceControl
from bench.profile import reduce_chrome_trace
from bench.spec import ROOT
from bench.traffic import Stream, Traffic, quantile

BIG = 2**31 + 5


def test_every_whole_block_holds_the_same_sizes_for_every_seed():
    dist = {"dist": "lognormal", "median": 512, "sigma": 0.7, "min": 128, "max": 2048}
    a = Stream(dist, BIG, 1, 64).take(128)
    b = Stream(dist, 7, 1, 64).take(128)
    assert a != b
    assert Counter(a[:64]) == Counter(b[:64]) == Counter(a[64:])
    assert min(a) >= 128 and max(a) <= 2048


def test_quantiles():
    assert quantile({"dist": "uniform", "min": 64, "max": 512}, 0.0) == 64
    assert quantile({"dist": "uniform", "min": 64, "max": 512}, 0.999999) == 512
    assert quantile({"dist": "fixed", "value": 64}, 0.3) == 64
    assert quantile({"dist": "lognormal", "median": 96, "sigma": 0.8, "min": 16,
                     "max": 384}, 0.5) == 96


def test_traffic_is_a_function_of_the_seed():
    params = json.loads((ROOT / "bench/traffic/closed64.json").read_text())
    t1, t2 = Traffic(params, BIG, 1000), Traffic(params, BIG, 1000)
    assert [t1.next_request() for _ in range(5)] == [t2.next_request() for _ in range(5)]
    assert (t1.tokens(3, 20) == t2.tokens(3, 20)).all()
    assert not (t1.tokens(3, 20) == Traffic(params, BIG + 1, 1000).tokens(3, 20)).all()


def test_trace_reduction(tmp_path):
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 20, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "copy", "ts": 25, "dur": 10, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 60, "dur": 60},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 90, "dur": 1,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "add", "ts": 100, "dur": 5, "args": {"correlation": 3}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = reduce_chrome_trace(path, 0.001)
    assert abs(t.busy_s - 30e-6) < 1e-12           # [10, 35] and [100, 105]
    assert len(t.idle_gaps) == 1 and t.idle_gaps[0][0] == "aten::add"
    assert abs(t.idle_gaps[0][1] - 65e-6) < 1e-12
    sec, n = t.kernel_seconds(lambda n: n == "gemm")
    assert abs(sec - 20e-6) < 1e-12 and n == 1
    assert t.device_ops[0][0] == "gemm"


def test_kernels_launched_inside_a_harness_range(tmp_path):
    """A kernel counts within ``bench.decode_step`` when its launch lies
    inside one of the range's intervals, wherever it runs on the device."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.decode_step", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 2, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "fused_bnn_kernel", "ts": 20, "dur": 4,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 30, "dur": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "fused_bnn_kernel", "ts": 40, "dur": 9,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "user_annotation", "name": "bench.decode_step", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 60, "dur": 1,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "fused_bnn_kernel", "ts": 70, "dur": 2,
         "args": {"correlation": 3}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = reduce_chrome_trace(path, 0.001)
    fused = lambda n: "fused_bnn" in n  # noqa: E731
    sec, n = t.kernel_seconds(fused, within="bench.decode_step")
    assert n == 2 and abs(sec - 6e-6) < 1e-12       # launches at 2 and at 60 (the end)
    assert t.kernel_seconds(fused)[1] == 3
    assert t.kernel_seconds(fused, within="bench.prefill") == (0.0, 0)


def test_the_traced_stretch_counts_decode_steps_and_restores_the_entry(tmp_path):
    class System:
        def decode_step(self, token, pos, caches):
            return token, caches

    system = System()
    tc = TraceControl(True, system, tmp_path, torch.device("cpu"))
    t0 = time.perf_counter()
    tc.begin(t0, t0)  # a stretch as long as the window: it starts at once
    for lanes in (4, 4, 3):
        system.decode_step(torch.zeros(lanes), 0, None)
    tc.end(time.perf_counter())
    assert tc.work == (3, 11)
    assert "decode_step" not in vars(system)
    assert DECODE_RANGE in tc.trace.within


def test_entry_point_refuses_to_run_without_a_card():
    r = subprocess.run([sys.executable, str(ROOT / "bench/run.py"), "--workload",
                        "qwen3moe.decode-closed64", "--seed", str(BIG), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr

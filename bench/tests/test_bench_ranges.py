"""The reduction of a device trace by the system's program ranges
(``bench/ranges.py``) on a hand-built Chrome trace, and its tool on the
CPU at a cell's smoke sizes."""

import json

import pytest
from repro_torch import obs

from bench import ranges
from bench.profile import reduce_chrome_trace
from bench.tests.test_bench_cells import CELLS, SEED, smoke_cell


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, corr)


# microseconds. Host: a serving tick [0, 100] (scheduler.step > decode_tick
# [10, 90] > model.decode_step [20, 60] > moe.experts [30, 40], lm.head
# [45, 55]); a lockstep step [120, 150]; a prefill [200, 260] with its
# experts [210, 230]. Device: six launches inside ranges, one outside.
EVENTS = [
    _x("cpu_op", "aten::whole", 0, 270),
    _x("user_annotation", "scheduler.step", 0, 100),
    _x("user_annotation", "decode_tick", 10, 80),
    _x("user_annotation", "bench.decode_step", 15, 50),
    _x("user_annotation", "model.decode_step", 20, 40),
    _x("user_annotation", "moe.experts", 30, 10),
    _x("user_annotation", "lm.head", 45, 10),
    _x("user_annotation", "bench.decode_step", 115, 40),
    _x("user_annotation", "model.decode_step", 120, 30),
    _x("user_annotation", "model.prefill", 200, 60),
    _x("user_annotation", "moe.experts", 210, 20),
    _x("gpu_user_annotation", "model.decode_step", 30, 55),
    _launch(25, 1), _x("kernel", "fused_bnn_kernel", 30, 20, 1),
    _launch(35, 2), _x("kernel", "gemm", 50, 30, 2),
    _launch(50, 3), _x("kernel", "head", 80, 5, 3),
    _launch(95, 4), _x("gpu_memcpy", "Memcpy DtoH", 95, 5, 4),
    _launch(125, 5), _x("kernel", "fused_bnn_kernel", 130, 10, 5),
    _launch(160, 6), _x("gpu_memset", "Memset", 170, 2, 6),
    _launch(215, 7), _x("kernel", "gemm", 220, 20, 7),
]
WINDOW_S = 270e-6


def _approx(got: dict, want: dict):
    assert set(got) == set(want), (got, want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12), k


def test_launches_belong_to_every_range_open_at_launch():
    rt = ranges.reduce_ranges(EVENTS, obs.RANGES)
    assert rt.count("model.decode_step") == 2 and rt.count("moe.experts") == 2
    assert rt.count("bench.decode_step") == 0       # not a program range
    assert rt.within("model.decode_step") == (pytest.approx(65e-6), 4)
    assert rt.within("moe.experts") == (pytest.approx(50e-6), 2)
    assert rt.within("model.decode_step", "moe.experts") == (pytest.approx(30e-6), 1)
    assert rt.within("scheduler.step")[1] == 4      # the copy after the step too
    assert rt.within("model.prefill", "lm.head") == (0.0, 0)
    assert rt.within() == (pytest.approx(92e-6), 7)
    assert rt.device[()] == {"Memset": [pytest.approx(2e-6), 1]}
    assert rt.host_s("model.decode_step") == pytest.approx([40e-6, 30e-6])
    assert rt.launches_each("model.decode_step") == [3, 1]
    assert rt.launches_each("scheduler.step") == [4] and rt.launches_each("remap") == []


def test_idle_time_splits_by_the_innermost_range_open():
    """Idle stretches [0, 30], [85, 95] (across decode_tick's end), [100,
    130] (from no range into a step), [140, 170], [172, 220] (from no
    range into a prefill and its experts) and [240, 270]."""
    rt = ranges.reduce_ranges(EVENTS, obs.RANGES)
    _approx(rt.idle_by_range(), {
        "scheduler.step": 15e-6, "decode_tick": 15e-6, "model.decode_step": 30e-6,
        "model.prefill": 30e-6, "moe.experts": 10e-6, "none": 78e-6})
    assert sum(rt.idle.values()) == pytest.approx(270e-6 - 92e-6)
    assert rt.idle_within("model.decode_step") == pytest.approx(30e-6)
    assert rt.idle_within("scheduler.step") == pytest.approx(40e-6)


def test_the_four_readings():
    rt = ranges.reduce_ranges(EVENTS, obs.RANGES)
    assert ranges.launches_per_step(rt) == 2.0
    assert ranges.dispatch_ms(rt) == pytest.approx(0.035)
    assert ranges.idle_in_step_share(rt, WINDOW_S) == pytest.approx(100 * 30 / 270)
    assert ranges.moe_experts_ms(rt) == pytest.approx(0.015)
    # the device's whole idle share, which the step's share never passes
    assert 100 * sum(rt.idle.values()) / WINDOW_S == pytest.approx(100 * 178 / 270)


def test_the_first_steps_lost_device_records_do_not_move_the_launch_count():
    """The profiler drops the device records of the first launches after
    it starts (their runtime calls stay): that step reads short, and
    the count per step is the median's."""
    ev = []
    for i, t in enumerate((0, 100, 200)):
        ev.append(_x("user_annotation", "model.decode_step", t, 50))
        for j in (1, 2):
            corr = 10 * i + j
            ev.append(_launch(t + 10 * j, corr))
            if (i, j) != (0, 1):
                ev.append(_x("kernel", "k", t + 10 * j + 5, 2, corr))
    rt = ranges.reduce_ranges(ev, obs.RANGES)
    assert rt.launches_each("model.decode_step") == [1, 2, 2]
    assert ranges.launches_per_step(rt) == 2


def test_missing_ranges_read_nothing():
    bare = [e for e in EVENTS if e["cat"] != "user_annotation"]
    rt = ranges.reduce_ranges(bare, obs.RANGES)
    assert rt.within() == (pytest.approx(92e-6), 7)
    assert rt.idle_by_range() == {"none": pytest.approx(178e-6)}
    for read in (ranges.launches_per_step, ranges.dispatch_ms, ranges.moe_experts_ms):
        assert read(rt) is None
    assert ranges.idle_in_step_share(rt, WINDOW_S) is None
    dense = [e for e in EVENTS if e["name"] != "moe.experts"]
    assert ranges.moe_experts_ms(ranges.reduce_ranges(dense, obs.RANGES)) is None


def test_a_child_outlasting_its_parent_is_cut_at_the_parents_end():
    segs = ranges._segments([(0, 10, "a"), (5, 12, "b"), (20, 30, "c")])
    assert segs == [(float("-inf"), 0, ()), (0, 5, ("a",)), (5, 10, ("a", "b")),
                    (10, 20, ()), (20, 30, ("c",)), (30, float("inf"), ())]


def test_readings_beside_the_harness_range(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    r = ranges.readings(ranges.reduce_ranges(EVENTS, obs.RANGES),
                        reduce_chrome_trace(path, WINDOW_S))
    assert r["fused_launches"] == {"model.decode_step": 2, "bench.decode_step": 2}
    assert r["steps"] == 2 and r["launches_per_step.decode"] == 2.0
    assert r["launches_by_step"] == {1: 1, 3: 1}
    assert r["busy_ms_per_step"] == pytest.approx(0.046)
    assert r["device_by_range"]["none"] == [pytest.approx(2e-6), 1]
    assert list(r["idle_by_range"])[0] == "none"


@pytest.mark.parametrize("name", CELLS)
def test_the_tool_on_a_smoke_cell(name, tmp_path):
    """A traced run through the tool: the run's own result line, and as
    many ``model.decode_step`` ranges as the harness counted steps."""
    (line,) = ranges.traced_runs(smoke_cell(name), [SEED], 1.5, device="cpu", smoke=True,
                                 out_dir=tmp_path)
    assert line["result"]["correct"] and line["traced_decode_tok_s"] > 0
    r = line["ranges"]
    assert r["steps"] == line["trace_work"][0] > 0
    assert r["dispatch_ms.decode"] > 0
    assert r["launches_per_step.decode"] == 0.0     # no device on the CPU
    moe = name.startswith("qwen3moe")
    assert ("moe.experts" in r["range_counts"]) == moe
    assert ("scheduler.step" in r["range_counts"]) == moe
    assert r["range_counts"]["lm.head"] >= r["steps"]

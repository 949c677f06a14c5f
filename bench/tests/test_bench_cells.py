"""Each cell's path end to end on the CPU at the configuration's smoke
sizes (the kernels' plain versions), the reference against the system,
the control, and the faults the check has to catch."""

import time
from pathlib import Path

import pytest
import torch

from bench import check, harness
from bench.spec import load_cell

SEED = 2**31 + 11  # more than 32 signed bits hold, as the benchmark's seeds may

CELLS = ("qwen3moe.decode-closed64", "internvl2.caption-batch32")


def smoke_cell(name: str):
    """The cell with its traffic cut to what the CPU runs in seconds."""
    cell = load_cell(name)
    t = dict(cell.traffic)
    if t["loop"] == "closed":
        t.update(clients=4, slots=4, max_len=64, check_tokens=24,
                 prompt={"dist": "uniform", "min": 8, "max": 24},
                 output={"dist": "uniform", "min": 4, "max": 8})
    else:
        t.update(batch=3, waves_ready=2, check_tokens=10,
                 prompt={"dist": "uniform", "min": 4, "max": 8},
                 output={"dist": "fixed", "value": 5})
    cell.traffic = t
    return cell


def run(cell, tmp_path: Path, trace: bool = False, control: bool = False, seconds: float = 1.5):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu", t_start=time.perf_counter(),
                            smoke=True, out_dir=tmp_path, control=control)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, tmp_path):
    out = run(smoke_cell(name), tmp_path)
    r = out["result"]
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert list(r)[-1] == "check"
    assert (tmp_path / "meta.json").is_file()


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_system_passes(name, tmp_path):
    """The reference at the precision below the configuration's, in the
    system's place, reads far above the system on the same sample."""
    out = run(smoke_cell(name), tmp_path, control=True)
    sound, low = out["numbers"], out["control"]
    key = "sublayer_err" if "sublayer_err" in sound else "missed_share"
    assert low[key] > 3 * sound[key], (sound, low)
    ok, _ = check.judge(low | {"replay_mismatch": 0}, load_cell(name).limits)
    assert not ok


def test_altered_tokens_are_caught_on_the_request_path(tmp_path, monkeypatch):
    from repro_torch.serving import scheduler

    emit = scheduler.RequestState.emit
    vocab = 256  # the smoke configuration's

    def altered(self, token):
        emit(self, (int(token) + 1) % vocab)

    monkeypatch.setattr(scheduler.RequestState, "emit", altered)
    assert not run(smoke_cell("qwen3moe.decode-closed64"), tmp_path)["result"]["correct"]


def test_altered_tokens_are_caught_on_the_lockstep_path(tmp_path, monkeypatch):
    from repro_torch.models import lm

    logits = lm._logits

    def altered(model, h, cfg):
        return torch.roll(logits(model, h, cfg), 1, dims=-1)

    monkeypatch.setattr(lm, "_logits", altered)
    assert not run(smoke_cell("internvl2.caption-batch32"), tmp_path)["result"]["correct"]


def test_a_sublayer_left_out_is_caught(tmp_path, monkeypatch):
    """A layer whose FFN adds nothing reads as far off as the control."""
    from repro_torch.models import lm

    monkeypatch.setattr(lm, "ffn", lambda p, x, quant="none", engine=None: torch.zeros_like(x))
    out = run(smoke_cell("internvl2.caption-batch32"), tmp_path)
    assert not out["result"]["correct"]
    assert out["numbers"]["sublayer_err"] >= 1.0


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_per_layer_metrics(name, tmp_path):
    cell = smoke_cell(name)
    r = run(cell, tmp_path, trace=True)["result"]
    assert r["correct"]
    assert "breakdown" in r and {"busy_s", "window_s"} <= set(r["device"])
    expected = {m["name"] for m in cell.per_layer}
    assert set(r["metrics"]) <= expected
    # the CPU has no device trace: only host-clock and span metrics read
    for name_ in r["metrics"]:
        src = next(m["source"] for m in cell.per_layer if m["name"] == name_)
        assert src != "device_trace"

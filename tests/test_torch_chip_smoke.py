"""``chip_smoke.py`` on the CPU: without a card it exits non-zero and
prints no result, and its serve phase rehearses at smoke size through
the kernels' plain versions (the same checks the card run makes, bar
the launch counts)."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_serve_phase_rehearses_on_cpu(capsys):
    launches = _chip_smoke().serve_phase(device="cpu", smoke=True)
    assert launches == {"fused_bnn_matmul": 0, "hamming_matmul": 0}
    out = capsys.readouterr().out
    assert "packed == reference: all 256 tokens" in out
    assert "request path: 16 requests" in out


def test_kernel_summary_has_every_key():
    cs = _chip_smoke()
    rec = {(s, 8): {"ms": 1.0, "plain_ms": 2.0, "library_ms": 3.0, "bytes_ms": 0.1, "ops_ms": 0.2}
           for s in cs.SHAPES}
    summary = cs.kernel_summary(
        {"records": {"fused_bnn_matmul": rec, "hamming_matmul": rec},
         "worst": {"fused_bnn_matmul": 0.0, "hamming_matmul": 0.0}},
        {"fused_bnn_matmul": 3520, "hamming_matmul": 4928},
    )
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [k["name"] for k in summary] == ["fused_bnn_matmul", "hamming_matmul"]
    for k in summary:
        assert keys <= set(k)
        assert (ROOT / k["source"]).is_file()
        assert (ROOT / k["replaces"].split(":")[0]).is_file()
    assert summary[0]["ms"] == 5.0 and summary[1]["bound_ms"] == pytest.approx(1.4)


def test_serve_pallas_phase_rehearses_on_cpu(capsys):
    """The flash-attention serve phase at smoke size: packed == reference
    with ``attn_impl="pallas"``, the continuation equal to the full
    prefill, and a 2-replica fleet that grafts and equals one engine."""
    assert _chip_smoke().serve_pallas_phase(device="cpu", smoke=True) == 0
    out = capsys.readouterr().out
    assert "packed == reference: all 256 tokens and the prefill logits" in out
    assert "prefill_continue over 256 of 320 tokens == prefill" in out
    assert "tokens == single engine" in out


def test_row_count_check_rehearses_on_cpu(capsys):
    assert not any(_chip_smoke().row_count_check(device="cpu").values())
    assert "[rows] max |diff| of rows computed alone" in capsys.readouterr().out


def test_entry_point_phase_rehearses_on_cpu(capsys):
    assert _chip_smoke().entry_point_phase(device="cpu") == {"bitlinear": 0, "wdm_mmm": 0}
    assert "== dense oracles at 7 shapes" in capsys.readouterr().out


def test_launch_summary_has_every_key():
    cs = _chip_smoke()
    rec = {"ms": 1.0, "plain_ms": 2.0, "library_ms": 3.0, "bytes_ms": 0.1, "ops_ms": 0.2}
    summary = cs.launch_summary(
        {"records": {cs.FLASH_MAIN: rec}, "worst": 0.5},
        {"bitlinear": {cs.MMA_MAIN: rec}, "wdm_mmm": {cs.MMA_MAIN: rec}},
        {"flash_attention": 704, "bitlinear": 7, "wdm_mmm": 7},
    )
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [k["name"] for k in summary] == ["flash_attention", "bitlinear", "wdm_mmm"]
    for k in summary:
        assert keys <= set(k)
        assert (ROOT / k["source"]).is_file()
        path, line = k["replaces"].split(":")
        assert "pallas_call" in (ROOT / path).read_text() and int(line) > 0
    assert summary[0]["launches"] == 704 and summary[0]["bound_by"] == "operations"

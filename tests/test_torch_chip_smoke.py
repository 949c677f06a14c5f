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
    rec = {(s, 8): {"ms": 1.0, "eager_ms": 4.0, "plain_ms": 2.0, "library_ms": 3.0,
                    "bytes_ms": 0.1, "ops_ms": 0.2}
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
    rec = {"ms": 1.0, "eager_ms": 4.0, "plain_ms": 2.0, "library_ms": 3.0, "bytes_ms": 0.1,
           "ops_ms": 0.2}
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


def test_mma_cases_cover_both_variants_and_the_k_edge():
    """check_mma's ragged case can only take the WMMA variant; its edge
    case takes the sm90 variant with m past a whole number of k tiles."""
    from repro_torch.kernels import mma_plan

    cs = _chip_smoke()
    rows, m, n = cs.MMA_RAGGED
    assert not mma_plan.tma_ok(rows, m, n, 2, (0,))
    rows, m, n = cs.MMA_EDGE
    assert mma_plan.tma_ok(rows, m, n, 2, (0,)) and m % mma_plan.BK != 0
    assert cs.MMA_MAIN[0] in cs.MMA_SHAPES


def test_unknown_arguments_are_refused(capsys):
    assert _chip_smoke().main(["--no-such-flag"]) == 2
    assert "usage" in capsys.readouterr().err


def test_only_modes_name_known_kernel_groups(capsys):
    cs = _chip_smoke()
    assert set(cs.ONLY) == {"--mma-only", "--flash-only", "--hamming-only", "--fused-only",
                           "--kernels-only"}
    for groups in cs.ONLY.values():
        assert set(groups) <= {"fused", "hamming", "flash", "mma"}
    assert cs.main(["--flash-only", "--mma-only"]) == 2
    assert "usage" in capsys.readouterr().err


def test_summaries_carry_launches_by_variant():
    """The kernels line reports, for each kernel, the launches of each
    variant on its path (filled in by the serve and entry-point phases)."""
    cs = _chip_smoke()
    cs.BY_VARIANT.update({"hamming_matmul": {"popc": 0, "b1": 4928},
                          "flash_attention": {"fma": 0, "sm90": 352},
                          "fused_bnn_matmul": {"popc": 0, "b1": 3520}})
    rec = {"ms": 1.0, "eager_ms": 4.0, "plain_ms": 2.0, "library_ms": 3.0, "bytes_ms": 0.1,
           "ops_ms": 0.2}
    ham = cs.kernel_summary(
        {"records": {k: {(s, 8): rec for s in cs.SHAPES}
                     for k in ("fused_bnn_matmul", "hamming_matmul")},
         "worst": {"fused_bnn_matmul": 0.0, "hamming_matmul": 0.0}},
        {"fused_bnn_matmul": 3520, "hamming_matmul": 4928})
    flash = cs.launch_summary(
        {"records": {cs.FLASH_MAIN: rec}, "worst": 0.5},
        {"bitlinear": {cs.MMA_MAIN: rec}, "wdm_mmm": {cs.MMA_MAIN: rec}},
        {"flash_attention": 352, "bitlinear": 7, "wdm_mmm": 7})
    by_name = {k["name"]: k for k in ham + flash}
    assert by_name["hamming_matmul"]["launches_by_variant"] == {"popc": 0, "b1": 4928}
    assert by_name["flash_attention"]["launches_by_variant"] == {"fma": 0, "sm90": 352}
    assert by_name["fused_bnn_matmul"]["launches_by_variant"] == {"popc": 0, "b1": 3520}
    assert all("launches_by_variant" in k and "eager_ms" in k for k in by_name.values())
    # the b1 tensor cores' measured rate sets the Hamming kernel's operation bound
    assert cs.B1_BITOPS_PER_S > 32 * cs.POPC_PER_CLOCK_PER_SM * 132 * 1.98e9


def test_fused_bound_is_bytes_on_the_binary_tensor_cores():
    """The fused kernel's operation bound counts bit pairs at the b1 tensor
    cores' rate, as the Hamming kernel's does, so one decode-tick layer is
    bound by its bytes: ~6.4 MB, 0.0019 ms at 3.35 TB/s."""
    cs = _chip_smoke()
    t_bytes = t_ops = 0.0
    for shape in cs.LAYER_FUSED:
        m, n = cs.SHAPES[shape]
        nbytes, bit_ops = cs.packed_work("fused_bnn_matmul", 8, m, n)
        assert bit_ops == 8 * n * -(-m // 32) * 32
        assert cs.packed_work("hamming_matmul", 8, m, n)[1] == bit_ops
        t_bytes += nbytes / cs.HBM_BYTES_PER_S * 1e3
        t_ops += bit_ops / cs.B1_BITOPS_PER_S * 1e3
    assert t_bytes == pytest.approx(0.0019, abs=5e-5) and t_ops < t_bytes / 10
    rows = 1024  # at the lockstep prefill too
    m, n = cs.SHAPES["w1/w3"]
    nbytes, bit_ops = cs.packed_work("fused_bnn_matmul", rows, m, n)
    assert nbytes / cs.HBM_BYTES_PER_S > bit_ops / cs.B1_BITOPS_PER_S


def test_fused_edge_case_is_b1_with_a_partial_word_and_k_stage():
    """check_fused_edges' shape takes the b1 variant in bf16 and fp32, with
    m past a whole word, kw past a whole 8-word k stage and n % 128 != 0;
    the ragged and block-padded cases keep the popc variant."""
    from repro_torch.kernels import mma_plan

    cs = _chip_smoke()
    rows, m, n = cs.FUSED_EDGE
    kw = -(-m // 32)
    assert m % 32 and kw % mma_plan.HAM_BKW and n % mma_plan.HAM_BN
    for x_size in (2, 4):
        assert mma_plan.fused_tma_ok(rows, m, n, m, x_size, n, (0,))
        plan = mma_plan.fused_plan(rows, m, n, x_size)
        kt = -(-m // mma_plan.FUSED_FEATURES)
        assert plan.split > 1 and kt % -(-kt // plan.split)  # a last split of fewer stages
    for m_ in (100, 300):  # bf16 rows of 200 and 600 bytes
        assert not mma_plan.fused_tma_ok(3, m_, 48, m_, 2, 128, (0,))


def test_fused_only_runs_the_device_phase_first(capsys):
    """``--fused-only`` is a known argument: without a card it gets as far
    as the device check (a SystemExit), not the usage error."""
    cs = _chip_smoke()
    assert ("fused",) == cs.ONLY["--fused-only"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cs.main(["--fused-only"])
    assert e.value.code != 0
    assert "usage" not in capsys.readouterr().err


def test_special_bits_equal_the_reference():
    """The bits chip_smoke holds the kernels to on signed zeros, NaN,
    subnormals and -2^-126 are the JAX package's ``x >= 0`` under XLA
    (subnormals read as zero), in bf16 and fp32; ``with_specials`` places
    every kind and its sign."""
    import jax.numpy as jnp
    import numpy as np

    cs = _chip_smoke()
    for dtype in (jnp.bfloat16, jnp.float32):
        values = jnp.asarray([v for v, _ in cs.SPECIAL_BITS], jnp.float32).astype(dtype)
        assert np.asarray(values >= 0).tolist() == [bool(b) for _, b in cs.SPECIAL_BITS]
    x = torch.randn((3, 4 * cs.SPECIAL_STRIDE)).to(torch.bfloat16)
    xs, signs = cs.with_specials(x)
    assert int(xs.isnan().sum()) == 3 * 9 and int((signs == 1).sum() + (signs == -1).sum()) == xs.numel()
    assert torch.equal(signs[:, 8], torch.full((3,), -1.0, dtype=torch.bfloat16))  # -2^-126
    assert torch.equal(signs[:, 5], torch.ones(3, dtype=torch.bfloat16))  # -2^-133


def test_telemetry_phase_rehearses_on_cpu(tmp_path, capsys):
    """The telemetry phase at smoke size: the request path and the fleet
    traced, tokens == untraced, spans and counters == stats, and the
    Chrome traces and metrics snapshots written and parsed."""
    import json

    res = _chip_smoke().telemetry_phase(device="cpu", smoke=True, out=tmp_path)
    out = capsys.readouterr().out
    assert "request path, 16 requests into 8 slots: traced tokens == untraced" in out
    assert "fleet, 2 replicas x 8 slots, flash: traced tokens == untraced" in out
    assert "(12 grafted, 3072 tokens == FleetStats)" in out
    assert set(res) == {"requests", "fleet"}
    assert res["fleet"]["prefill grafted ms"] > 0 and res["requests"]["decode_tick ms"] > 0
    for run in ("requests", "fleet"):
        assert json.loads((tmp_path / run / "trace.json").read_text())["traceEvents"]
        assert "repro_decode_ticks_total" in (tmp_path / run / "metrics.txt").read_text()


def test_telemetry_only_runs_the_device_phase_first(capsys):
    """``--telemetry-only`` is a known argument: without a card it gets as
    far as the device check (a SystemExit), not the usage error."""
    cs = _chip_smoke()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cs.main(["--telemetry-only"])
    assert e.value.code != 0
    assert "usage" not in capsys.readouterr().err
    assert cs.main(["--telemetry-only", "--fused-only"]) == 2


def test_simulators_phase_rehearses_on_cpu(tmp_path, capsys):
    """The simulators phase at smoke size: every crossbar engine's tokens
    == packed's and prefill logits == the reference engine's, wdm over
    flash, 8 slots == alone with the crosscheck printed, the modeled
    pricing labelled, and the JSON line."""
    import json

    res = _chip_smoke().simulators_phase(device="cpu", smoke=True, out_dir=tmp_path)
    out = capsys.readouterr().out
    engines = [r["engine"] for r in res["simulators"]]
    assert engines == ["tacitmap", "wdm", "tiled", "custbinarymap", "wdm"]
    for name in ("tacitmap", "wdm", "tiled", "custbinarymap"):
        assert f"[simulators] {name} (" in out
    assert out.count("tokens == packed, prefill logits == reference") == 4
    assert "wdm over flash" in out and "8 requests in 8 slots (K=8) == each alone" in out
    assert "measured_us  modeled_ns" in out
    assert "[simulators] modeled, not measured: [price] tinyllama-smoke on EinsteinBarrier" in out
    assert "slot0.ffn.w2" in (tmp_path / "describe.txt").read_text()
    line = next(ln for ln in out.splitlines() if ln.startswith('{"simulators"'))
    assert json.loads(line) == json.loads(json.dumps(res))


def test_simulators_only_runs_the_device_phase_first(capsys):
    """``--simulators-only`` is a known argument: without a card it gets
    as far as the device check (a SystemExit), not the usage error."""
    cs = _chip_smoke()
    assert cs.ALONE["--simulators-only"] == "simulators"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cs.main(["--simulators-only"])
    assert e.value.code != 0
    assert "usage" not in capsys.readouterr().err

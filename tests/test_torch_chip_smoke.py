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


def test_faults_phase_rehearses_on_cpu(capsys):
    """The faults phase at smoke size: null injection == plain packed,
    faulty packed == faulty tacitmap with the logits changed, the probe
    executed == cheap, one remap with every request == alone, the paper
    MLP/LeNet on four engines == reference, the multi-level gates, and
    the JSON line."""
    import json

    res = _chip_smoke().faults_phase(device="cpu", smoke=True)
    out = capsys.readouterr().out
    assert "(a) null FaultModel on packed: prefill and 31 ticks' logits and tokens == plain" in out
    assert "== tacitmap under the same model, every step's logits and tokens bit for bit" in out
    assert "w1 probe executed == cheap" in out
    assert "remaps=1, quarantined=[0], degraded=False" in out
    assert "8 requests in 8 slots == each alone on packed" in out
    assert out.count("packed, tacitmap, wdm, custbinarymap == reference bit for bit") == 2
    assert "(e) multi-level sweep" in out and "hold" in out
    assert res["live"]["tokens_changed"] > 0 and res["tolerance"]["restarted"] >= 1
    assert res["live"]["peak_gib"] is None  # a CPU run measures no device memory
    line = next(ln for ln in out.splitlines() if ln.startswith('{"faults"'))
    assert json.loads(line) == {"faults": json.loads(json.dumps(res))}


def test_faults_only_runs_the_device_phase_first(capsys):
    """``--faults-only`` is a known argument: without a card it gets as
    far as the device check (a SystemExit), not the usage error."""
    cs = _chip_smoke()
    assert cs.ALONE == {"--telemetry-only": "telemetry", "--simulators-only": "simulators",
                        "--faults-only": "faults", "--train-only": "train",
                        "--train-breadth-only": "train breadth", "--breadth-only": "breadth",
                        "--frontends-only": "frontends", "--distributed-only": "distributed",
                        "--dryrun-only": "dryrun", "--decode-graph-only": "decode graph"}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cs.main(["--faults-only"])
    assert e.value.code != 0
    assert "usage" not in capsys.readouterr().err
    assert cs.main(["--faults-only", "--telemetry-only"]) == 2


def test_train_phase_rehearses_on_cpu(capsys):
    """The train phase at smoke size: 12 steps with one async checkpoint
    and a falling loss; at (up to) 4 layers a clean run, and resume ==
    that run after a fault and after a SIGTERM; the trained model served
    on packed == reference and left alone by a later step, the paper MLP
    trained and read out on four engines, and the JSON line."""
    import json

    res = _chip_smoke().train_phase(device="cpu", smoke=True)
    out = capsys.readouterr().out
    assert "[train] (a) tinyllama-smoke quant=bnn, 12 steps of 8 x 64 tokens" in out
    assert "[train] fault at restart 1: injected node failure; resuming from checkpoint" in out
    assert out.count("[train] resumed from step") == 2
    assert "[train] preempted at step 5; checkpointed" in out
    assert "torch.equal to the clean run's in both" in out
    assert len(res["a"]["save_ms"]) == 1 and len(res["b"]["save_ms"]) == 3
    assert res["b"]["layers"] == 2  # the smoke config's, under RESUME_LAYERS
    assert "8 prompts x 16 ticks, tokens and prefill logits equal" in out
    assert "left both compiled models' prefill logits as they were" in out
    assert "reference == packed, tacitmap, wdm bit for bit" in out
    assert res["d"]["accuracy"] > 0.5 and res["b"]["leaves"] == 37
    assert res["a"]["peak_gib"] is None and res["fused_bnn_matmul"] == 0  # CPU: not read
    line = next(ln for ln in out.splitlines() if ln.startswith('{"train"'))
    assert json.loads(line) == {"train": json.loads(json.dumps(res))}


def test_train_only_runs_the_device_phase_first(capsys):
    """``--train-only`` is a known argument: without a card it gets as far
    as the device check (a SystemExit), not the usage error."""
    cs = _chip_smoke()
    assert cs.ALONE["--train-only"] == "train"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cs.main(["--train-only"])
    assert e.value.code != 0
    assert "usage" not in capsys.readouterr().err


def test_breadth_phase_rehearses_on_cpu(capsys):
    """The breadth phase at smoke size: qwen3-moe on both attention
    paths, mamba2 and jamba, each packed == reference on the lockstep
    batch, 8 slots == alone and evict/restore unchanged; mamba2 launches
    nothing; jamba refuses a continuation and serves a fleet with no
    graft; qwen3-moe's attention on both paths agrees within ATTN_TOL;
    and the JSON line."""
    import json

    res = _chip_smoke().breadth_phase(device="cpu", smoke=True)
    out = capsys.readouterr().out
    for what in ("(a) qwen3-moe-smoke 2 layers attn=jnp", "(a) qwen3-moe-smoke 2 layers attn=pallas",
                 "(b) mamba2-smoke 2 layers", "(c) jamba-smoke"):
        assert f"[breadth] {what} reference lockstep" in out
        assert "packed == reference: all 256 tokens and the prefill logits bit for bit" in out
        assert f"[breadth] {what} request path: 8 requests" in out
    assert "(prompts 1-96, gen 32)" in out and "every request == alone" in out
    assert "[breadth] (b) mamba2-smoke launched no kernel" in out
    assert "[breadth] (a) qwen3-moe-smoke attn=pallas vs attn=jnp: one layer's attention" in out
    assert res["a_pallas"]["attn_vs_jnp"] <= _chip_smoke().ATTN_TOL
    assert 0 <= res["a_pallas"]["tokens_equal_jnp"] <= 8 * 32
    assert "prefill_continue refused" in out and "no graft (prefix hits 0, grafted 0)" in out
    assert res["b"]["requests"]["evictions"] >= 1
    assert res["fused_bnn_matmul"] == res["flash_attention"] == 0  # CPU: no kernel launch
    line = next(ln for ln in out.splitlines() if ln.startswith('{"breadth"'))
    assert json.loads(line) == {"breadth": json.loads(json.dumps(res))}


def test_breadth_fused_launches_per_step():
    cs = _chip_smoke()
    from repro_torch.configs import get_config, get_smoke_config

    assert cs._fused_per_step(get_smoke_config("jamba-1.5-large-398b")) == 2 + 3 + 3
    assert cs._fused_per_step(get_config("mamba2-2.7b")) == 0
    assert cs._fused_per_step(get_smoke_config("qwen3-moe-235b-a22b")) == 2 * 2
    assert cs._fused_per_step(get_config("tinyllama-1.1b")) == 22 * 5


def test_breadth_only_runs_the_device_phase_first(capsys):
    cs = _chip_smoke()
    assert cs.ALONE["--breadth-only"] == "breadth"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cs.main(["--breadth-only"])
    assert e.value.code != 0
    assert "usage" not in capsys.readouterr().err


def test_frontends_phase_rehearses_on_cpu(capsys):
    """The frontends phase at smoke size: seamless on both attention paths
    (packed == reference, decode == prefill within its bound and each
    planted decode fault beyond it, the encoder's, the cross-attention's
    and the decoder self-attention's flash == plain ops), internvl2
    with its patches on both paths (packed == reference, the request path
    with one preemption == alone), and the JSON line."""
    import json

    cs = _chip_smoke()
    res = cs.frontends_phase(device="cpu", smoke=True)
    out = capsys.readouterr().out
    for impl in ("jnp", "pallas"):
        assert (f"[frontends] (a) seamless-smoke 2+2 layers attn={impl}: packed == reference: all "
                f"256 tokens and the prefill logits bit for bit") in out
        what = f"(b) internvl2-smoke 2 layers + 8 patches attn={impl}"
        assert f"[frontends] {what} reference lockstep" in out
    # the request path and the profiled tick run once, on the jnp path
    assert "[frontends] (b) internvl2-smoke 2 layers + 8 patches attn=jnp request path: 8 " in out
    assert res["b_jnp"]["requests"]["evictions"] >= 1 and "requests" not in res["b_pallas"]
    assert out.count("[profile] decode tick") == 2
    assert "over 16 frames gen=32" in out and "every request == alone" in out
    assert "decode at position 127 vs a prefill of 128 tokens" in out
    dvp = res["a_decode_vs_prefill"]
    assert dvp["max_abs_diff"] <= dvp["bound"] and dvp["tokens_equal"] == cs.BATCH
    # each planted decode fault lies beyond the bound
    assert len(dvp["faults"]) == 3 and min(dvp["faults"].values()) > dvp["bound"]
    assert dvp["bound"] == cs.DECODE_REL * dvp["max_abs_logit"]
    assert max(res["a_attn_vs_jnp"].values()) <= cs.ATTN_TOL >= res["b_attn_vs_jnp"]
    assert "(key chunk 16; " in out  # 16 smoke frames: one chunk of exactly the frames
    # CPU: no kernel launch, no card, no peak
    assert res["hamming_matmul"] == res["fused_bnn_matmul"] == res["flash_attention"] == 0
    assert res["card"] is None and res["a_jnp"]["packed"]["peak_gib"] is None
    line = next(ln for ln in out.splitlines() if ln.startswith('{"frontends"'))
    assert json.loads(line) == {"frontends": json.loads(json.dumps(res))}


def test_frontends_launches_per_step():
    """432 Hamming launches per seamless prefill and 216 per tick at full
    depth; the flash cases cover the phase's four new shapes."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config

    assert cs._hamming_per_step(get_config("seamless-m4t-large-v2")) == (24 * 7 + 24 * 11, 24 * 9)
    assert cs._fused_per_step(get_config("internvl2-1b")) == 24 * 5
    labels = {c[0]: c[1:] for c in cs.FLASH_CASES}
    assert labels["seamless encoder"] == (8, 16, 16, 512, 512, 64, False)
    assert labels["seamless cross"] == (8, 16, 16, 128, 512, 64, False)
    assert labels["seamless decoder self"] == (8, 16, 16, 128, 128, 64, True)
    assert labels["internvl2 prefill"] == (8, 14, 2, 384, 384, 64, True)
    assert cs.HAMMING_ONLY == (("seamless-enc-w1/w3 B=4096", 4096, 1024, 8192),)


def test_frontends_only_runs_the_device_phase_first(capsys):
    cs = _chip_smoke()
    assert cs.ALONE["--frontends-only"] == "frontends"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cs.main(["--frontends-only"])
    assert e.value.code != 0
    assert "usage" not in capsys.readouterr().err


def test_train_breadth_phase_rehearses_on_cpu(capsys):
    """The train breadth phase at smoke size: each family's 4 steps with a
    falling loss, a second run equal on every tensor, trained packed ==
    reference, and the JSON line."""
    import json

    cs = _chip_smoke()
    res = cs.train_breadth_phase(device="cpu", smoke=True)
    out = capsys.readouterr().out
    for family, arch, *_ in cs.TRAIN_BREADTH:
        assert res[family]["arch"] == arch and len(res[family]["losses"]) == cs.BREADTH_STEPS
        assert res[family]["losses"][-1] < res[family]["losses"][0]
        assert res[family]["peak_gib"] is None  # CPU: not read
    assert res["enc-dec"]["layers"] == [2, 2] and res["MoE"]["layers"] == [0, 1]
    assert out.count("a second run equal on every parameter and optimizer-state tensor") == 4
    assert res["fused_bnn_matmul"] == res["hamming_matmul"] == 0  # CPU: not read
    line = next(ln for ln in out.splitlines() if ln.startswith('{"train_breadth"'))
    assert json.loads(line) == {"train_breadth": json.loads(json.dumps(res))}


def test_train_breadth_only_runs_the_device_phase_first(capsys):
    """``--train-breadth-only`` is a known argument: without a card it
    gets as far as the device check (a SystemExit), not the usage error."""
    cs = _chip_smoke()
    assert cs.ALONE["--train-breadth-only"] == "train breadth"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cs.main(["--train-breadth-only"])
    assert e.value.code != 0
    assert "usage" not in capsys.readouterr().err


def test_distributed_phase_rehearses_on_cpu(capsys, monkeypatch):
    """The distributed phase at smoke size on gloo: (a) a one-rank group's
    identities, (b) the probe (gloo runs every op on CPU tensors), and in
    a two-rank world (c) EP == moe_ffn within its bound and the planted
    fault beyond it, (d) GPipe == the single-process run bit for bit,
    (e) the compressed all-reduce bit for bit; and the JSON line. The
    ranks import this script by name, so it is registered as a module."""
    import json

    cs = _chip_smoke()
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks share the host with other tests
    res = cs.distributed_phase(device="cpu", smoke=True)
    out = capsys.readouterr().out
    assert res["a"]["backend"] == "gloo" and len(res["a"]["identities"]) == 6
    assert set(res["b"]["transport"].values()) == {"device"}
    assert res["c"]["ep_vs_moe_ffn_max_abs"] <= cs.EP_TOL < res["c"]["fault_max_abs"]
    assert all(r["fault_beyond_bound"] > 0 for r in res["c"]["ranks"])
    assert 0 <= res["c"]["drop_share_default_cap"] < 1
    assert res["d"]["equal"] and [r["layers"] for r in res["d"]["ranks"]] == [[0, 1], [1, 2]]
    assert res["d"]["ranks"][0]["bubble"] == 0.2
    assert all(len(r["ms"]) == 2 for r in res["e"]["ranks"])
    assert res["fused_bnn_matmul"] == 0  # CPU: no kernel launch
    assert "[distributed] (d) GPipe 2 stages" in out and "bit for bit" in out
    line = next(ln for ln in out.splitlines() if ln.startswith('{"distributed"'))
    assert json.loads(line) == {"distributed": json.loads(json.dumps(res))}


def test_distributed_only_runs_the_device_phase_first(capsys):
    cs = _chip_smoke()
    assert cs.ALONE["--distributed-only"] == "distributed"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cs.main(["--distributed-only"])
    assert e.value.code != 0
    assert "usage" not in capsys.readouterr().err


def test_dryrun_phase_rehearses_on_cpu(capsys, monkeypatch):
    """The dryrun phase at smoke size: (b) the traced product FLOPs ==
    the profiler's for one real step (recomputation not stopped early in
    either), (e) the EP layer's traced all-to-all bytes == what a
    two-rank gloo world moved, (f) a production cell's record printed,
    (a) the same record from a child process that sees no card; and the
    JSON line. (c) needs the card's allocator."""
    import json

    cs = _chip_smoke()
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = cs.dryrun_phase(device="cpu", smoke=True)
    out = capsys.readouterr().out
    assert res["a"]["equal"] and "c" not in res
    assert res["b"]["traced_flops"] + res["b"]["traced_row_pad_flops"] == \
        res["b"]["profiled_flops"] > 0
    assert res["b"]["traced_flops_early_stop"] < res["b"]["traced_flops"]
    assert res["e"]["moved_bytes"] == [res["e"]["traced_bytes"]] * 2 and res["e"]["calls"] == [3, 3]
    assert res["f"]["shape"] == "train_4k" and res["f"]["mesh"] == [16, 16]
    assert res["f"]["status"] == "ok" and res["f"]["flops_per_dev"] > 0
    assert res["d"]["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert "== the one traced in a process that sees no card" in out
    assert set(res["a"]["trace_s"]) == {"this process", "no card"}
    line = next(ln for ln in out.splitlines() if ln.startswith('{"dryrun"'))
    assert json.loads(line) == {"dryrun": json.loads(json.dumps(res, default=str))}


def test_a_failed_production_trace_fails_the_dryrun_phase(capsys, monkeypatch):
    """(f) prints a failed trace as the reference's error record and then
    raises: a cell that does not trace on the card's torch fails the
    phase."""
    cs = _chip_smoke()

    def broken(smoke):
        raise RuntimeError("Expected TupleStrategy for aten.index_put")

    monkeypatch.setattr(cs, "_production_record", broken)
    with pytest.raises(AssertionError, match=r"\(f\) the production cell's trace failed"):
        cs._dryrun_cell("tinyllama-smoke", True)
    assert '"status": "error"' in capsys.readouterr().out


def test_dryrun_only_runs_the_device_phase_first(capsys):
    cs = _chip_smoke()
    assert cs.ALONE["--dryrun-only"] == "dryrun"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cs.main(["--dryrun-only"])
    assert e.value.code != 0
    assert "usage" not in capsys.readouterr().err


def test_decode_graph_phase_rehearses_on_cpu(capsys):
    """The decode graph phase at smoke size through the CPU tests' graph
    backend: each stack's graphed steps == eager ones at every step and
    tick, the steps captured once and replayed after."""
    from test_torch_decode_graph import FakeGraphs

    backend = FakeGraphs()
    res = _chip_smoke().decode_graph_phase(device="cpu", smoke=True, backend=backend)
    out = capsys.readouterr().out
    assert out.count("[decode graph] (") == 5 and "logits and caches == eager at every" in out
    # a lockstep wave: one first sight, one capture, replays after
    for key in ("a", "d_ssm", "d_hybrid"):
        assert res[key]["outcomes"] == {"first_sight": 1, "capture": 1, "replay": 5}, key
    for key in ("b", "c"):
        o = res[key]["outcomes"]
        assert o.get("replay", 0) > 0 and sum(o.values()) == res[key]["ticks"], key
    assert backend.replays > 0


def test_decode_graph_only_runs_the_device_phase_first(capsys):
    cs = _chip_smoke()
    assert cs.ALONE["--decode-graph-only"] == "decode graph"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cs.main(["--decode-graph-only"])
    assert e.value.code != 0
    assert "usage" not in capsys.readouterr().err

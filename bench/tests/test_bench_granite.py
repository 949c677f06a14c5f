"""The hybrid cell (``granite4h.decode-closed128``) on the CPU at the
configuration's smoke sizes: its path end to end through the model
module, the control against the system, the counts worked by hand at the
published widths, and the new reader, ``hbm_roofline.decode``."""

import dataclasses

import pytest
import torch

from bench import check, counts
from bench.harness import Context
from bench.models import decoder, granite
from bench.profile import DeviceTrace
from bench.spec import load_cell, metric_reader
from bench.tests.test_bench_cells import run, smoke_cell

CELL = "granite4h.decode-closed128"


def full_sizes() -> dict:
    from repro_torch.configs import get_config

    return granite.sizes(dataclasses.replace(get_config("granite-4.0-h-small"), n_layers=10))


def test_the_cell_runs_through_the_model_module(tmp_path):
    """Correct at the smoke size, and the fp8 control is not."""
    out = run(smoke_cell(CELL), tmp_path, control=True)
    r = out["result"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"setup_s", "decode_tok_s"} <= set(r["metrics"])
    assert list(r)[-1] == "check" and set(r["check"]) == {"missed_share", "failed"}
    assert r["correct"], r["check"]
    sound, low = out["numbers"], out["control"]
    assert sound["tokens"] == low["tokens"] >= 24
    assert low["missed_share"] > 2 * sound["missed_share"], (sound, low)
    assert not check.judge(low, load_cell(CELL).limits)[0]


def test_a_traced_cpu_run_reads_no_device_metric(tmp_path):
    cell = smoke_cell(CELL)
    r = run(cell, tmp_path, trace=True)["result"]
    assert {m["name"] for m in cell.per_layer} >= {"hbm_roofline.decode", "tick_ms.decode"}
    sources = {m["name"]: m["source"] for m in cell.per_layer}
    assert "tick_ms.decode" in r["metrics"]
    assert all(sources[name] != "device_trace" for name in r["metrics"])


def test_the_cell_is_one_stage_of_the_published_model():
    cell = load_cell(CELL)
    cfg = cell.config
    assert cfg["model"] == "granite" and cfg["reduced"] == ["num_hidden_layers"]
    assert cfg["num_hidden_layers"] == cfg["port"]["n_layers"] == 10
    run_types = cfg["layer_types"][: cfg["num_hidden_layers"]]
    assert [k["mixer"] for k in cfg["port"]["pattern"]] == [
        "attn" if t == "attention" else "mamba" for t in run_types]
    assert cell.traffic["slots"] == cell.traffic["clients"] == 128
    assert cell.traffic["max_len"] >= cell.traffic["prompt"]["max"] + cell.traffic["output"]["max"]


def test_counts_by_hand_at_the_published_widths():
    sz = full_sizes()
    mamba, attn = sz["layers"][0], sz["layers"][5]
    assert [la["attn_heads"] for la in sz["layers"]] == [0] * 5 + [32] + [0] * 4
    router_experts_shared = 4096 * 72 + 10 * 3 * 4096 * 768 + 3 * 4096 * 1536
    projections = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096
    state = 128 * 128 * 64
    assert mamba["macs"] == projections + 2 * state + router_experts_shared == 217_874_432
    assert attn["macs"] == 4096 * 6144 + 4096 * 4096 + router_experts_shared
    assert (mamba["fused"], attn["fused"]) == ([], [(4096, 6144), (4096, 4096)])
    vectors = 4 * (8192 + 2 * 128) + (8192 + 2 * 128) + 3 * 128 + 8192
    norms = 2 * 4096 * 4
    assert mamba["step_bytes"] == 2 * projections + 4 * vectors + 2 * router_experts_shared + norms
    words = 128 * 6144 * 4 + 6144 * 4 + 128 * 4096 * 4 + 4096 * 4
    assert attn["step_bytes"] == words + 2 * router_experts_shared + norms
    assert mamba["lane_bytes"] == 2 * (4 * state + 2 * 3 * (8192 + 256)) == 8_489_984
    assert attn["lane_bytes"] == 0
    assert sz["head_bytes"] == 100352 * 4096 * 2
    # one token at the first position: the layers, the one attention layer over itself, the head
    want = 2 * (9 * mamba["macs"] + attn["macs"] + 2 * 32 * 128 + 4096 * 100352)
    assert counts.decode_flops(sz, 1) == want


def test_hbm_roofline_reads_the_byte_floor_over_the_steps_device_time():
    read = metric_reader("hbm_roofline.decode")
    sz = full_sizes()
    within = {"bench.decode_step": {"gemm": [0.03, 50], "copy": [0.01, 10]}}
    trace = DeviceTrace(1.0, 1.0, {}, [], [], within)
    ctx = Context(sz, {}, trace, (4, 512), {})
    nbytes = 4 * (4_118_514_176 + 822_083_584) + 512 * 76_409_856
    assert sum(la["step_bytes"] for la in sz["layers"]) == 4_118_514_176
    assert sum(la["lane_bytes"] for la in sz["layers"]) == 76_409_856
    assert read(ctx) == pytest.approx(100 * nbytes / counts.PEAK_HBM_BYTES / 0.04)


@pytest.mark.parametrize("case", ["no_trace", "no_steps", "decoder_sizes"])
def test_hbm_roofline_reads_nothing_without_its_inputs(case):
    read = metric_reader("hbm_roofline.decode")
    sz = full_sizes()
    trace = DeviceTrace(1.0, 1.0, {}, [], [], {"bench.decode_step": {"gemm": [0.03, 50]}})
    if case == "no_trace":
        trace = None
    elif case == "no_steps":
        trace = DeviceTrace(1.0, 1.0, {"gemm": [0.03, 50]}, [], [], {})
    elif case == "decoder_sizes":
        sz = decoder.with_layers({"d_model": 64, "n_heads": 4, "n_kv_heads": 2, "hd": 16,
                                  "d_ff": 32, "vocab_size": 100, "n_layers": 1,
                                  "moe_experts": 0, "moe_top_k": 0})
    assert read(Context(sz, {}, trace, (4, 512), {})) is None


def test_the_control_store_saturates_and_the_stated_one_keeps_its_bits():
    """fp8 e4m3fn has no infinity: the hybrid reference's control stores
    a value past 448 as +-448 (some PyTorch versions cast it to NaN,
    which the recurrence would carry to every later position), and its
    bf16 store is the decoder's, bit for bit."""
    from bench.reference.decoder import Precision
    from bench.reference.hybrid import SaturatingPrecision

    t = torch.tensor([1e4, -1e4, 500.0, 448.0, 3.0, 0.0])
    low = SaturatingPrecision(torch.float8_e4m3fn)
    assert low.rnd(t).tolist() == [448.0, -448.0, 448.0, 448.0, 3.0, 0.0]
    assert low.rnd_expert(t).tolist() == low.rnd(t).tolist()
    assert torch.isnan(low.rnd(torch.tensor([float("nan")]))).all()
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 1e4
    x = torch.cat([x, torch.tensor([3e38, -3e38, float("inf")])])
    for store in (torch.bfloat16, torch.float32):
        assert torch.equal(SaturatingPrecision(store).rnd(x), Precision(store).rnd(x))


def test_the_control_stays_finite_where_its_stores_overflow():
    """Mamba's readout scaled far past fp8's range: the control's logits
    stay finite, so what it misses is the precision's doing."""
    from repro_torch.configs import get_smoke_config
    from bench.weights import make_weights

    cell = load_cell(CELL)
    sz = granite.sizes(get_smoke_config("granite-4.0-h-small"))
    w = make_weights(granite.layout(sz, cell.config["weights"]), 1, "cpu")
    w["layers.0.x_proj"].mul_(1e4)
    ref = granite.Reference(w, sz, torch.float8_e4m3fn)
    ids = torch.randint(0, sz["vocab_size"], (24,), generator=torch.Generator().manual_seed(1))
    assert type(ref.prec).__name__ == "SaturatingPrecision"
    assert torch.isfinite(ref.logits(ids, None, [(0, 24)], torch.arange(24))).all()

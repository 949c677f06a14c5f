"""The harness reaches every model-specific piece through the model
module that a configuration names, and the decoder's readings are the
ones it gave before they moved behind that module: the weights' bits,
the counts and the check's numbers, pinned from the earlier harness at
the smoke sizes (the counts at the full sizes too)."""

import hashlib
import shutil
import time
from pathlib import Path

import pytest
import torch

from bench import counts, drivers, harness, spec
from bench.spec import port_config
from bench.tests.test_bench_cells import CELLS, SEED, smoke_cell
from bench.weights import make_weights

CLOSED64, CAPTION = CELLS
PINNED = {
    CLOSED64: {
        "weights_sha256": "cee713e0296c0ea9536cccf6f836cc57d81fbf6d3f34d0ceed5fc83507c0b13a",
        "smoke": {"decode_flops": [124416.0, 156672.0, 419328.0],
                  "prefill_flops": [6930432.0, 55492608.0], "fused_window": (6, 146688.0)},
        "full": {"decode_flops": [1690337280.0, 1692401664.0, 1709211648.0],
                 "prefill_flops": [29834084352.0, 145533960192.0],
                 "fused_window": (6, 34370304.0)},
        "numbers": {"tokens": 31, "missed_share": float.fromhex("0x1.0842108421084p-4"),
                    "failed": 0},
        "served": {"attempted": 22, "tokens": 126},
    },
    CAPTION: {
        "weights_sha256": "019fd9273cbe3d2fd1706b81d242a5d30464d6f922170ceeba0e76595fb60955",
        "smoke": {"decode_flops": [122304.0, 150528.0, 380352.0],
                  "prefill_flops": [6924288.0, 52856832.0], "fused_window": (30, 443904.0)},
        "full": {"decode_flops": [987504896.0, 992923904.0, 1037050112.0],
                 "prefill_flops": [46252478720.0, 233698545920.0],
                 "fused_window": (360, 293594112.0)},
        "numbers": {"sublayer_err": float.fromhex("0x1.0736540000000p-4"), "head_gap": 0.0,
                    "tokens": 10, "replay_mismatch": 0, "failed": 0},
        "served": {"attempted": 57, "tokens": 285},
    },
}


class StepClock:
    """A clock that moves ``step`` seconds at each reading, so a window
    holds the same work however fast the host runs."""

    def __init__(self, step: float = 0.01):
        self.t, self.step = 1000.0, step

    def perf_counter(self) -> float:
        self.t += self.step
        return self.t


def stepped_run(cell, tmp_path: Path, monkeypatch) -> dict:
    """A smoke run of ``cell`` whose drivers read the step clock, on one
    thread (its numbers do not depend on the thread count) so that it
    slows no test beside it that runs on the host's clock."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with monkeypatch.context() as m:
            m.setattr(drivers, "time", StepClock())
            return harness.run_cell(cell, SEED, 1.5, False, device="cpu",
                                    t_start=time.perf_counter(), smoke=True, out_dir=tmp_path)
    finally:
        torch.set_num_threads(threads)


def served(out: dict) -> dict:
    return {"attempted": out["result"]["attempted"], "tokens": out["meta"]["tokens"]}


def sizes_of(cell, smoke: bool) -> dict:
    return cell.model.sizes(port_config(cell.config, smoke=smoke))


@pytest.mark.parametrize("name", CELLS)
def test_the_weights_are_the_same_bits(name):
    cell = smoke_cell(name)
    sz = sizes_of(cell, smoke=True)
    weights = make_weights(cell.model.layout(sz, cell.config["weights"]), SEED, "cpu")
    digest = hashlib.sha256()
    for t in weights.values():
        digest.update(t.contiguous().numpy().tobytes())
    assert digest.hexdigest() == PINNED[name]["weights_sha256"]


@pytest.mark.parametrize("size", ("smoke", "full"))
@pytest.mark.parametrize("name", CELLS)
def test_the_counts_are_the_same_numbers(name, size):
    sz = sizes_of(smoke_cell(name), smoke=size == "smoke")
    assert [counts.decode_flops(sz, c) for c in (1, 64, 577)] == PINNED[name][size]["decode_flops"]
    assert [counts.prefill_flops(sz, r) for r in (64, 320)] == PINNED[name][size]["prefill_flops"]
    assert counts.fused_window(sz, 3, 96) == PINNED[name][size]["fused_window"]


@pytest.mark.parametrize("name", CELLS)
def test_the_check_reads_the_same_numbers(name, tmp_path, monkeypatch):
    out = stepped_run(smoke_cell(name), tmp_path, monkeypatch)
    assert out["result"]["correct"], out["result"]["check"]
    assert out["numbers"] == PINNED[name]["numbers"]
    assert served(out) == PINNED[name]["served"]


def test_a_renamed_model_module_runs_the_cell_alike(tmp_path, monkeypatch):
    """Nothing of the harness names the decoder: a copy of its module under
    another name, named by the configuration, gives the decoder's run
    (pinned above, and held to the decoder's own run there)."""
    models = tmp_path / "models"
    models.mkdir()
    shutil.copy(spec.MODELS_DIR / "decoder.py", models / "renamed_copy.py")
    cell = smoke_cell(CLOSED64)
    cell.config = {**cell.config, "model": "renamed_copy"}
    cell.model = spec.model_module(cell.config, models)
    assert Path(cell.model.__file__).parent == models
    out = stepped_run(cell, tmp_path, monkeypatch)
    assert out["result"]["correct"], out["result"]["check"]
    assert out["numbers"] == PINNED[CLOSED64]["numbers"]
    assert served(out) == PINNED[CLOSED64]["served"]


@pytest.mark.parametrize("model", (None, "no_such_model"))
def test_a_missing_model_names_the_configuration(model, tmp_path):
    config = {"name": "some-config"} | ({} if model is None else {"model": model})
    with pytest.raises((KeyError, FileNotFoundError), match="some-config"):
        spec.model_module(config, tmp_path)

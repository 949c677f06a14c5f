"""BENCHMARK.json keeps to the contract's form, and every name in it
finds its files: configuration, model module, traffic, limits and metric
readers."""

import inspect
import json
import re
from pathlib import Path

import pytest

from bench.spec import BENCH_DIR, ROOT, load_cell, model_module

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_one_line_texts():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= METRIC_KEYS
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_unique_names_and_used_configs():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_setup():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_and_metrics(w):
    cell = load_cell(w["name"])
    assert w["chips"] == 1
    assert cell.limits["numbers"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert m["name"] == "setup_s" or (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_per_layer_metrics_move_a_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", [w["name"] for w in BENCH["workloads"]]))


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files_state_the_cut(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert c["file"].startswith("bench/")
    assert cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    changed = [k for k, v in cfg["run"].items() if cfg["published"].get(k) != v]
    assert changed == c["reduced"]
    for key in ("assumed", "departures", "deployment", "precision", "port"):
        assert cfg[key]


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_names_a_model_module(c):
    """Its four parts, and a plain reference under ``bench/reference/``."""
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert NAME.match(cfg["model"])
    assert (BENCH_DIR / "models" / f"{cfg['model']}.py").is_file()
    model = model_module(cfg)
    assert all(callable(getattr(model, part)) for part in ("sizes", "layout", "build"))
    assert Path(inspect.getfile(model.Reference)).parent == BENCH_DIR / "reference"

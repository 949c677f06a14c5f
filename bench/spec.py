"""What one run measures, found by name: the cell in ``BENCHMARK.json``,
its configuration file (``bench/configs/<config>.json``), its traffic mix
(``bench/traffic/<traffic>.json``), the limits of its correctness
numbers (``bench/limits/<cell>.json``) and its per-layer metric readers
(``bench/metrics/<metric>.py``). Nothing here names a cell: a new cell
is new data files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict        # the configuration file
    traffic: dict       # the traffic mix's parameters
    limits: dict        # {"numbers": {name: {"limit": x, ...}}}
    end_to_end: list[dict]
    per_layer: list[dict]
    chips: int


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, benchmark: Path | None = None) -> Cell:
    bench = load_json(benchmark or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {', '.join(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")

    def mine(metric: dict) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in e2e_names]
    return Cell(name=name, config=config, traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, chips=int(w["chips"]))


def port_config(config: dict, smoke: bool = False):
    """The system's ``ModelConfig`` as the configuration file states it
    (its ``smoke`` sizes for the CPU tests)."""
    from repro_torch.models.config import LayerKind, ModelConfig

    kw = dict(config["port"])
    if smoke:
        kw.update(config["smoke"])
    kw["pattern"] = tuple(LayerKind(**k) for k in kw["pattern"])
    return ModelConfig(**kw)


def sizes(cfg) -> dict:
    """The plain numbers the weights, the reference and the counters
    read, from the system's configuration object."""
    return {
        "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "hd": cfg.hd, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "padded_vocab": cfg.padded_vocab, "n_layers": cfg.n_layers,
        "moe_experts": cfg.moe_experts, "moe_top_k": cfg.moe_top_k,
        "moe_capacity_factor": cfg.moe_capacity_factor, "qkv_bias": cfg.qkv_bias,
        "tie_embeddings": cfg.tie_embeddings, "rope_theta": cfg.rope_theta,
        "norm_eps": cfg.norm_eps, "frontend_len": cfg.frontend_len,
    }


def metric_reader(name: str):
    """``bench/metrics/<name>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

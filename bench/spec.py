"""What one run measures, found by name: the cell in ``BENCHMARK.json``,
its configuration file (``bench/configs/<config>.json``), the model
module that file names (``bench/models/<model>.py``), its traffic mix
(``bench/traffic/<traffic>.json``), the limits of its correctness
numbers (``bench/limits/<cell>.json``) and its per-layer metric readers
(``bench/metrics/<metric>.py``). Nothing here names a cell or an
architecture: a new cell is new data files and entries, and a new
architecture is a new model module and its plain reference.

A model module gives:

* ``sizes(cfg) -> dict``: the plain numbers the weights, the reference
  and the counts read, from the system's configuration object. Its
  ``layers`` hold one entry per layer: ``macs`` (one token's
  multiply-adds, attention scores left out), ``attn_heads`` and
  ``attn_hd`` (the query heads and head width that attend over the
  causal context, 0 where the layer does not attend) and ``fused`` (the
  ``(m, n)`` of each fused BitLinear launch it makes).
* ``layout(sz, wcfg)``: ``(name, shape, kind, std)`` of every weight, in
  draw order (``bench/weights.py``).
* ``build(weights, sz)``: the system's model holding those weights,
  built with the system's own constructors.
* ``Reference``: the plain reference the check runs, from
  ``bench/reference/<file>.py``, which imports nothing of the system:
  ``Reference(weights, sz, store, expert_store)``, its ``logits`` and,
  for a check that follows the system layer by layer, ``embed``,
  ``attention_sublayer``, ``ffn_sublayer`` and ``head``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MODELS_DIR = BENCH_DIR / "models"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict        # the configuration file
    model: ModuleType   # the model module it names
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
    return Cell(name=name, config=config, model=model_module(config), traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer, chips=int(w["chips"]))


def port_config(config: dict, smoke: bool = False):
    """The system's ``ModelConfig`` as the configuration file states it
    (its ``smoke`` sizes for the CPU tests)."""
    from repro_torch.models.config import LayerKind, ModelConfig

    kw = dict(config["port"])
    if smoke:
        kw.update(config["smoke"])
    kw["pattern"] = tuple(LayerKind(**k) for k in kw["pattern"])
    return ModelConfig(**kw)


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_module(config: dict, models_dir: Path = MODELS_DIR) -> ModuleType:
    """``<models_dir>/<model>.py`` for the configuration's ``model``."""
    if "model" not in config:
        raise KeyError(f"configuration {config.get('name')!r} names no model module")
    path = models_dir / f"{config['model']}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"configuration {config.get('name')!r} names model {config['model']!r}, "
            f"but {path} does not exist")
    return _load(path, f"bench_model_{config['model']}")


def metric_reader(name: str):
    """``bench/metrics/<name>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    return _load(path, f"bench_metric_{name.replace('.', '_')}").read

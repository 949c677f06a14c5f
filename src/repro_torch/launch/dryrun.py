"""Multi-pod dry-run (counterpart of ``repro/launch/dryrun.py``).

For every (architecture x input shape) cell on the production meshes
((16, 16) and (2, 16, 16): 256 and 512 ranks) it builds the cell
(``launch/steps.py``), applies the skip rules, checks that every spec
divides its leaf (``validate_specs``), and traces one rank of the cell's
step on a fake world of the mesh's ranks (``steps.trace_cell``: DTensors
of ``meta`` shards, nothing allocated), the counterpart of the
reference's lower + compile. ``launch/hlo_analysis.py`` turns the trace
into the reference's record: per-device FLOPs, HBM bytes (fusion-aware
and raw), collectives per kind, memory (arguments, outputs, temporaries,
peak) and the three-term roofline on H100 constants, plus
``useful_flop_ratio`` (analytic model FLOPs over traced FLOPs). The
record also keeps ``spec_bytes_per_device`` -- the bytes each rank holds
of the step's arguments and outputs under the specs -- and ``trace_s``
where the reference has ``lower_s`` / ``compile_s``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells, both meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod      # (2,16,16) mesh only

The fake world's mesh is a CUDA one on any host, a CPU-only torch
included (``steps.fake_world``): its shards are ``meta``, so nothing
runs on a device, and DTensor plans the collectives as it would over
NCCL. The record does not depend on the host.

Each cell's record is cached as JSON under ``--out``; reruns skip
completed cells (delete the file to force).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any

from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import token_count
from repro_torch.distributed.partitioner import shard_factor, validate_specs
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch import hlo_analysis
from repro_torch.launch.steps import build_cell, trace_cell
from repro_torch.models.config import SHAPES, shape_applicable


def model_flops(cfg, shape) -> float:
    """6 N_active D analytic FLOPs for the cell (serve: 2 N D)."""
    factor = 6 if shape.kind == "train" else 2
    return factor * cfg.active_param_count() * token_count(shape)


def spec_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one rank holds of ``tree``'s leaves under ``specs`` (each
    leaf's bytes over its shard factor)."""
    total = 0
    for path, leaf in tree_lib.leaves_with_paths(tree):
        n = leaf.numel() * leaf.element_size()
        total += n // shard_factor(tree_lib.get(specs, path), mesh)
    return total


def cell_specs(arch: str, shape_name: str, *, multi_pod: bool, quant: str = "none") -> dict:
    """One cell's spec-level record: the skip rules, spec violations,
    ``spec_bytes_per_device``, analytic model FLOPs (no trace)."""
    cfg = get_config(arch, quant=quant)
    shape = SHAPES[shape_name]
    runs, why = shape_applicable(cfg, shape)
    if not runs:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    mesh = production_mesh_shape(multi_pod=multi_pod)
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh)
    t1 = time.perf_counter()
    trees = [*zip(cell["args"], cell["in_specs"]), *zip(cell["out"], cell["out_specs"])]
    violations = [v for tree, specs in trees for v in validate_specs(tree, specs, mesh)]
    kinds = {"train": ("params", "opt_state", "batch", "step"),
             "prefill": ("params", "batch"),
             "decode": ("params", "token", "pos", "caches")}[shape.kind]
    per = {name: spec_bytes(t, s, mesh)
           for name, t, s in zip(kinds, cell["args"], cell["in_specs"])}
    if shape.kind == "prefill":  # the caches it returns
        per["caches"] = spec_bytes(cell["out"][1], cell["out_specs"][1], mesh)
    mf = model_flops(cfg, shape)
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod, "n_chips": mesh.size,
        "status": "ok" if not violations else "invalid", "quant": quant,
        "violations": violations, "fsdp": bool(cell["hint_kw"]),
        "spec_bytes_per_device": {**per, "total": sum(per.values())},
        "model_flops": mf, "model_flops_per_device": mf / mesh.size,
        "tokens": token_count(shape), "build_s": round(t1 - t0, 3),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, quant: str = "none") -> dict:
    """One cell's record: :func:`cell_specs` and the traced step's
    analysis (``analyze_trace``'s keys, ``useful_flop_ratio``,
    ``trace_s``)."""
    rec = cell_specs(arch, shape_name, multi_pod=multi_pod, quant=quant)
    if rec["status"] == "skipped":
        return rec
    mesh = production_mesh_shape(multi_pod=multi_pod)
    t0 = time.perf_counter()
    trace = trace_cell(get_config(arch, quant=quant), SHAPES[shape_name], mesh)
    rec.update(hlo_analysis.analyze_trace(trace, mesh.size),
               trace_s=round(time.perf_counter() - t0, 2))
    rec["useful_flop_ratio"] = rec["model_flops"] / rec["flops"] if rec["flops"] else None
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", choices=ARCH_IDS, default=None)
    ap.add_argument("--shape", action="append", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true", help="only the (2,16,16) mesh")
    ap.add_argument("--single-pod", action="store_true", help="only the (16,16) mesh")
    ap.add_argument("--quant", default="none", choices=["none", "bnn"])
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    archs = args.arch or list(ARCH_IDS)
    shapes = args.shape or list(SHAPES)
    if args.multi_pod and not args.single_pod:
        pods = [True]
    elif args.single_pod and not args.multi_pod:
        pods = [False]
    else:
        pods = [False, True]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in pods:
                tag = f"{arch}__{shape_name}__{'mp' if mp else 'sp'}"
                if args.quant != "none":
                    tag += f"__{args.quant}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] {tag}: cached")
                    continue
                try:
                    rec = run_cell(arch, shape_name, multi_pod=mp, quant=args.quant)
                except Exception as e:  # a failure here is a bug in the sharding rules
                    rec = {"arch": arch, "shape": shape_name, "multi_pod": mp,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                if rec["status"] in ("error", "invalid"):
                    failures += 1
                    print(f"[dryrun] {tag}: FAILED {rec.get('error') or rec['violations'][:3]}",
                          flush=True)
                elif rec["status"] == "skipped":
                    print(f"[dryrun] {tag}: skipped ({rec['reason']})", flush=True)
                else:
                    r = rec["roofline"]
                    mem = rec["memory"]["peak_per_device_bytes"] / 2**30
                    print(f"[dryrun] {tag}: ok  flops={rec['flops']:.3e} mem/dev={mem:.2f}GiB "
                          f"coll={rec['collectives']['operand_bytes']:.3e}B "
                          f"dominant={r['dominant']} (c={r['compute_s']:.2e}s "
                          f"m={r['memory_s']:.2e}s x={r['collective_s']:.2e}s) "
                          f"trace={rec['trace_s']}s", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if failures and args.fail_fast:
                    return 1
    print(f"[dryrun] done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

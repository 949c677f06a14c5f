"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each compared number beside its
limit); the run's meta record is the line before it and
``bench_out/<cell>/<seed>_<trace>/meta.json``. The numbers compared are
also the last lines of standard error. With no CUDA device, fewer
devices than the cell asks for, or JAX loaded, it exits non-zero and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Before CUDA starts: deterministic cuBLAS (the system's trainer
    asks for it), every build cache inside the checkout at a fixed
    path, and no library loading JAX behind the system's back."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    # one host thread: the loop is host-paced, and idle pool threads
    # spinning beside it make its runs spread
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    torch.set_num_threads(1)
    from bench import harness
    from bench.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and never the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                           t_start=T_START)
    bad = sorted(set(out["forbidden"]) | set(harness.forbidden_modules()))
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps({"meta": out["meta"]}, default=str))
    for name, v in out["result"]["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

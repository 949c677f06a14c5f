"""The two readings every limit of ``correct`` is set from, on the card
at a cell's own size: the system's numbers over many seeds (sound runs)
and the control's on the same served samples (the reference at the
precision below the configuration's, in the system's place).

    python3 bench/readings.py --workload <name> --seeds 1,2,3 --seconds 12

One process: each seed makes its own weights, set-up and window (the
cell's own load, long enough to finish its longest requests), then both
readings. One JSON line per seed; never run by a benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from run import _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench import harness
    from bench.spec import load_cell

    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False, device="cuda", t_start=t0,
                               control=True)
        r = out["result"]
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": r["correct"],
                          "metrics": r["metrics"], "sound": out["numbers"],
                          "control": out["control"], "peak": r["device"]["memory_peak_bytes"]}),
              flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

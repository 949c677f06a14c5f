"""How a benchmark cell's decode steps ran: the cell's untraced run with
the port's telemetry on, then ``model_decode_graph_total`` by outcome
(eager by its reason) and ``model_weight_cast_total`` by site and
outcome (``resident`` or ``cast``) beside the result line.

    python3 tools/decode_graph_probe.py --workload internvl2.caption-batch32 \\
        --seeds 1,2 --seconds 51

One process, one JSON line per seed. The counter covers the set-up's
warm-up, the window and the check's replay of a wave (whose recording
hook runs every step eagerly, ``patched``); ``window_steps`` counts the
window's decode steps from its waves (a lockstep cell), or every tick
of the run (the serving cell). Telemetry fences each serving tick, so the serving
cell's ``decode_tok_s`` here is not the benchmark's. Never run by a
benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "bench"))
from run import _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    _environment()
    import torch

    torch.set_num_threads(1)
    from bench import harness
    from bench.spec import load_cell
    from repro_torch import obs
    from repro_torch.compiler import decode_graph
    from repro_torch.models.layers import CAST_COUNTER

    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with obs.session() as tel:
            out = harness.run_cell(cell, seed, args.seconds, False, device="cuda", t_start=t0)
        series = {}
        for key, child in tel.metrics.counter(decode_graph.COUNTER)._series.items():
            labels = dict(key)
            series[labels.get("reason", labels["outcome"])] = int(child.value)
        casts = {f'{dict(key)["site"]}/{dict(key)["outcome"]}': int(child.value)
                 for key, child in tel.metrics.counter(CAST_COUNTER)._series.items()}
        meta = out["meta"]
        if cell.traffic["loop"] == "waves":  # each wave: a prefill's token, then steps
            steps = meta["tokens"] // cell.traffic["batch"] - meta["prefill_s_n"]
        else:  # every tick, the warm-up's too
            steps = tel.metrics.counter("repro_decode_ticks_total").value
        r = out["result"]
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": r["correct"],
                          "decode_tok_s": r["metrics"]["decode_tok_s"]["value"],
                          "setup_s": r["metrics"]["setup_s"]["value"],
                          "check": {k: v["value"] for k, v in r["check"].items()},
                          "decode_graph_total": series, "weight_cast_total": casts,
                          "window_steps": int(steps),
                          "peak_bytes": r["device"]["memory_peak_bytes"]}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

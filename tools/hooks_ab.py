#!/usr/bin/env python3
"""Serving and training wall times of source trees, compared in one call.

For each tree given (a checkout's root: this one, or an older commit
unpacked with ``git archive``), in the order given, a process of its own
imports that tree's ``repro_torch`` and times on the card, at
tinyllama-1.1b's full width and depth with seeded random weights:

* serving: the packed lockstep batch of ``chip_smoke.py``'s serve phase
  (8 prompts of 128 tokens, 32 generated, plain-ops attention), built
  and compiled by ``launch.serve.run``, then ``launch.serve.lockstep``
  ``--repeats`` times on that compiled model: prefill ms and decode
  tok/s of each;
* training: ``train.loop.make_train_step`` (8 x 128 tokens, remat, fp32
  parameters, AdamW), one warm-up step and ``--steps`` timed ones.

Each process prints one JSON line; the last line gathers them, with the
card's name and power limit. Alternate the trees (A B B A) to see the
drift within the call beside the difference.

    python3 tools/hooks_ab.py build/ab/parent . . build/ab/parent
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ARCH = "tinyllama-1.1b"
BATCH, PROMPT, GEN, SEED = 8, 128, 32, 0


def one(tree: Path, repeats: int, steps: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.device import synchronize
    from repro_torch.launch import serve
    from repro_torch.launch.steps import default_opt_cfg
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import TrainLoopConfig, make_train_step

    assert Path(serve.__file__).resolve().is_relative_to(tree.resolve()), serve.__file__
    cfg = get_config(ARCH)
    res = {"tree": str(tree)}
    first = serve.run(["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                       "--gen", str(GEN), "--seed", str(SEED), "--device", "cuda",
                       "--engine", "packed"])
    compiled, tokens = first["compiled"], serve.prompts(cfg, BATCH, PROMPT, SEED)
    runs = [serve.lockstep(compiled, tokens, GEN) for _ in range(repeats)]
    if any((r["generated"] != first["generated"]).any() for r in runs):
        raise AssertionError("a repeated lockstep run generated other tokens")
    res["prefill_ms"] = [r["prefill_s"] * 1e3 for r in runs]
    res["decode_tok_s"] = [r["decode_tok_s"] for r in runs]
    del first, compiled, runs
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    opt_cfg = default_opt_cfg(cfg)
    step_fn = make_train_step(cfg, opt_cfg, TrainLoopConfig(total_steps=10_000, warmup_steps=100))
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                           device=dev).requires_grad_(True)
    opt_state = adamw_init(lm.param_tree(model), opt_cfg)
    batch = lm_batch(cfg, BATCH, PROMPT, seed=SEED, step=0, device=dev)
    step_fn(model, opt_state, batch, 0)
    times = []
    for i in range(steps):
        synchronize(dev)
        t0 = time.perf_counter()
        step_fn(model, opt_state, batch, 1 + i)
        synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    res["train_step_ms"] = times
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--one", action="store_true", help="time the one tree given, here")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.trees[0], args.repeats, args.steps)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = []
    for tree in args.trees:
        p = subprocess.run([sys.executable, __file__, "--one", str(tree), "--repeats",
                            str(args.repeats), "--steps", str(args.steps)],
                           capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stderr[-3000:], file=sys.stderr)
            return p.returncode
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        print(f"{tree}: prefill {statistics.median(rec['prefill_ms']):.2f} ms, decode "
              f"{statistics.median(rec['decode_tok_s']):.1f} tok/s, train step "
              f"{statistics.median(rec['train_step_ms']):.1f} ms (medians)", flush=True)
        out.append(rec)
    print(card.strip())
    print(json.dumps({"card": card.strip(), "runs": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

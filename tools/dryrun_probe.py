#!/usr/bin/env python3
"""Two probes of the dry-run's step analysis.

Memory (default): where the analysis's memory model departs from the
CUDA allocator -- one tinyllama-1.1b training step (8 x 128 tokens, fp32
parameters, remat) on the card under ``launch.hlo_analysis.StepAnalysis``
counting the real CUDA tensors, with ``torch.cuda.memory_allocated()``
read after every op. Prints the ops where the two drift apart by more
than ``--step`` MiB, the largest gap, and the two peaks.

``--checks``: what the analysis's hooks cost a serving tick when no
analysis runs -- the calls per tinyllama-1.1b decode tick (8 slots, a
128-token cache; ``meta`` tensors, so any host) of the functions that
hold a module-level ``None`` check (``kernels/rows.py``'s) or a
plain-tensor type check (``layers.hinted`` and its kin), and each
check's time by ``timeit`` on this host.

    python3 tools/dryrun_probe.py [--smoke] [--step 64]
    python3 tools/dryrun_probe.py --checks [--smoke]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--step", type=float, default=64.0)
    ap.add_argument("--checks", action="store_true")
    args = ap.parse_args(argv)
    if args.checks:
        return checks(args.smoke)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import lm_batch
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import TrainLoopConfig, make_train_step

    cfg = get_smoke_config("tinyllama-1.1b") if args.smoke else get_config("tinyllama-1.1b")
    dev = torch.device("cuda")
    opt_cfg = steps.default_opt_cfg(cfg)
    step_fn = make_train_step(cfg, opt_cfg, TrainLoopConfig(total_steps=10_000, warmup_steps=100))
    model = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev).requires_grad_(True)
    opt_state = adamw_init(lm.param_tree(model), opt_cfg)
    batch = lm_batch(cfg, 8, 128, seed=0, step=0, device=dev)
    step_fn(model, opt_state, batch, 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mib = 2**20

    class Probe(H.StepAnalysis):
        gap = 0
        worst = (0, "")
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            self.n += 1
            self._prune()
            g = torch.cuda.memory_allocated() - self._live_bytes
            if abs(g - self.gap) > args_step:
                print(f"op {self.n} {func._schema.name}: allocator - tracked {g / mib:+.1f} MiB "
                      f"(was {self.gap / mib:+.1f}); live {self._live_bytes / mib:.1f} MiB",
                      flush=True)
                self.gap = g
            if abs(g) > abs(self.worst[0]):
                self.worst = (g, func._schema.name)
            return out

    args_step = args.step * mib
    an = Probe(device="cuda")
    an.add_arguments([p for p in model.parameters()]
                     + [t for t in __import__("repro_torch.tree", fromlist=["leaves"]).leaves(
                         (opt_state, batch))])
    with H.analysing(an):
        step_fn(model, opt_state, batch, 1)
    torch.cuda.synchronize()
    tr = an.finish()
    print(f"tracked peak {tr.peak_bytes / 2**30:.3f} GiB, arguments "
          f"{tr.argument_bytes / 2**30:.3f}; allocator peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; largest gap "
          f"{an.worst[0] / mib:+.1f} MiB at {an.worst[1]}; {an.n} ops", flush=True)
    return 0


# the functions whose every call pays one module-level None check
# (rows.ACTIVE) or one plain-tensor type check, by code name
NONE_CHECKS = ("blocks", "_row_reduce", "checkpoint_kw")
TYPE_CHECKS = ("hinted", "gathered", "split_heads", "merge_heads", "embed_rows",
               "_expand_heads", "mamba_block")


def checks(smoke: bool) -> int:
    import timeit

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import rows
    from repro_torch.models import lm

    cfg = get_smoke_config("tinyllama-1.1b") if smoke else get_config("tinyllama-1.1b")
    b, t = 8, 128
    model = lm.init_params(torch.Generator(), cfg, device="meta")
    caches = lm.init_cache(cfg, b, t, device="meta")
    token = torch.empty((b,), dtype=torch.int64, device="meta")
    pos = torch.empty((b,), dtype=torch.int64, device="meta")
    counts = dict.fromkeys(NONE_CHECKS + TYPE_CHECKS, 0)

    def prof(frame, event, arg):
        if event == "call" and frame.f_code.co_name in counts:
            counts[frame.f_code.co_name] += 1

    with torch.no_grad():
        sys.setprofile(prof)
        try:
            lm.decode_step(model, token, pos, caches, cfg)
        finally:
            sys.setprofile(None)
    x = torch.empty(4)
    n_none = sum(counts[k] for k in NONE_CHECKS)
    n_type = sum(counts[k] for k in TYPE_CHECKS)
    t_none = min(timeit.repeat(lambda: rows.ACTIVE is not None, number=100_000, repeat=5)) / 1e5
    t_type = min(timeit.repeat(lambda: type(x) in rows.PLAIN, number=100_000, repeat=5)) / 1e5
    print(f"{cfg.name} decode tick, {b} slots: {counts}")
    print(f"None checks {n_none} x {t_none * 1e9:.1f} ns, type checks {n_type} x "
          f"{t_type * 1e9:.1f} ns (each with its lambda call): "
          f"{(n_none * t_none + n_type * t_type) * 1e6:.2f} us per tick", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Training probes for chip_smoke's train breadth phase, on one CUDA card
(run from the repository root):

    python3 tools/train_probe.py [--sections lr,ssd,profile]

- ``lr``: each family of ``chip_smoke.TRAIN_BREADTH`` at its depth,
  trained 4 steps (8 x 128 tokens, quant bnn, no warmup, no checkpoints)
  at peak lrs 1e-3, 3e-3 and 1e-2: the four losses, and the loss of a
  held-out batch (step 100) before and after.
- ``ssd``: mamba2-2.7b at 8 layers after one update at lr 1e-3, the
  largest masked-out exponent ``ci_q - ci_k`` (q < k) of each layer's
  intra-chunk decay in the SSD scan (fp32 ``exp`` overflows past ~88.7)
  and dt's largest value, whether any gradient is non-finite, and the
  SSD inputs of the layer with the largest exponent saved to
  ``chiprun_out/ssd_overflow_inputs.npz``, so that another program can
  run any SSD gradient on the same inputs.
- ``profile``: where a training step's time goes, for each family of
  ``chip_smoke.TRAIN_BREADTH`` and the train phase's tinyllama-1.1b at
  their depths: the forward (with the loss), the backward (with its
  remat recompute) and the optimizer (stacking the gradients, the
  global norm, the leaf-by-leaf update) timed apart by the host clock
  around synchronized sections, then one step under ``torch.profiler``:
  wall, device busy, device launches and the kernels with the most
  device time.

The card's name and power limit come first. Nothing here is a check:
``chip_smoke.py`` is.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
# deterministic cuBLAS, which train() requires, is set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.models import lm, ssm  # noqa: E402
from repro_torch.optim import OptConfig, adamw_begin, adamw_init  # noqa: E402
from repro_torch.train import TrainLoopConfig, train  # noqa: E402
from repro_torch.train.loop import family  # noqa: E402

BATCH, SEQ, STEPS = 8, 128, 4
LRS = (1e-3, 3e-3, 1e-2)


def _config(arch: str, layers: int | None):
    base = get_config(arch)
    return dataclasses.replace(base, quant="bnn", attn_impl="jnp", remat=True,
                               n_layers=layers or base.n_layers)


def lr_sweep() -> None:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import TRAIN_BREADTH

    for _, arch, layers, _, opt_kw in TRAIN_BREADTH:
        cfg = _config(arch, layers)
        fam = family(cfg)
        held = lm_batch(cfg, BATCH, SEQ, seed=0, step=100, device="cuda")
        with torch.no_grad():
            init = fam.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                   device="cuda")
            before = float(fam.loss_fn(init, held, cfg))
        del init
        for lr in LRS:
            t0 = time.perf_counter()
            loop = TrainLoopConfig(total_steps=STEPS, batch_size=BATCH, seq_len=SEQ, peak_lr=lr,
                                   warmup_steps=0, checkpoint_every=0)
            out = train(cfg, loop, OptConfig(**opt_kw), log=lambda line: None, device="cuda")
            with torch.no_grad():
                after = float(fam.loss_fn(out["params"], held, cfg))
            print(f"[lr] {arch} ({cfg.n_layers} layers) lr {lr:g}: losses "
                  f"{[round(v, 4) for v in out['losses']]}; held-out {before:.4f} -> "
                  f"{after:.4f} ({time.perf_counter() - t0:.1f} s)", flush=True)
            del out
            torch.cuda.empty_cache()


def ssd_overflow() -> None:
    cfg = dataclasses.replace(_config("mamba2-2.7b", 8), remat=False)  # one SSD call per layer
    loop = TrainLoopConfig(total_steps=1, batch_size=BATCH, seq_len=SEQ, peak_lr=1e-3,
                           warmup_steps=0, checkpoint_every=0)
    model = train(cfg, loop, log=lambda line: None, device="cuda")["params"]
    calls = []
    scan = ssm.ssd_chunked

    def recording(x, dt, a, b, c, chunk=ssm.SSD_CHUNK):
        with torch.no_grad():
            cum = torch.cumsum(dt.float() * a, dim=1)  # one chunk: S = 128 <= 256
            span = float((cum[:, 0] - cum[:, -1]).max())  # the largest ci_q - ci_k, q < k
        calls.append((span, [t.detach().float().cpu().numpy() for t in (x, dt, a, b, c)]))
        return scan(x, dt, a, b, c, chunk)

    ssm.ssd_chunked = recording
    try:
        loss = lm.loss_fn(model, lm_batch(cfg, BATCH, SEQ, seed=0, step=1, device="cuda"), cfg)
        loss.backward()
    finally:
        ssm.ssd_chunked = scan
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    bad = [n for n, g in grads.items() if not torch.isfinite(g).all()]
    print(f"[ssd] {cfg.name}, {cfg.n_layers} layers, after one update at lr 1e-3: loss "
          f"{loss.item():.4f}; largest masked exponent per layer "
          f"{[round(s, 1) for s, _ in calls]}; dt max per layer "
          f"{[round(float(c[1][1].max()), 3) for c in calls]}; non-finite gradients in "
          f"{len(bad)} of {len(grads)} parameters {bad[:6]}", flush=True)
    worst = int(np.argmax([s for s, _ in calls]))
    out = ROOT / "chiprun_out" / "ssd_overflow_inputs.npz"
    out.parent.mkdir(exist_ok=True)
    np.savez_compressed(out, **dict(zip(("x", "dt", "a", "b", "c"), calls[worst][1])),
                        layer=worst)
    print(f"[ssd] layer {worst}'s SSD inputs saved to {out.relative_to(ROOT)}", flush=True)


def _sync_ms(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile_steps() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    from chip_smoke import TRAIN_BREADTH

    torch.use_deterministic_algorithms(True)  # train()'s mode, and its kernels
    for _, arch, layers, lr, opt_kw in (*TRAIN_BREADTH, ("dense", "tinyllama-1.1b", None, 3e-4,
                                                           {})):
        cfg = _config(arch, layers)
        fam, opt_cfg = family(cfg), OptConfig(**opt_kw)
        model = fam.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                device="cuda").requires_grad_(True)
        state = adamw_init(fam.param_tree(model), opt_cfg)
        batch = lm_batch(cfg, BATCH, SEQ, seed=0, step=0, device="cuda")

        def forward():
            return fam.loss_fn(model, batch, cfg)

        def optimizer():
            fam.update_params_(model, adamw_begin(fam.take_grad_tree(model), state, lr, opt_cfg))

        def step():
            forward().backward()
            optimizer()

        step()  # warm-up
        loss, fwd_ms = _sync_ms(forward)
        _, bwd_ms = _sync_ms(loss.backward)
        _, opt_ms = _sync_ms(optimizer)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall_ms = _sync_ms(step)
        rows = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)), reverse=True)
        rows = [r for r in rows if r[0] > 0]
        busy = sum(r[0] for r in rows)
        print(f"[profile] {arch} ({cfg.n_layers} layers): forward {fwd_ms:.1f} ms, backward "
              f"with recompute {bwd_ms:.1f} ms, optimizer {opt_ms:.1f} ms; one step under the "
              f"profiler {wall_ms:.1f} ms wall, device busy {busy:.1f} ms "
              f"({100 * busy / wall_ms:.1f}%), {sum(r[1] for r in rows)} device launches",
              flush=True)
        for ms, count, name in rows[:6]:
            print(f"[profile]   {ms:.1f} ms in {count} launches: {name[:90]}", flush=True)
        del model, state, loss
        torch.cuda.empty_cache()


SECTIONS = {"lr": lr_sweep, "ssd": ssd_overflow, "profile": profile_steps}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default=",".join(SECTIONS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_probe.py needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for name in args.sections.split(","):
        SECTIONS[name]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

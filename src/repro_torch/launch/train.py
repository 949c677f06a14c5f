"""End-to-end training driver (counterpart of ``repro/launch/train.py``).

    # on the card (the default device), full width:
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --quant bnn --steps 12 --batch 8 --seq 128 --ckpt-every 4 --ckpt runs/tl

    # on the CPU, at smoke size:
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 8 --batch 2 --seq 16 --ckpt runs/smoke --device cpu

Every architecture trains (``--arch`` of any config: dense, MoE, Mamba,
hybrid, the VLM with its stub patch embeddings, the enc-dec stack with
its stub source frames). The path is data -> step -> checkpoint ->
resume: rerun with the same ``--ckpt`` and it resumes from the latest
checkpoint there. This launcher sets ``CUBLAS_WORKSPACE_CONFIG``
(deterministic cuBLAS, which the bitwise resume on the card needs)
before CUDA starts; the reference's TPU XLA flags have no counterpart.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--quant", default="none", choices=["none", "bnn"],
                    help="bnn = the paper's technique on all hidden projections")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join("runs", "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def run(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, train, print the summary line; returns the summary."""
    args = build_parser().parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.train import TrainLoopConfig, train

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.quant != "none":
        cfg = dataclasses.replace(cfg, quant=args.quant)
    loop = TrainLoopConfig(
        total_steps=args.steps,
        batch_size=args.batch,
        seq_len=args.seq,
        peak_lr=args.lr,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt,
        seed=args.seed,
    )
    out = train(cfg, loop, device=args.device)
    print(
        f"[train] arch={cfg.name} quant={cfg.quant} final_step={out['final_step']} "
        f"loss[first->last]={out['losses'][0]:.4f}->{out['losses'][-1]:.4f} "
        f"steps/s={out.get('steps_per_s', 0):.2f}"
    )
    return out


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

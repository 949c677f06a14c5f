"""Architecture configs (``--arch <id>``), own copies of ``repro/configs``.

Each module defines ``CONFIG`` (the published numbers) and
``smoke_config()`` (a reduced same-family variant for CPU tests). The
port serves every architecture of the reference's pool: dense, MoE,
Mamba-2, the hybrid Jamba stack, the encoder-decoder seamless-m4t
(``models/encdec.py``) and the vision-frontend internvl2
(``lm.prefill(extra_embeds=)``). It also serves one the JAX reference
lacks, the hybrid ``granite-4.0-h-small`` (Mamba-2 + NoPE attention, a
shared expert, Granite's multipliers), which the benchmark's plain
reference checks instead."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS: tuple[str, ...] = (
    "jamba-1.5-large-398b",
    "internvl2-1b",
    "grok-1-314b",
    "qwen3-moe-235b-a22b",
    "qwen1.5-0.5b",
    "tinyllama-1.1b",
    "qwen2-72b",
    "llama3.2-3b",
    "seamless-m4t-large-v2",
    "mamba2-2.7b",
    "granite-4.0-h-small",
)

SERVED: tuple[str, ...] = ARCH_IDS

# architectures the port cannot serve yet, each with the reason (none)
PENDING: dict[str, str] = {}


def _module(arch: str):
    if arch in PENDING:
        raise NotImplementedError(f"{arch}: {PENDING[arch]}")
    if arch not in SERVED:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}"
    )


def get_config(arch: str, *, quant: str = "none") -> ModelConfig:
    cfg = _module(arch).CONFIG
    if quant != cfg.quant:
        cfg = dataclasses.replace(cfg, quant=quant)
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()

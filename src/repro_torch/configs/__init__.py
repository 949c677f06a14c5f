"""Architecture configs (``--arch <id>``), own copies of ``repro/configs``.

Each module defines ``CONFIG`` (the published numbers) and
``smoke_config()`` (a reduced same-family variant for CPU tests). This
slice serves the attention-only dense architectures; the other ids of
the reference's pool raise ``NotImplementedError`` naming the slice that
brings them.
"""

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
)

SERVED: tuple[str, ...] = ("qwen1.5-0.5b", "tinyllama-1.1b", "qwen2-72b", "llama3.2-3b")

PENDING = {
    "jamba-1.5-large-398b": "hybrid Mamba/MoE stacks arrive with the model-breadth slice",
    "internvl2-1b": "the vision frontend arrives with the model-breadth slice",
    "grok-1-314b": "MoE FFNs arrive with the model-breadth slice",
    "qwen3-moe-235b-a22b": "MoE FFNs arrive with the model-breadth slice",
    "seamless-m4t-large-v2": "encoder-decoder models arrive with the model-breadth slice",
    "mamba2-2.7b": "Mamba-2 SSD mixers arrive with the model-breadth slice",
}


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

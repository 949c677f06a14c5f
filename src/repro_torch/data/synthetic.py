"""Synthetic batches, deterministic in (seed, step) (counterpart of
``repro/data/synthetic.py``'s real-batch half).

Every draw comes from a CPU ``torch.Generator`` seeded from
``(seed, step)`` and then moves to the device, so the CPU and the card
see the same batch. The values follow the reference's formulas but not
``jax.random``'s bits (parity tests feed the reference's own batches).
The dry-run's input specs (``make_input_specs``, ``token_count``) are
``meta`` tensors: shapes and dtypes, no storage.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, ShapeConfig


def _generator(*entropy: int) -> torch.Generator:
    """A CPU generator seeded from ``entropy`` (such as (seed, step))
    through numpy's ``SeedSequence``: distinct streams for distinct
    tuples."""
    state = np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & (2**63 - 1))


def lm_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0, step: int = 0,
             device=None) -> dict:
    """Skewed synthetic token batch ``{"tokens": (batch, seq) int64}`` on
    ``device`` (default ``cuda``): the reference's Zipf-ish marginal,
    ``floor(-log(u) * V / 8)`` clipped to the vocabulary, u uniform in
    [1e-6, 1). A vision-frontend config adds ``extra_embeds`` and an
    enc-dec config ``src_embeds`` (:func:`frontend_embeds`, drawn after
    the tokens from the same stream)."""
    dev = resolve_device(device)
    gen = _generator(seed, step)
    u = torch.rand((batch, seq), generator=gen) * (1.0 - 1e-6) + 1e-6
    r = torch.floor(-torch.log(u) * cfg.vocab_size / 8.0).to(torch.int64)
    out = {"tokens": torch.clamp(r, 0, cfg.vocab_size - 1).to(dev)}
    if cfg.frontend == "vision":
        out["extra_embeds"] = frontend_embeds(cfg, batch, generator=gen, device=dev)
    elif cfg.is_encdec:
        out["src_embeds"] = frontend_embeds(cfg, batch, generator=gen, device=dev)
    return out


def frontend_embeds(cfg: ModelConfig, batch: int, *, generator: torch.Generator | None = None,
                    device=None) -> torch.Tensor:
    """The stub modality frontend, as the reference's: unit-variance
    (batch, ``cfg.frontend_len``, ``cfg.d_model``) fp32 patch or frame
    embeddings on ``device`` (default ``cuda``), drawn from ``generator``
    (default: a CPU generator seeded with 0)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    x = torch.randn((batch, cfg.frontend_len, cfg.d_model), generator=gen, device=gen.device)
    return x.to(resolve_device(device))


def bnn_image_batch(
    n: int, shape: tuple[int, ...] = (28, 28, 1), classes: int = 10, *, seed: int = 0,
    step: int = 0, device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Class-conditional synthetic images (MNIST/CIFAR stand-ins) on
    ``device`` (default ``cuda``): each class is a fixed random template
    (drawn from ``seed`` alone) plus 0.5 x unit noise, so BNNs actually
    learn. Returns (images (n, *shape) fp32, labels (n,) int64)."""
    dev = resolve_device(device)
    gen = _generator(seed, step)
    labels = torch.randint(0, classes, (n,), generator=gen)
    templates = torch.randn((classes, *shape), generator=_generator(seed + 999))
    x = templates[labels] + 0.5 * torch.randn((n, *shape), generator=gen)
    return x.to(dev), labels.to(dev)


# ---------------------------------------------------------------------------
# Dry-run input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def make_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The inputs of one (arch x shape) cell as ``meta`` tensors, in the
    reference's shapes and dtypes: ``{"tokens": (B, S) int32}`` (plus
    the frontend's fp32 ``extra_embeds`` or ``src_embeds``) for train and
    prefill; ``{"token": (B,), "pos": (), "caches": ...}`` for decode,
    the caches those of ``lm.init_cache`` / ``encdec.init_cache`` on
    ``meta`` (``long_500k``'s allocate nothing)."""
    from repro_torch.models import encdec, lm

    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _spec((b, s), torch.int32)}
        if cfg.frontend == "vision":
            specs["extra_embeds"] = _spec((b, cfg.frontend_len, cfg.d_model), torch.float32)
        elif cfg.is_encdec:
            specs["src_embeds"] = _spec((b, cfg.frontend_len, cfg.d_model), torch.float32)
        return specs
    # decode: one new token against a seq_len-deep cache
    if cfg.is_encdec:
        caches = encdec.init_cache(cfg, b, s, src_len=cfg.frontend_len, device="meta")
    else:
        caches = lm.init_cache(cfg, b, s, device="meta")
    return {"token": _spec((b,), torch.int32), "pos": _spec((), torch.int32), "caches": caches}


def token_count(shape: ShapeConfig) -> int:
    """Tokens processed by one step of the cell (a decode step processes B)."""
    if shape.kind == "decode":
        return shape.global_batch
    return shape.global_batch * shape.seq_len

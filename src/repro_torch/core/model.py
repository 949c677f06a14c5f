"""Executable BNN models (MLP / conv) with selectable execution engines
(counterpart of ``repro/core/model.py``).

Inference runs each binary layer through any backend registered in
``repro_torch.core.engine`` (reference / tacitmap / wdm / packed / ...)
— pass an engine name or an engine instance. All backends are
bit-exact, the paper's point that the mapping "simply accelerates" BNNs
without touching accuracy. First and last layers stay high-precision.

Convolutions are expressed as im2col + VMM, which is literally how the
crossbar executes them (one im2col position = one input vector).

Binarization follows the port's rule, ``x > -2^-126``
(:func:`repro_torch.core.bnn.nonneg`): the reference's ``x >= 0`` with
subnormals read as zero, as XLA reads them. The training forwards
(:func:`mlp_forward_train`, ``conv_forward(train=True)``) binarize
through ``bnn.binarize_ste``, so with parameters that require grad they
carry the reference's straight-through gradient; the engine paths run
without autograd.

Parameters are dicts of fp32 tensors drawn from an explicit
``torch.Generator`` (``init_mlp`` / ``init_conv``) or carried over from
the reference's numpy leaves (:func:`repro_torch.convert.params_dict`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch.core import bnn
from repro_torch.core import engine as engine_lib
from repro_torch.core.crossbar import CrossbarSpec
from repro_torch.core.engine import Engine
from repro_torch.device import resolve_device

EngineLike = str | Engine  # registry name or constructed backend


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    dims: tuple[int, ...] = (784, 500, 250, 10)

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1


def _uniform(gen: torch.Generator, shape, bound: float, dev) -> torch.Tensor:
    """U(-bound, bound) fp32 drawn on the generator's device."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (u * (2.0 * bound) - bound).to(dev)


def init_mlp(gen: torch.Generator, cfg: MLPConfig, *, device=None) -> dict:
    """The reference's shapes and distributions: U(±1/sqrt(m)) weights,
    zero biases, unit BN-lite scales, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    params = {}
    for i, (m, n) in enumerate(zip(cfg.dims[:-1], cfg.dims[1:])):
        params[f"w{i}"] = _uniform(gen, (m, n), 1.0 / math.sqrt(m), dev)
        params[f"b{i}"] = torch.zeros((n,), dtype=torch.float32, device=dev)
        params[f"g{i}"] = torch.ones((n,), dtype=torch.float32, device=dev)
    return params


def _is_edge(i: int, n_layers: int) -> bool:
    return i == 0 or i == n_layers - 1


def _signs(x: torch.Tensor) -> torch.Tensor:
    """±1 fp32 signs by the port's binarize rule."""
    return bnn.binarize_ste(x.to(torch.float32))


def _programmed(eng, w: torch.Tensor):
    """Program the binarized weights through the engine's identity-keyed
    ``WeightCache``, keyed on the latent param ``w`` (stable across
    calls). Binarization is passed lazily — a cache hit pays zero
    weight-side work. Falls back to raw signs for minimal engines
    without the two-phase contract."""
    make = lambda: _signs(w)  # noqa: E731
    if hasattr(eng, "prepare_cached"):
        return eng.prepare_cached(make, key=w)
    return make()


def _binary(eng, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One binary layer through the engine, as fp32."""
    return eng.binary_vmm(_signs(h), _programmed(eng, w)).to(torch.float32)


def _div_sqrt(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x / sqrt(m)`` as a true fp32 division (XLA's): by a 0-dim
    tensor, since CUDA turns a division by a Python scalar into a
    multiply by its reciprocal."""
    return x / torch.tensor(math.sqrt(m), dtype=x.dtype, device=x.device)


def mlp_forward_train(params: dict, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """Training forward: STE binarization on hidden layers (the gradient
    flows through ``bnn.binarize_ste``), binary MACs scaled by
    1/sqrt(m), each layer ending with the learnable affine (g, b) that
    acts as the next sign's threshold."""
    h = x
    for i in range(cfg.n_layers):
        w = params[f"w{i}"]
        if _is_edge(i, cfg.n_layers):
            h = h @ w + params[f"b{i}"]
        else:
            a, wb = bnn.binarize_ste(h), bnn.binarize_ste(w)
            h = _div_sqrt(bnn.binary_matmul_signs(a, wb), w.shape[0]) + params[f"b{i}"]
        if i < cfg.n_layers - 1:
            h = params[f"g{i}"] * h
    return h


@torch.no_grad()
def mlp_forward_infer(
    params: dict,
    x: torch.Tensor,
    cfg: MLPConfig,
    engine: EngineLike = "reference",
    spec: CrossbarSpec | None = None,
) -> torch.Tensor:
    """Deploy-time forward: weights pre-binarized, selectable engine."""
    eng = engine_lib.resolve(engine, spec)
    h = x
    for i in range(cfg.n_layers):
        w = params[f"w{i}"]
        if _is_edge(i, cfg.n_layers):
            h = h @ w + params[f"b{i}"]
        else:
            h = _div_sqrt(_binary(eng, h, w), w.shape[0]) + params[f"b{i}"]
        if i < cfg.n_layers - 1:
            h = params[f"g{i}"] * h
    return h


# ---------------------------------------------------------------------------
# Conv BNN (im2col — the crossbar's native view of convolution)
# ---------------------------------------------------------------------------


def im2col(x: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """(B, H, W, C) -> (B, H', W', k*k*C): one row per conv position."""
    b, h, w, c = x.shape
    oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    patches = [
        x[:, dy : dy + oh * stride : stride, dx : dx + ow * stride : stride, :]
        for dy in range(k)
        for dx in range(k)
    ]
    return torch.cat(patches, dim=-1).reshape(b, oh, ow, k * k * c)


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    """LeNet-style BNN: convs then FCs; first/last layers hi-res."""

    in_hw: int = 28
    in_ch: int = 1
    convs: tuple[tuple[int, int], ...] = ((6, 5), (16, 5))  # (out_ch, k)
    pools: tuple[int, ...] = (2, 2)
    fcs: tuple[int, ...] = (120, 84, 10)


def conv_feature_dims(cfg: ConvConfig) -> tuple[int, int]:
    hw, c = cfg.in_hw, cfg.in_ch
    for (out_ch, k), pool in zip(cfg.convs, cfg.pools):
        hw = (hw - k + 1) // pool
        c = out_ch
    return hw, c


def init_conv(gen: torch.Generator, cfg: ConvConfig, *, device=None) -> dict:
    """The reference's shapes and distributions (U(±1/sqrt(m)) conv and
    FC weights, unit conv scales, zero FC biases) on ``device``."""
    dev = resolve_device(device)
    params = {}
    c = cfg.in_ch
    for i, (out_ch, k) in enumerate(cfg.convs):
        m = k * k * c
        params[f"cw{i}"] = _uniform(gen, (m, out_ch), 1.0 / math.sqrt(m), dev)
        params[f"cg{i}"] = torch.ones((out_ch,), dtype=torch.float32, device=dev)
        c = out_ch
    hw, c = conv_feature_dims(cfg)
    dims = (hw * hw * c,) + cfg.fcs
    for i, (m, n) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"fw{i}"] = _uniform(gen, (m, n), 1.0 / math.sqrt(m), dev)
        params[f"fb{i}"] = torch.zeros((n,), dtype=torch.float32, device=dev)
    return params


def _avgpool(x: torch.Tensor, p: int) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // p, p, w // p, p, c).mean(dim=(2, 4))


def conv_forward(
    params: dict,
    x: torch.Tensor,
    cfg: ConvConfig,
    train: bool = True,
    engine: EngineLike = "reference",
    spec: CrossbarSpec | None = None,
) -> torch.Tensor:
    """(B, H, W, C) images -> logits. Binary layers = all but first/last;
    ``train=True`` is the training forward (STE signs, plain ±1 matmul,
    differentiable), ``train=False`` runs them through the engine, with
    autograd off."""
    with contextlib.nullcontext() if train else torch.no_grad():
        return _conv_forward(params, x, cfg, train, engine_lib.resolve(engine, spec))


def _conv_forward(params: dict, x: torch.Tensor, cfg: ConvConfig, train: bool, eng):
    n_fc = len(cfg.fcs)
    h = x
    for i, ((out_ch, k), pool) in enumerate(zip(cfg.convs, cfg.pools)):
        cols = im2col(h, k)  # (B, oh, ow, m)
        w = params[f"cw{i}"]
        scale = 1.0 / math.sqrt(w.shape[0])
        if i == 0:  # hi-res edge layer
            h = cols @ w
        elif train:
            h = bnn.binary_matmul_signs(bnn.binarize_ste(cols), bnn.binarize_ste(w)) * scale
        else:
            h = _binary(eng, cols, w) * scale
        h = params[f"cg{i}"] * h  # learnable pre-sign affine (no ReLU: see mlp)
        h = _avgpool(h, pool)
    h = h.reshape(h.shape[0], -1)
    for i in range(n_fc):
        w = params[f"fw{i}"]
        scale = 1.0 / math.sqrt(w.shape[0])
        if i == n_fc - 1:  # hi-res edge layer
            h = h @ w + params[f"fb{i}"]
        elif train:
            h = bnn.binary_matmul_signs(bnn.binarize_ste(h), bnn.binarize_ste(w)) * scale
            h = h + params[f"fb{i}"]
        else:
            h = _binary(eng, h, w) * scale + params[f"fb{i}"]
    return h

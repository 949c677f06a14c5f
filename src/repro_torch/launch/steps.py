"""Step cells for the dry-run (counterpart of ``repro/launch/steps.py``):
one (arch x shape) cell's step function, its arguments as ``meta``
tensors, their partition specs and DTensor placements, the donation list
and the activation-hint settings.

Everything here is shape-only (``meta`` tensors and the partitioner's
rules), so the dry-run builds 512-rank cells without allocating: jamba's
398 B parameters are never materialized. The reference's ``lower_cell``
(jit lowering and compile) has no torch counterpart; the dry-run stops at
the specs (ROADMAP).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as tree_lib
from repro_torch.data import make_input_specs
from repro_torch.distributed.partitioner import (
    P,
    batch_specs,
    cache_specs,
    data_axes,
    fsdp_batch_axes,
    infer_specs,
    mesh_shape,
    opt_state_specs,
    to_placements,
)
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train.loop import TrainLoopConfig, make_train_step


def default_opt_cfg(cfg: ModelConfig) -> OptConfig:
    """Factored second moment for 100B+ models: the difference between
    optimizer state fitting a 256-chip pod or not."""
    return OptConfig(factored=cfg.param_count() > 100e9)


def param_shapes(cfg: ModelConfig, *, compute_dtype: bool = True) -> Any:
    """The reference's stacked parameter tree as ``meta`` tensors.
    ``compute_dtype=True`` (production) holds matrices in bf16 (the fp32
    master lives in the optimizer state); 1-D leaves (norm scales,
    biases, SSM A/D/dt) stay fp32. A stacked leaf's leading repeat dim
    counts, so a "matrix" is any leaf of ndim >= 2."""
    fam = encdec_lib if cfg.is_encdec else lm_lib
    tree = fam.param_tree(fam.init_params(torch.Generator(), cfg, device="meta"), device="meta")
    if not compute_dtype:
        return tree

    def cast(t):
        return t.to(torch.bfloat16) if t.ndim >= 2 and t.dtype == torch.float32 else t

    return tree_lib.tree_map(cast, tree)


def opt_shapes(params: Any, opt_cfg: OptConfig) -> dict:
    """The optimizer state of ``params`` (``meta`` in, ``meta`` out)."""
    return adamw_init(params, opt_cfg)


def train_wants_fsdp(cfg: ModelConfig, shape: ShapeConfig, mesh) -> bool:
    """ZeRO-3 batch sharding when the DP-only residual-stream carries
    (per-layer remat saves) pass 4 GiB per device: carry = B S / dp x
    d_model x 2 B x layers (the reference's memory criterion)."""
    if not fsdp_batch_axes(shape.global_batch, mesh):
        return False
    sizes = mesh_shape(mesh).shape
    dp = 1
    for a in data_axes(mesh):
        dp *= sizes[a]
    layers = cfg.n_layers + cfg.n_encoder_layers
    carry = shape.global_batch * shape.seq_len / dp * cfg.d_model * 2 * layers
    return carry > 4 * 2**30


def _prefill_caches(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The caches a prefill of the cell's prompts returns (``meta``): a
    VLM's cover its patches too, an enc-dec's its frames as cross rows."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return encdec_lib.init_cache(cfg, b, s, src_len=cfg.frontend_len, device="meta")
    extra = cfg.frontend_len if cfg.frontend == "vision" else 0
    return lm_lib.init_cache(cfg, b, s + extra, device="meta")


def _placements(specs: Any, mesh) -> Any:
    return tree_lib.tree_map(lambda sp: to_placements(sp, mesh), specs)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Everything one (arch x shape) cell needs: ``fn`` (the port's step,
    prefill or decode entry point), ``args`` (its arguments' shapes, a
    tuple of ``meta`` trees; ``out`` the outputs' that the specs cover),
    ``in_specs`` / ``out_specs`` and their ``in_placements`` /
    ``out_placements`` on ``mesh`` (a ``MeshShape`` or ``DeviceMesh``),
    ``donate_argnums`` and ``hint_kw`` for ``activation_hints``."""
    specs = make_input_specs(cfg, shape)
    p_shapes = param_shapes(cfg)
    fsdp = shape.kind == "train" and train_wants_fsdp(cfg, shape, mesh)
    p_spec = infer_specs(p_shapes, mesh, fsdp=fsdp)
    rep = P()
    logits_spec = batch_specs(torch.empty((shape.global_batch, 1), device="meta"), mesh)

    if shape.kind == "train":
        opt_cfg = default_opt_cfg(cfg)
        o_shapes = opt_shapes(p_shapes, opt_cfg)
        o_spec = opt_state_specs(p_spec, o_shapes)
        cell = {
            "fn": make_train_step(cfg, opt_cfg, TrainLoopConfig(total_steps=10_000,
                                                                warmup_steps=100)),
            "args": (p_shapes, o_shapes, specs, torch.empty((), dtype=torch.int32,
                                                            device="meta")),
            "in_specs": (p_spec, o_spec, batch_specs(specs, mesh, fsdp=fsdp), rep),
            "out": (p_shapes, o_shapes),
            "out_specs": (p_spec, o_spec),
            "donate_argnums": (0, 1),
            "hint_kw": ({"batch_axes": fsdp_batch_axes(shape.global_batch, mesh), "tp": False}
                        if fsdp else {}),
        }
    elif shape.kind == "prefill":
        if cfg.is_encdec:
            def fn(model, batch):
                return encdec_lib.prefill(model, batch["src_embeds"], batch["tokens"], cfg)
        elif cfg.frontend == "vision":
            def fn(model, batch):
                return lm_lib.prefill(model, batch["tokens"], cfg, batch["extra_embeds"])
        else:
            def fn(model, batch):
                return lm_lib.prefill(model, batch["tokens"], cfg)
        caches = _prefill_caches(cfg, shape)
        cell = {
            "fn": fn,
            "args": (p_shapes, specs),
            "in_specs": (p_spec, batch_specs(specs, mesh)),
            "out": (torch.empty((shape.global_batch, cfg.padded_vocab), device="meta"), caches),
            "out_specs": (logits_spec, cache_specs(caches, mesh)),
            "donate_argnums": (),
            "hint_kw": {},
        }
    else:  # decode: one token against a seq_len-deep cache
        decode = encdec_lib.decode_step if cfg.is_encdec else lm_lib.decode_step

        def fn(model, token, pos, caches):
            return decode(model, token, pos, caches, cfg)

        c_spec = cache_specs(specs["caches"], mesh)
        cell = {
            "fn": fn,
            "args": (p_shapes, specs["token"], specs["pos"], specs["caches"]),
            "in_specs": (p_spec, batch_specs(specs["token"], mesh), rep, c_spec),
            "out": (torch.empty((shape.global_batch, cfg.padded_vocab), device="meta"),
                    specs["caches"]),
            "out_specs": (logits_spec, c_spec),
            "donate_argnums": (3,),
            "hint_kw": {},
        }
    cell["in_placements"] = tuple(_placements(s, mesh) for s in cell["in_specs"])
    cell["out_placements"] = tuple(_placements(s, mesh) for s in cell["out_specs"])
    return cell

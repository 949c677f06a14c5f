"""Convert between the reference package's parameter trees and the
port's.

:func:`params_from_jax` takes the LM parameter pytree with numpy leaves
(for example ``jax.tree.map(np.asarray,
repro.models.lm.init_params(key, cfg))``): a nested dict whose block
parameters are stacked over repeats, ``(R, m, n)`` per projection,
``(R, E, d, f)`` per expert stack and ``(R, d)`` per norm, with an
``attn`` or ``mamba`` mixer and an ``ffn``, ``moe`` or no FFN per slot,
and builds an ``LM``; :func:`encdec_from_jax` does the same for the
enc-dec tree (``repro.models.encdec.init_params``: ``enc_blocks`` /
``dec_blocks`` stacked over layers) and builds an ``EncDec``.
:func:`mamba_from_jax` and :func:`moe_from_jax`
take one layer's unstacked ``mamba`` / ``moe`` subtree (the reference's
``ssm.mamba_init`` / ``moe.moe_init``). :func:`params_dict` carries a
flat parameter dict, such as the paper MLP's or LeNet's
(``repro.core.model.init_mlp`` / ``init_conv``), into fp32 tensors for
``repro_torch.core.model``. Both packages then compute on the same
weights, which is how the parity tests hold the port against the
reference.

The other direction: :func:`params_to_jax` and :func:`grads_to_jax`
give an ``LM``'s parameters and gradients as the reference's numpy tree
(stacked over repeats, :func:`repro_torch.models.lm.param_tree`);
:func:`encdec_to_jax` and :func:`encdec_grads_to_jax` give an
``EncDec``'s as the reference's enc-dec tree
(:func:`repro_torch.models.encdec.param_tree`); and
:func:`tree_to_jax` / :func:`tree_from_jax` carry a tree that already
has the reference's layout, such as the optimizer state (``m``, ``v``
or its factored ``vr`` / ``vc``, ``step``), leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.device import resolve_device
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models.encdec import (
    DEC_LAYER,
    ENC_LAYER,
    PROJECTIONS,
    DecoderLayer,
    EncDec,
    EncoderLayer,
)
from repro_torch.models.layers import FFN, Attention, BitLinear
from repro_torch.models.lm import LM, Block
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba


def _to(dev):
    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)
    return t


def mamba_from_jax(p: dict, *, device=None) -> Mamba:
    """One layer's reference ``mamba`` subtree (numpy leaves) -> a
    :class:`Mamba` on ``device`` (default ``cuda``)."""
    t = _to(resolve_device(device))
    return Mamba(**{name: t(p[name]["w"]) for name in Mamba.PROJECTIONS},
                 **{name: t(p[name]) for name in Mamba.VECTORS})


def moe_from_jax(p: dict, *, device=None) -> MoE:
    """One layer's reference ``moe`` subtree (numpy leaves) -> a
    :class:`MoE` on ``device`` (default ``cuda``)."""
    t = _to(resolve_device(device))
    return MoE(*(t(p[name]) for name in MoE.LEAVES))


def params_from_jax(tree: dict, *, device=None) -> LM:
    """The JAX parameter tree (numpy leaves) -> an ``LM`` on ``device``
    (default ``cuda``). Layer ``r * P + i`` takes repeat ``r`` of slot
    ``i``, the order the reference's scan applies them in."""
    dev = resolve_device(device)
    t = _to(dev)

    def proj(p: dict, r: int) -> BitLinear:
        return BitLinear(t(p["w"][r]), t(p["b"][r]) if "b" in p else None)

    def repeat(sub: dict, r: int) -> dict:
        return tree_lib.tree_map(lambda x: x[r], sub)

    def block(sp: dict, r: int) -> Block:
        if "attn" in sp:
            mixer = Attention(*(proj(sp["attn"][k], r) for k in ("q", "k", "v", "o")))
        else:
            mixer = mamba_from_jax(repeat(sp["mamba"], r), device=dev)
        if "moe" in sp:
            f = moe_from_jax(repeat(sp["moe"], r), device=dev)
        elif "ffn" in sp:
            f = FFN(*(proj(sp["ffn"][k], r) for k in ("w1", "w3", "w2")))
        else:
            return Block(t(sp["norm1"][r]), mixer)
        return Block(t(sp["norm1"][r]), mixer, t(sp["norm2"][r]), f)

    slots = tree["blocks"]
    n_slots = len(slots)
    n_repeats = slots["slot0"]["norm1"].shape[0]
    blocks = [block(slots[f"slot{i}"], r) for r in range(n_repeats) for i in range(n_slots)]
    head = t(tree["head"]) if "head" in tree else None
    return LM(t(tree["embed"]), t(tree["final_norm"]), head, blocks, n_slots)


def encdec_from_jax(tree: dict, *, device=None) -> EncDec:
    """The reference's enc-dec parameter tree (numpy leaves; ``enc_blocks``
    and ``dec_blocks`` stacked over layers) -> an ``EncDec`` on ``device``
    (default ``cuda``): layer ``i`` from index ``i`` of each stack."""
    t = _to(resolve_device(device))

    def child(sub, kind: str, i: int):
        if kind == "norm":
            return t(sub[i])
        projs = [BitLinear(t(sub[n]["w"][i]), t(sub[n]["b"][i]) if "b" in sub[n] else None)
                 for n in PROJECTIONS[kind]]
        return Attention(*projs) if kind == "attn" else FFN(*projs)

    def layers(stack: dict, spec, cls) -> list:
        n = stack["norm1"].shape[0]
        return [cls(*(child(stack[name], kind, i) for name, kind in spec)) for i in range(n)]

    return EncDec(t(tree["embed"]), t(tree["head"]),
                  layers(tree["enc_blocks"], ENC_LAYER, EncoderLayer), t(tree["enc_norm"]),
                  layers(tree["dec_blocks"], DEC_LAYER, DecoderLayer), t(tree["final_norm"]))


def encdec_to_jax(model: EncDec) -> dict:
    """An ``EncDec`` -> the reference's enc-dec tree with numpy leaves,
    each layer leaf stacked over layers: the inverse of
    :func:`encdec_from_jax`."""
    return tree_to_jax(encdec_lib.param_tree(model, device="cpu"))


def encdec_grads_to_jax(model: EncDec) -> dict:
    """The gradients held by an ``EncDec``'s parameters after a backward,
    as the reference's enc-dec numpy tree (zeros where none arrived); the
    ``.grad`` fields are cleared."""
    return tree_to_jax(encdec_lib.take_grad_tree(model))


def tree_to_jax(tree) -> dict:
    """A tree of tensors -> the same tree with numpy leaves."""
    return tree_lib.tree_map(lambda x: x.detach().cpu().numpy(), tree)


def tree_from_jax(tree, *, device=None):
    """A tree of numpy leaves -> tensors of the same dtypes on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    return tree_lib.tree_map(lambda x: torch.from_numpy(np.array(x)).to(dev), tree)


def params_to_jax(model: LM) -> dict:
    """An ``LM`` -> the reference's parameter tree with numpy leaves, the
    block parameters stacked over repeats: the inverse of
    :func:`params_from_jax`."""
    return tree_to_jax(lm_lib.param_tree(model, device="cpu"))


def grads_to_jax(model: LM) -> dict:
    """The gradients held by an ``LM``'s parameters after a backward, as
    the reference's numpy tree (zeros where none arrived); the ``.grad``
    fields are cleared."""
    return tree_to_jax(lm_lib.take_grad_tree(model))


def params_dict(tree: dict, *, device=None) -> dict[str, torch.Tensor]:
    """A flat dict of numpy leaves (the paper MLP/LeNet parameters) ->
    the same keys as fp32 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev) for k, v in tree.items()
    }

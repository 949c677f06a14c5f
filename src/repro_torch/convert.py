"""Convert the reference package's parameter tree into the port's ``LM``.

The input is the JAX parameter pytree with numpy leaves (for example
``jax.tree.map(np.asarray, repro.models.lm.init_params(key, cfg))``):
a nested dict whose block parameters are stacked over repeats, ``(R, m,
n)`` per projection and ``(R, d)`` per norm. Both packages then compute
on the same weights, which is how the parity tests hold the port
against the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import FFN, Attention, BitLinear
from repro_torch.models.lm import LM, Block


def params_from_jax(tree: dict, *, device=None) -> LM:
    """The JAX parameter tree (numpy leaves) -> an ``LM`` on ``device``
    (default ``cuda``). Layer ``r * P + i`` takes repeat ``r`` of slot
    ``i``, the order the reference's scan applies them in."""
    dev = resolve_device(device)

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    def proj(p: dict, r: int) -> BitLinear:
        return BitLinear(t(p["w"][r]), t(p["b"][r]) if "b" in p else None)

    slots = tree["blocks"]
    n_slots = len(slots)
    for name, sp in slots.items():
        if "attn" not in sp or "ffn" not in sp:
            raise NotImplementedError(
                f"block {name} holds {sorted(sp)}: only attention + dense FFN "
                "blocks are ported (Mamba/MoE arrive with the model-breadth slice)"
            )
    n_repeats = slots["slot0"]["norm1"].shape[0]
    blocks = []
    for r in range(n_repeats):
        for i in range(n_slots):
            sp = slots[f"slot{i}"]
            a, f = sp["attn"], sp["ffn"]
            blocks.append(Block(
                t(sp["norm1"][r]),
                Attention(*(proj(a[k], r) for k in ("q", "k", "v", "o"))),
                t(sp["norm2"][r]),
                FFN(*(proj(f[k], r) for k in ("w1", "w3", "w2"))),
            ))
    head = t(tree["head"]) if "head" in tree else None
    return LM(t(tree["embed"]), t(tree["final_norm"]), head, blocks)

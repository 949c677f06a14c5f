"""AdamW with an optional factored second moment (counterpart of
``repro/optim/adamw.py``).

``state = adamw_init(params, cfg)``, ``adamw_update(grads, params,
state, lr, cfg)``. Trees are the reference's: nested dicts of tensors
keyed by its paths (``repro_torch.tree``), and for a language model the
stacked layout of :func:`repro_torch.models.lm.param_tree`, whose block
leaves are (L, ...) over the layers. The rules read the stacked leaf as
the reference's do: weight decay applies to leaves of ndim >= 2 (block
norms (L, d) and biases (L, n) are decayed, ``final_norm`` is not), a
leaf is factored when it has ndim >= 2 and at least
``factored_min_size`` elements counted over the whole stack, and the
factored statistics run over its trailing two dims.

Unlike the reference's, the update is in place: ``params`` and ``state``
are overwritten with the values the reference would return (each new
value is computed out of place in the reference's fp32 order, then
copied in). Every division is tensor by tensor: PyTorch turns a Python
scalar divided by a tensor into a reciprocal multiply, and CUDA a tensor
divided by a host scalar.

Factored mode (``cfg.factored=True``): tensors with ndim >= 2 keep only
row/col second-moment statistics (Adafactor, Shazeer & Stern 2018) --
O(n+m) instead of O(nm) memory; the first moment stays dense.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class OptConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    factored: bool = False
    factored_min_size: int = 128 * 128  # only factor tensors at least this big
    eps_factored: float = 1e-30
    # keep an fp32 master copy in the optimizer state and write the
    # params in their own dtype; on when any param is not fp32
    master_weights: bool | None = None


def _factorable(x: torch.Tensor, cfg: OptConfig) -> bool:
    return cfg.factored and x.ndim >= 2 and x.numel() >= cfg.factored_min_size


def _wants_master(params: Any, cfg: OptConfig) -> bool:
    if cfg.master_weights is not None:
        return cfg.master_weights
    return any(p.dtype != torch.float32 for p in tree_lib.leaves(params))


def adamw_init(params: Any, cfg: OptConfig) -> dict:
    """Zero moments (``v`` as ``{"vr", "vc"}`` for factored leaves), step
    0, and fp32 master weights when wanted, on the params' device."""

    def init_v(p):
        if _factorable(p, cfg):
            return {
                "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                  device=p.device),
            }
        return torch.zeros_like(p, dtype=torch.float32)

    device = tree_lib.leaves(params)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_lib.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": tree_lib.tree_map(init_v, params),
    }
    if _wants_master(params, cfg):
        state["master"] = tree_lib.tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                                            params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32))) for t in tree_lib.leaves(tree)))


def _update_v(g2: torch.Tensor, v, cfg: OptConfig):
    """Second-moment EMA; returns (new_v, the dense v estimate)."""
    if isinstance(v, dict):  # factored
        vr = cfg.b2 * v["vr"] + (1 - cfg.b2) * torch.mean(g2, dim=-1)
        vc = cfg.b2 * v["vc"] + (1 - cfg.b2) * torch.mean(g2, dim=-2)
        # reconstruct: v_hat ~ vr (x) vc / mean(vr)
        denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), cfg.eps_factored)
        vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
        return {"vr": vr, "vc": vc}, vhat
    vnew = cfg.b2 * v + (1 - cfg.b2) * g2
    return vnew, vnew


@torch.no_grad()
def adamw_update(grads: Any, params: Any, state: dict, lr, cfg: OptConfig) -> tuple[Any, dict]:
    """One AdamW step, in place on ``params`` and ``state`` (returned)."""
    step = state["step"] + 1
    device = step.device
    one = torch.ones((), dtype=torch.float32, device=device)
    # global-norm clip (fp32)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm * one / torch.clamp_min(gn, 1e-12), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32).to(device)
    has_master = "master" in state

    for path, g in tree_lib.leaves_with_paths(grads):
        p = tree_lib.get(params, path)
        m = tree_lib.get(state["m"], path)
        v = tree_lib.get(state["v"], path)
        w = tree_lib.get(state["master"], path) if has_master else p
        g = g.to(torch.float32) * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2, vhat = _update_v(g * g, v, cfg)
        mhat = m2 / bc1
        vhat = vhat / bc2
        upd = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:  # no decay on 1-D leaves (final_norm)
            upd = upd + cfg.weight_decay * w.to(torch.float32)
        w2 = w.to(torch.float32) - lr * upd
        p.copy_(w2.to(p.dtype))
        m.copy_(m2)
        if isinstance(v, dict):
            v["vr"].copy_(v2["vr"])
            v["vc"].copy_(v2["vc"])
        else:
            v.copy_(v2)
        if has_master:
            w.copy_(w2)
    state["step"].copy_(step)
    return params, state

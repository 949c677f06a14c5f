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
are overwritten with the values the reference would return (the
reference's fp32 operations in its order, each rounded once, several of
them in place so that a leaf needs few leaf-sized temporaries).
:func:`adamw_begin` takes the global norm and returns a per-leaf update,
so a caller may hand it one parameter leaf at a time. Every division is
tensor by tensor: PyTorch turns a Python scalar divided by a tensor into
a reciprocal multiply, and CUDA a tensor divided by a host scalar.

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


def _update_v_(g2: torch.Tensor, v, cfg: OptConfig) -> torch.Tensor:
    """The second-moment EMA, written into ``v`` (its ``vr`` / ``vc`` when
    factored); returns the dense v estimate, a new tensor. ``g2`` is
    consumed."""
    if isinstance(v, dict):  # factored
        v["vr"].mul_(cfg.b2).add_((1 - cfg.b2) * torch.mean(g2, dim=-1))
        v["vc"].mul_(cfg.b2).add_((1 - cfg.b2) * torch.mean(g2, dim=-2))
        # reconstruct: v_hat ~ vr (x) vc / mean(vr)
        denom = torch.clamp_min(torch.mean(v["vr"], dim=-1, keepdim=True), cfg.eps_factored)
        return (v["vr"][..., None] * v["vc"][..., None, :]).div_(denom[..., None])
    v.mul_(cfg.b2).add_(g2.mul_(1 - cfg.b2))
    return v.clone()


@torch.no_grad()
def adamw_begin(grads: Any, state: dict, lr, cfg: OptConfig):
    """Start one AdamW step: take the global norm over every gradient and
    advance ``state["step"]``. Returns ``update(path, p)``, which applies
    the step to the parameter ``p`` at ``path`` (and to the state's
    leaves there), in place; call it once per leaf of ``grads``, in any
    order. Each leaf's arithmetic is the reference's fp32 sequence, one
    rounding per operation as there, with at most a few leaf-sized
    temporaries alive: a caller that holds one parameter leaf at a time
    (``lm.update_params_``) needs no copy of the whole tree."""
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
    state["step"].copy_(step)

    @torch.no_grad()
    def update(path: tuple[str, ...], p: torch.Tensor) -> None:
        m = tree_lib.get(state["m"], path)
        v = tree_lib.get(state["v"], path)
        w = tree_lib.get(state["master"], path) if has_master else p
        g = tree_lib.get(grads, path).to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)  # m2 = b1 * m + (1 - b1) * g
        vhat = _update_v_(g.mul_(g), v, cfg).div_(bc2)
        del g
        upd = (m / bc1).div_(vhat.sqrt_().add_(cfg.eps))  # mhat / (sqrt(vhat) + eps)
        del vhat
        if cfg.weight_decay and p.ndim >= 2:  # no decay on 1-D leaves (final_norm)
            upd.add_(w.to(torch.float32) * cfg.weight_decay)
        upd.mul_(lr)
        if w.dtype == torch.float32:
            w.sub_(upd)  # w2 = w - lr * upd
        else:
            w.copy_(w.to(torch.float32).sub_(upd))
        if has_master:
            p.copy_(w.to(p.dtype))

    return update


def adamw_update(grads: Any, params: Any, state: dict, lr, cfg: OptConfig) -> tuple[Any, dict]:
    """One AdamW step, in place on ``params`` and ``state`` (returned)."""
    update = adamw_begin(grads, state, lr, cfg)
    for path, _ in tree_lib.leaves_with_paths(grads):
        update(path, tree_lib.get(params, path))
    return params, state

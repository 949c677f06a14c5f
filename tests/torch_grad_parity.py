"""Shared by the training-breadth parity tests (tests/test_torch_train_*.py):
the port's loss and gradients against ``jax.value_and_grad`` of the JAX
package's loss, run op by op (``jax.disable_jit``; under ``jit`` XLA
fuses the residual add into the next RMSNorm, see
tests/test_torch_generate.py), on the same seeded weights and batch.

Tolerances, held by :func:`assert_loss_and_grads_match`:

* the loss to ``LOSS_RTOL`` = 1e-6 relative: the forward is the serving
  forward, equal bit for bit, but for the fp32 log-sum-exp's order;
* every gradient leaf to ``LEAF_TOL`` = 2e-2 of its largest magnitude:
  the backward rounds its bf16 cotangents after sums taken in another
  order (XLA's reductions vs PyTorch's), a bf16 ulp is 2^-8 of a value,
  and the MoE experts and the SSD's inputs run in bf16;
* Mamba's per-head leaves ``mamba/{D, A_log, dt_bias}`` to
  ``HEAD_TOL`` = 1e-1 of their largest magnitude: each element is a sum
  over every (batch, position), with terms of both signs, so the
  cotangents' bf16 roundings add up against a small total; and ``D``'s
  gradient is a sum of bf16 products that the reference's transpose of
  the broadcast ``D[:, None].astype(bf16)`` accumulates in bf16, one
  term after another (XLA's CPU ``reduce_sum`` in the operand's dtype;
  pinned by tests/test_torch_train_ssm.py), where the port accumulates
  in fp32: a sequential bf16 sum of n terms strays from the exact one by
  about sqrt(n) half-ulps of its running total (n = 512 on the smoke
  configs: 2-5% seen), the port's by one bf16 rounding;
* the hybrid stack with binarized projections (jamba, bnn; given the
  reference's Mamba numerics, tests/test_torch_train_jamba.py) to
  ``DEEP_TOL`` = 3e-2: the deepest smoke stack, whose cotangents pass
  four layers of bf16 GEMMs (MoE experts and Mamba projections, each a
  rounding whose fp32 sum order differs between the libraries) and the
  STE; its worst leaf outside the per-head ones is the embedding's,
  2.0e-2.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jax_lm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import grads_to_jax, params_from_jax
from repro_torch.models import lm, ssm

LOSS_RTOL = 1e-6
LEAF_TOL = 2e-2
HEAD_TOL = 1e-1
DEEP_TOL = 3e-2
HEAD_LEAVES = ("['mamba']['D']", "['mamba']['A_log']", "['mamba']['dt_bias']")
# the parity batch: (B, S) tokens from default_rng(TOKEN_SEED), weights
# from jax.random.key(0)
BATCH, SEQ, TOKEN_SEED = 2, 16, 1


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def lm_case(arch: str, quant: str, **overrides):
    """The reference's config and params, the port's config and model
    (requiring grad) on the same weights, and the batch for both
    (``extra_embeds`` for a vision config, drawn after the tokens)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), quant=quant, **overrides)
    cfg = dataclasses.replace(get_smoke_config(arch), quant=quant, **overrides)
    jparams = jax_lm.init_params(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu").requires_grad_(True)
    rng = np.random.default_rng(TOKEN_SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["extra_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return jcfg, jparams, cfg, model, batch


def reference_value_and_grad(loss_fn, jparams, batch: dict, jcfg):
    with jax.disable_jit():
        loss, grads = jax.value_and_grad(loss_fn)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    return float(loss), jax.tree.map(np.asarray, grads)


def port_lm_value_and_grad(model, batch: dict, cfg):
    loss = lm.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    loss.backward()
    return float(loss.detach()), grads_to_jax(model)


def leaf_errors(grads: dict, jgrads: dict) -> dict[str, float]:
    """Each leaf's largest difference as a share of the reference leaf's
    largest magnitude, keyed by path; the trees must have one structure
    and every port leaf must be finite."""
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    out = {}
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                                 jax.tree.leaves(grads)):
        name = jax.tree_util.keystr(path)
        assert got.shape == want.shape and np.isfinite(got).all(), name
        scale = float(np.abs(want).max())
        assert scale > 0, name
        out[name] = float(np.abs(got - want).max()) / scale
    return out


def assert_loss_and_grads_match(loss: float, grads: dict, jloss: float, jgrads: dict,
                                leaf_tol: float = LEAF_TOL) -> dict:
    """The module docstring's tolerances; returns the leaf errors."""
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    errors = leaf_errors(grads, jgrads)
    for name, err in errors.items():
        tol = HEAD_TOL if name.endswith(HEAD_LEAVES) else leaf_tol
        assert err <= tol, f"{name}: {err:.4g} of its largest magnitude > {tol}"
    return errors


def _snap(t: torch.Tensor, want) -> torch.Tensor:
    """``t`` with the reference's value ``want`` and ``t``'s gradient
    (``want + (t - t)``: exactly ``want`` forward, identity backward)."""
    w = torch.from_numpy(to_numpy(want)).to(t.dtype)
    return w + (t - t.detach())


def _jnp(t: torch.Tensor):
    dtype = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(to_numpy(t)).astype(dtype)


def given_reference_mamba_numerics(monkeypatch) -> None:
    """Give the port's Mamba mixers the reference's values of the ops
    whose last bit is the platform's: the bf16 projections (a GEMM's
    fp32 sum order decides a rounding at a bf16 midpoint), ``softplus``
    and ``exp`` (an fp32 ulp apart between XLA's and torch's
    transcendentals). Each op's gradient stays the port's own."""
    project, softplus, ssm_inputs = ssm._project, ssm._softplus, ssm._ssm_inputs

    def _project(p, u, name):
        want = jnp.matmul(_jnp(u), _jnp(getattr(p, name)).astype(_jnp(u).dtype))
        return _snap(project(p, u, name), want)

    def _softplus(x):
        return _snap(softplus(x), jax.nn.softplus(_jnp(x)))

    def _ssm_inputs(p, xc, bcv, ccv, dt, cfg):
        x, dt, a, b_mat, c_mat = ssm_inputs(p, xc, bcv, ccv, dt, cfg)
        return x, dt, _snap(a, -jnp.exp(_jnp(p.A_log))), b_mat, c_mat

    monkeypatch.setattr(ssm, "_project", _project)
    monkeypatch.setattr(ssm, "_softplus", _softplus)
    monkeypatch.setattr(ssm, "_ssm_inputs", _ssm_inputs)

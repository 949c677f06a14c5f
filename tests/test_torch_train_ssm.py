"""Training breadth, Mamba-2: the SSD chunked scan, the causal conv and
the gated mixer's gradients. mamba2's smoke config against the JAX
package's ``loss_fn`` and gradient, run op by op (tolerances:
tests/torch_grad_parity.py) and the reference's bf16 sum behind the
wider tolerance of ``mamba/D``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_grad_parity as tp
from repro.models import lm as jax_lm
from repro.models import ssm as jax_ssm
from repro_torch.models import ssm

torch.set_num_threads(1)


@pytest.mark.parametrize("quant", ["none", "bnn"])
def test_mamba2_loss_and_every_gradient_leaf_match_the_reference(quant):
    """Mamba projections are plain bf16 matmuls in both packages, so
    quant only renames the config here."""
    jcfg, jparams, cfg, model, batch = tp.lm_case("mamba2-2.7b", quant)
    jloss, jgrads = tp.reference_value_and_grad(jax_lm.loss_fn, jparams, batch, jcfg)
    loss, grads = tp.port_lm_value_and_grad(model, batch, cfg)
    tp.assert_loss_and_grads_match(loss, grads, jloss, jgrads)


def test_groups_reach_heads_as_the_reference_repeats_them():
    """``ssm._groups_to_heads`` is ``jnp.repeat`` over the group axis, and
    its gradient sums each group's copies."""
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0), requires_grad=True)
    y = ssm._groups_to_heads(x, 3, 2)
    np.testing.assert_array_equal(y.detach().numpy(), np.repeat(x.detach().numpy(), 3, axis=2))
    y.backward(torch.ones_like(y))
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


def test_reference_sums_the_skip_weights_gradient_in_bf16():
    """Why ``mamba/D`` has a wider tolerance: the reference's gradient of
    ``y + x * D[:, None].astype(bf16)`` with respect to D is a bf16 sum
    over (batch, position, head dim), one term after another in
    row-major order; the port's accumulates in fp32 and rounds once,
    which is the exact sum's bf16 rounding. The two differ by up to a few
    percent on smoke-sized inputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 8, 16)).astype(np.float32)
    dy = rng.standard_normal((2, 16, 8, 16)).astype(np.float32)
    jx, jdy = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda d: jx * d[:, None].astype(jnp.bfloat16), jnp.ones((8,)))
        (ref,) = vjp(jdy)
    tx, tdy = (torch.from_numpy(tp.to_numpy(a)).to(torch.bfloat16) for a in (jx, jdy))
    d = torch.ones(8, requires_grad=True)
    (tx * d[:, None].to(torch.bfloat16)).backward(tdy)
    terms = (tdy * tx).permute(2, 0, 1, 3).reshape(8, -1)  # the bf16 products, per head
    sequential = torch.zeros(8, dtype=torch.bfloat16)
    for i in range(terms.shape[1]):
        sequential = sequential + terms[:, i]
    np.testing.assert_array_equal(np.asarray(ref), tp.to_numpy(sequential))
    exact = terms.double().sum(dim=1).to(torch.bfloat16).float()
    np.testing.assert_array_equal(d.grad.numpy(), exact.numpy())
    assert np.abs(np.asarray(ref) - d.grad.numpy()).max() > 0


def _ssd_inputs(dt_value: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    b, s, h, p, g, n = 1, 32, 4, 8, 1, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, g, n)).astype(np.float32) for _ in range(2))
    dt = np.full((b, s, h), dt_value, np.float32) * rng.uniform(0.5, 1.5, (b, s, h)).astype(
        np.float32)
    a = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    return x, dt, a, bm, cm


def _ssd_grads(x, dt, a, bm, cm):
    """``d sum(y) / d (x, dt)`` through each package's chunked SSD scan
    (bf16 x, B, C as the mixer feeds them)."""
    bf = (jnp.bfloat16, torch.bfloat16)

    def jax_loss(x, dt):
        y, _ = jax_ssm.ssd_chunked(x.astype(bf[0]), dt, jnp.asarray(a),
                                   jnp.asarray(bm, bf[0]), jnp.asarray(cm, bf[0]), chunk=16)
        return jnp.sum(y.astype(jnp.float32))

    with jax.disable_jit():
        jgrads = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(dt))
    tx, tdt = (torch.from_numpy(v).requires_grad_(True) for v in (x, dt))
    y, _ = ssm.ssd_chunked(tx.to(bf[1]), tdt, torch.from_numpy(a),
                           torch.from_numpy(bm).to(bf[1]), torch.from_numpy(cm).to(bf[1]), chunk=16)
    y.to(torch.float32).sum().backward()
    return [np.asarray(g) for g in jgrads], [tx.grad.numpy(), tdt.grad.numpy()]


def test_ssd_gradient_stays_finite_past_an_exp_overflow():
    """The masked-out entries of the intra-chunk decay ``exp(ci_q - ci_k)``
    (q < k) grow with the chunk's summed ``dt * |A|``: with dt ~ 1 and
    |A| up to 16 over a 16-position chunk they pass fp32 exp's ~88. The
    reference masks after the exp, so its gradient there is 0 * inf =
    NaN (through the decay into dt's gradient; x's stays finite); the
    port masks first. At dt ~ 0.01 (the init's) both agree."""
    jgrads, grads = _ssd_grads(*_ssd_inputs(1.0))
    assert np.isfinite(jgrads[0]).all() and np.isnan(jgrads[1]).any()
    assert all(np.isfinite(g).all() for g in grads)
    jgrads, grads = _ssd_grads(*_ssd_inputs(0.01))
    for want, got in zip(jgrads, grads, strict=True):
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())

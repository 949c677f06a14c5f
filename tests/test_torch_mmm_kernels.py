"""The port's bitlinear and WDM MMM against the JAX package's kernels
(Pallas in interpret mode) and dense oracles, on numpy-seeded inputs.

With ±1 operands both are integer sums, exact in fp32 in any order, so
the port equals the reference exactly (``assert_array_equal``). A
real-valued bf16 weight makes the MMM's sums depend on their order: there
the two agree to 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import bitlinear as bl
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wdm_mmm as wm

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)


def _signs(rng, shape):
    return np.where(rng.integers(0, 2, size=shape) > 0, 1.0, -1.0).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,m,n", [(1, 32, 8), (8, 100, 24), (128, 512, 128), (9, 513, 3)])
def test_bitlinear_equals_jax_kernel(b, m, n, xdtype):
    rng = np.random.default_rng(b * 3 + m + n)
    jx = jnp.asarray(rng.normal(size=(b, m)), jnp.float32).astype(xdtype)
    w = _signs(rng, (m, n))
    alpha = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
    want = np.asarray(jax_ops.bitlinear(jx, jnp.asarray(w), jnp.asarray(alpha), interpret=True))
    x = _t(np.asarray(jx.astype(jnp.float32)), getattr(torch, xdtype))
    got = ops.bitlinear(x, _t(w), _t(alpha))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.bitlinear_ref(x, _t(w), _t(alpha)).numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ref.bitlinear_ref(jx, jnp.asarray(w), jnp.asarray(alpha)))
    )


def test_bitlinear_leading_dims():
    rng = np.random.default_rng(4)
    x = _t(rng.normal(size=(2, 5, 64)))
    got = ops.bitlinear(x, _t(_signs(rng, (64, 16))), torch.ones(16))
    assert got.shape == (2, 5, 16)


def test_bitlinear_sign_edge_cases_match_jax():
    """x >= 0 as read: 0 and -0.0 binarize to +1, NaN to -1, as
    ``jnp.where(x >= 0, ...)`` does."""
    row = np.array([0.0, -0.0, np.nan, -1.0, 2.0, np.inf, -np.inf, 1e-30], np.float32)
    x = np.tile(row, (3, 4))  # (3, 32)
    w = np.ones((32, 4), np.float32)
    alpha = np.ones((4,), np.float32)
    want = np.asarray(jax_ops.bitlinear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha),
                                        interpret=True))
    got = ops.bitlinear(_t(x), _t(w), _t(alpha)).numpy()
    np.testing.assert_array_equal(got, want)
    # 4 x (+1 +1 -1 -1 +1 +1 -1 +1) = 8
    np.testing.assert_array_equal(got, np.full((3, 4), 8.0, np.float32))


@pytest.mark.parametrize("g,k,m,n", [(1, 16, 256, 64), (3, 16, 100, 30), (2, 4, 512, 128)])
def test_wdm_mmm_equals_jax_kernel(g, k, m, n):
    rng = np.random.default_rng(g + k + m + n)
    groups, w = _signs(rng, (g, k, m)), _signs(rng, (m, n))
    want = np.asarray(jax_ops.wdm_mmm(jnp.asarray(groups), jnp.asarray(w), interpret=True))
    got = ops.wdm_mmm(_t(groups), _t(w))
    assert got.shape == (g, k, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.wdm_mmm_ref(_t(groups), _t(w)).numpy(),
        np.asarray(jax_ref.wdm_mmm_ref(jnp.asarray(groups), jnp.asarray(w))),
    )


def test_wdm_mmm_real_valued_weights():
    """bf16 real-valued weights: both sides multiply the same bf16 values
    and sum in fp32, in different orders (1e-6 relative)."""
    rng = np.random.default_rng(7)
    groups = _signs(rng, (2, 8, 300))
    jw = jnp.asarray(rng.normal(size=(300, 40)), jnp.float32).astype(jnp.bfloat16)
    want = np.asarray(jax_ops.wdm_mmm(jnp.asarray(groups), jw, interpret=True))
    got = ops.wdm_mmm(_t(groups), _t(np.asarray(jw.astype(jnp.float32)), torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("wrapper", ["bitlinear", "mmm"])
def test_kernel_wrappers_check_operands(wrapper):
    a = torch.zeros((4, 16), dtype=torch.bfloat16)
    w = torch.zeros((8, 3), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contraction mismatch"):
        if wrapper == "bitlinear":
            bl.bitlinear_kernel(a, w, torch.ones(3))
        else:
            wm.mmm(a, w)
    with pytest.raises(TypeError):
        if wrapper == "bitlinear":
            bl.bitlinear_kernel(a, torch.zeros((16, 3)), torch.ones(3))
        else:
            wm.mmm(a.float(), torch.zeros((16, 3), dtype=torch.bfloat16))

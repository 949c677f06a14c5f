"""The port's packing, Hamming and fused BitLinear ops against the JAX
package on the same numpy-seeded inputs (Pallas kernels in interpret
mode).

Integer results (packed words, Hamming sums, ±1 dot products) must be
bit-exact. The fused BitLinear's plain version is bit-exact given the
reference's beta; through the wrapper, which computes beta = mean|x| in
torch's summation order, the result may differ by a few fp32 ulps (see
``test_fused_wrapper_within_two_ulps``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_decode as jax_fused
from repro.kernels import ops as jax_ops
from repro.kernels import xnor_matmul as jax_xnor
from repro_torch.kernels import fused_decode, ops, xnor_matmul

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

RAGGED_M = (1, 31, 32, 33, 100, 300)


def _signs(rng, shape):
    return rng.choice(np.array([-1.0, 1.0], np.float32), size=shape)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("m", RAGGED_M)
def test_packing_bit_exact(m):
    rng = np.random.default_rng(m)
    bits = rng.integers(0, 2, size=(3, m)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.pack_bits(_t(bits)).numpy(), np.asarray(jax_ops.pack_bits(jnp.asarray(bits)))
    )
    # along a leading axis too
    np.testing.assert_array_equal(
        ops.pack_bits(_t(bits.T), axis=0).numpy(),
        np.asarray(jax_ops.pack_bits(jnp.asarray(bits.T), axis=0)),
    )
    w = _signs(rng, (m, 37))
    wp = jax_ops.pack_weights(jnp.asarray(w))
    np.testing.assert_array_equal(ops.pack_weights(_t(w)).numpy(), np.asarray(wp))
    np.testing.assert_array_equal(ops.pack_signs(_t(w.T)).numpy(),
                                  np.asarray(jax_ops.pack_signs(jnp.asarray(w.T))))
    np.testing.assert_array_equal(
        ops.pad_packed_weights(ops.pack_weights(_t(w))).numpy(),
        np.asarray(jax_ops.pad_packed_weights(wp)),
    )


def test_sign_bit_word_is_negative_int32():
    """Bit 31 set gives a negative word, as the reference's bitcast does."""
    bits = np.zeros((1, 32), np.int32)
    bits[0, 31] = 1
    assert ops.pack_bits(_t(bits)).item() == -(2**31)
    assert ops.pack_bits(_t(np.ones((1, 32), np.int32))).item() == -1


@pytest.mark.parametrize("m", RAGGED_M)
def test_hamming_plain_bit_exact(m):
    rng = np.random.default_rng(100 + m)
    a = np.asarray(jax_ops.pack_signs(jnp.asarray(_signs(rng, (5, m)))))
    w = np.asarray(jax_ops.pack_weights(jnp.asarray(_signs(rng, (m, 40)))))
    want = jax_xnor.hamming_matmul_packed(
        jnp.asarray(a), jnp.asarray(w), bm=5, bn=40, bkw=a.shape[1], interpret=True
    )
    got = xnor_matmul.hamming_matmul_plain(_t(a), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the wrapper on CPU tensors is the plain version, also against
    # block-padded weights
    padded = ops.pad_packed_weights(_t(w))
    np.testing.assert_array_equal(
        xnor_matmul.hamming_matmul_packed(_t(a), padded, n=40).numpy(), np.asarray(want)
    )


@pytest.mark.parametrize("m", RAGGED_M)
def test_xnor_matmul_bit_exact(m):
    rng = np.random.default_rng(200 + m)
    a, w = _signs(rng, (2, 3, m)), _signs(rng, (m, 19))
    want = np.asarray(jax_ops.xnor_matmul(jnp.asarray(a), jnp.asarray(w), interpret=True))
    got = ops.xnor_matmul(_t(a), _t(w))
    assert got.shape == (2, 3, 19) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), (a @ w).astype(np.int32))


@pytest.mark.parametrize(
    "rows,m,n", [(1, 64, 16), (3, 100, 48), (8, 300, 130), (5, 32, 7)]
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plain_bit_exact_given_beta(rows, m, n, dtype):
    """Same x, words, alpha and beta -> the very same fp32 output as the
    reference kernel (fp32 or bf16 activations: x >= 0 is the same bit)."""
    rng = np.random.default_rng(rows * 1000 + m + n)
    x = np.array(jnp.asarray(rng.normal(size=(rows, m)), jnp.bfloat16).astype(jnp.float32))
    x[0, 0] = 0.0   # +1
    x[0, -1] = -0.0  # +1 as well
    wp = np.asarray(jax_ops.pack_weights(jnp.asarray(_signs(rng, (m, n)))))
    alpha = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    beta = np.abs(x).mean(axis=-1).astype(np.float32)
    kw = wp.shape[0]
    xp = np.pad(x, ((0, 0), (0, kw * 32 - m)), constant_values=-1.0)
    want = jax_fused.fused_bnn_matmul_kernel(
        jnp.asarray(xp), jnp.asarray(wp), jnp.asarray(alpha[None]), jnp.asarray(beta[:, None]),
        m=m, bm=rows, bn=n, bkw=kw, interpret=True,
    )
    got = fused_decode.fused_bnn_matmul_plain(
        _t(x).to(dtype), _t(wp), _t(alpha), _t(beta), m=m, n=n
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the wrapper takes the same path on CPU tensors
    np.testing.assert_array_equal(
        fused_decode.fused_bnn_matmul_kernel(
            _t(x).to(dtype), _t(wp), _t(alpha), _t(beta), m=m, n=n
        ).numpy(),
        np.asarray(want),
    )


def test_fused_plain_nan_binarizes_to_minus_one():
    x = torch.tensor([[float("nan"), 1.0, -1.0]])
    w = torch.ones((3, 1))
    out = fused_decode.fused_bnn_matmul_plain(
        x, ops.pack_weights(w), torch.ones(1), torch.ones(1), m=3, n=1
    )
    assert out.item() == -1.0  # (-1) + 1 + (-1)


@pytest.mark.parametrize(
    "lead,m,n,alpha_kind,prepad",
    [
        ((4,), 100, 48, "vector", False),
        ((3,), 70, 20, "scalar", False),
        ((2, 3), 64, 33, "vector", False),   # (G, K) stacked groups
        ((2, 3, 2), 40, 16, "scalar", False),
        ((5,), 300, 130, "vector", True),    # block-padded artifact
    ],
)
def test_fused_wrapper_within_two_ulps(lead, m, n, alpha_kind, prepad):
    """``ops.fused_bnn_matmul`` vs the reference's. beta = mean|x| is summed
    in torch's order here and XLA's there, so it may differ by an ulp;
    ``dot * (alpha * beta)`` then rounds twice, so the outputs agree to
    2 fp32 ulps. The ±1 dot products themselves are exact (see the
    plain-version test above)."""
    rng = np.random.default_rng(m * n)
    x = jnp.asarray(rng.normal(size=(*lead, m)), jnp.bfloat16)
    wp = jax_ops.pack_weights(jnp.asarray(_signs(rng, (m, n))))
    if prepad:
        wp = jax_ops.pad_packed_weights(wp)
    alpha = (
        jnp.asarray(rng.uniform(0.5, 2.0, size=(n,)), jnp.float32)
        if alpha_kind == "vector" else jnp.float32(0.37)
    )
    want = np.asarray(jax_ops.fused_bnn_matmul(x, wp, alpha, m=m, n=n, interpret=True))
    got = ops.fused_bnn_matmul(
        _t(x.astype(jnp.float32)).to(torch.bfloat16),
        _t(wp), torch.as_tensor(np.asarray(alpha)), m=m, n=n,
    )
    assert got.shape == (*lead, n) and got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)


def test_fused_wrapper_rejects_short_artifact():
    wp = ops.pack_weights(torch.ones((32, 4)))
    with pytest.raises(ValueError, match="words"):
        ops.fused_bnn_matmul(torch.ones((2, 64)), wp, 1.0, m=64, n=4)

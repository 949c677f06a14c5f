"""The port's binarize bit against the JAX package's on the values where
the two once disagreed: signed subnormals, the least normal magnitude,
signed zeros and NaN, in bf16 and fp32.

XLA (on the CPU, as on the TPU) reads subnormals as zero in a comparison,
so the reference's ``x >= 0`` gives a negative subnormal +1. The port
binarizes by ``x > -2^-126`` (``bnn.nonneg``), which gives the same bit
whether or not the hardware flushes subnormals. Every site must agree:
``bnn.binarize_ste`` (the unfused and Hamming paths), the plain versions
of the fused BitLinear and of bitlinear, and the CUDA kernels, whose bf16
sign trick is emulated here over every bf16 bit pattern.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnn as jax_bnn
from repro.kernels import fused_decode as jax_fused
from repro.kernels import ops as jax_ops
from repro_torch.core import bnn
from repro_torch.kernels import _build, bitlinear, fused_decode, ops, ref

TINY = 2.0**-133  # bf16's least subnormal
SPECIAL = {
    "+2^-133": TINY, "-2^-133": -TINY, "+3*2^-133": 3 * TINY, "-3*2^-133": -3 * TINY,
    "-2^-126": -(2.0**-126), "+0.0": 0.0, "-0.0": -0.0, "nan": float("nan"),
}
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}


def _rows(value: float, seed: int = 0) -> np.ndarray:
    """(3, 70) fp32 values exact in bf16, every fifth one ``value``."""
    rng = np.random.default_rng(seed)
    x = np.array(jnp.asarray(rng.normal(size=(3, 70)), jnp.bfloat16).astype(jnp.float32))
    x[:, ::5] = value
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("value", SPECIAL)
def test_binarize_and_pack_equal_jax(value, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _rows(SPECIAL[value])
    xt, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    np.testing.assert_array_equal(bnn.nonneg(xt).numpy(), np.asarray(jx >= 0))
    np.testing.assert_array_equal(
        ops.pack_signs(bnn.binarize_ste(xt)).numpy(),
        np.asarray(jax_ops.pack_signs(jax_bnn.binarize_ste(jx))),
    )
    # the reference's straight-through form x + (sign - x) carries a NaN
    # through; every other value gives the sign itself
    want = np.asarray(jax_bnn.binarize_ste(jx).astype(jnp.float32))
    got = bnn.binarize_ste(xt).float().numpy()
    keep = ~np.isnan(x)
    np.testing.assert_array_equal(got[keep], want[keep])
    assert set(np.unique(got).tolist()) <= {-1.0, 1.0}


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_equal_jax_with_subnormals(dtype):
    """The fused BitLinear's and bitlinear's plain versions and the
    bitlinear oracle, on rows holding every special value, equal the JAX
    package's ops (Pallas in interpret mode) bit for bit."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = _rows(0.0, seed=3)
    for j, v in enumerate(SPECIAL.values()):
        x[:, j::9] = v
    m, n = x.shape[1], 24
    w = np.where(rng.integers(0, 2, size=(m, n)) > 0, 1.0, -1.0).astype(np.float32)
    alpha = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
    beta = rng.uniform(0.5, 2.0, (x.shape[0],)).astype(np.float32)
    xt, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    wt, at = torch.from_numpy(w), torch.from_numpy(alpha)

    want = np.asarray(jax_ops.bitlinear(jx, jnp.asarray(w), jnp.asarray(alpha), interpret=True))
    np.testing.assert_array_equal(bitlinear.bitlinear_plain(xt, wt.bfloat16(), at).numpy(), want)
    np.testing.assert_array_equal(ref.bitlinear_ref(xt, wt, at).numpy(), want)

    # the JAX kernel itself, with beta passed in (its op takes mean|x|,
    # NaN on these rows), on x padded with -1.0 to whole words as its op does
    wp = ops.pack_weights(wt)
    kw = wp.shape[0]
    want = np.asarray(jax_fused.fused_bnn_matmul_kernel(
        jnp.asarray(np.pad(x, ((0, 0), (0, kw * 32 - m)), constant_values=-1.0)),
        jnp.asarray(wp.numpy()), jnp.asarray(alpha[None]), jnp.asarray(beta[:, None]),
        m=m, bm=x.shape[0], bn=n, bkw=kw, interpret=True))
    got = fused_decode.fused_bnn_matmul_plain(xt, wp, at, torch.from_numpy(beta), m=m, n=n)
    np.testing.assert_array_equal(got.numpy(), want)


def _header_const(name: str) -> int:
    src = (_build.SRC_DIR / "sm90_mma.cuh").read_text()
    return int(re.search(rf"{name} = \(mag \+ 0x([0-9A-F]+)u\)", src).group(1), 16)


def test_sign_bf16x2_emulated_over_every_bf16_pattern():
    """``sign_bf16x2`` of csrc/sm90_mma.cuh (the bitlinear and WDM MMM
    kernels' in-place binarize of bf16 x), emulated in integer ops with
    the header's own constants on all 65536 bf16 bit patterns in both
    halves, gives +1 exactly where ``bnn.nonneg`` does."""
    nan_add, normal_add = _header_const("nan"), _header_const("normal")
    assert normal_add == 0x7F807F80 and nan_add == 0x007F007F
    lo = np.arange(1 << 16, dtype=np.uint32)
    b = lo | (lo[::-1] << 16)  # the high half walks the patterns backwards
    mag = b & 0x7FFF7FFF
    nan = (mag + nan_add) & 0x80008000
    normal = (mag + normal_add) & 0x80008000
    out = 0x3F803F80 | nan | (b & normal)
    for half, shift in (("low", 0), ("high", 16)):
        bits = ((b >> shift) & 0xFFFF).astype(np.uint16).view(np.int16)
        x = torch.from_numpy(bits.copy()).view(torch.bfloat16)
        sign = ((out >> shift) & 0xFFFF).astype(np.uint16).view(np.int16)
        got = torch.from_numpy(sign.copy()).view(torch.bfloat16).float()
        want = torch.where(bnn.nonneg(x), 1.0, -1.0)
        assert torch.equal(got, want), half


def test_every_cuda_binarize_site_uses_the_threshold():
    """No CUDA source binarizes by ``>= 0`` any more: the fused, Hamming
    (through its packed activations), bitlinear and WDM kernels compare
    with -2^-126, and the bf16 pairs with ``__hgt2_mask``."""
    code = {  # the sources without their comments
        p.name: "\n".join(line.split("//")[0] for line in p.read_text().splitlines())
        for p in _build.SRC_DIR.glob("*.cu*")
    }
    for name, src in code.items():
        assert ">= 0.f" not in src and ">= 0.0f" not in src, name
        assert "__hge2_mask" not in src, name
    for name in ("sm90_b1.cuh", "sm90_mma.cuh"):
        assert "constexpr float kNegMinNormal = -0x1p-126f;" in code[name]
    assert code["sm90_b1.cuh"].count("__hgt2_mask(") == 4
    assert code["fused_decode.cu"].count("> b1::kNegMinNormal") == 2
    assert bnn.NEG_MIN_NORMAL == -(2.0**-126) == float(np.finfo(np.float32).tiny) * -1

"""Multi-level PCM cells (``repro_torch.core.multilevel``) against the
JAX package's ``repro.core.multilevel``: quantization, the exact MAC,
the noisy readout fed the reference's own ``jax.random.normal`` draw
(bit for bit), the error rates of the whole default sweep on the
reference's draws (sigma = 0 included), and the sweep's gates on the
port's own draws.

The port draws from ``torch.Generator``, so its own sweep sees other
levels and noise than ``jax.random``'s; the readout of a given draw is
separate from the draw (``_readout`` / ``_error_rate``), which is what
lets a test feed it the reference's and compare exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multilevel as jml
from repro_torch.core import multilevel as ml
from repro_torch.core.crossbar import OPCM_TILE

torch.set_num_threads(1)

SIGMAS = (0.0, 0.01, 0.02, 0.05, 0.1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_quantize_dequantize_equal_the_reference(bits):
    w = np.concatenate([np.linspace(-1.2, 1.2, 241), [-5.0, 5.0, 0.0]]).astype(np.float32)
    q = ml.quantize_weights(torch.from_numpy(w), bits)
    jq = jml.quantize_weights(jnp.asarray(w), bits)
    assert q.dtype == torch.int32 and np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(ml.dequantize(q, bits).numpy(), np.asarray(jml.dequantize(jq, bits)))


def _draws(bits: int, seed: int = 0, m: int = 64, n: int = 32, batch: int = 64):
    """The reference's level_error_rate draws, reproduced key for key."""
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    levels = 2**bits - 1
    a = jax.random.randint(k1, (batch, m), 0, levels + 1)
    w = jax.random.randint(k2, (m, n), 0, levels + 1)
    return a, w, k3, jax.random.normal(k3, (batch, m, n))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_exact_mac_equals_the_reference(bits):
    a, w, _, _ = _draws(bits, seed=3, m=33, n=17, batch=9)
    got = ml.multilevel_vmm_exact(_t(a), _t(w))
    assert np.array_equal(got.numpy(), np.asarray(jml.multilevel_vmm_exact(a, w)))


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_noisy_readout_of_the_reference_draw_is_bit_exact(bits, sigma):
    a, w, key, z = _draws(bits)
    got = ml._readout(_t(a), _t(w), bits, sigma, _t(z), OPCM_TILE)
    want = np.asarray(jml.noisy_vmm(a, w, bits, sigma, key))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_sweep_on_the_reference_draws_equals_the_reference(bits):
    """Every (bits, sigma) point of the default sweep, sigma = 0
    included: the port's error rate on the reference's draws ==
    ``level_error_rate``'s, as a float, exactly."""
    a, w, _, z = _draws(bits)
    for sigma in SIGMAS:
        got = ml._error_rate(_t(a), _t(w), bits, sigma, _t(z), OPCM_TILE)
        assert got == jml.level_error_rate(bits, sigma)


def test_sigma_zero_is_the_adc_rounding_of_the_exact_mac():
    gen = torch.Generator().manual_seed(0)
    for bits in (1, 2, 4):
        levels = 2**bits - 1
        a = torch.randint(0, levels + 1, (8, 64), generator=gen)
        w = torch.randint(0, levels + 1, (64, 16), generator=gen)
        exact = ml.multilevel_vmm_exact(a, w)
        lsb = torch.tensor(max(64 * levels * levels / OPCM_TILE.adc_levels, 1.0))
        got = ml.noisy_vmm(a, w, bits, 0.0, gen)
        assert torch.equal(got, torch.round(exact / lsb) * lsb)
        if bits == 1:
            assert torch.equal(got, exact)


def test_noise_comes_from_the_generator():
    a = torch.randint(0, 4, (4, 16), generator=torch.Generator().manual_seed(1))
    w = torch.randint(0, 4, (16, 8), generator=torch.Generator().manual_seed(2))
    runs = [ml.noisy_vmm(a, w, 2, 0.1, torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_port_sweep_holds_the_reference_gates():
    """The gates of the JAX package's benchmarks/multilevel.py on the
    port's own draws, and the sweep's fields as the reference's."""
    points = ml.sweep(device="cpu")
    jpoints = jml.sweep(bit_depths=(1,), sigmas=(0.0,))
    assert [f.name for f in dataclasses.fields(points[0])] == [
        f.name for f in dataclasses.fields(jpoints[0])]
    by = {(p.bits, p.sigma): p for p in points}
    assert len(by) == 15 and all(p.density_x == p.latency_x == p.bits for p in points)
    assert all(by[(1, s)].error_rate == 0.0 for s in SIGMAS if s <= 0.02)
    assert all(by[(4, s)].error_rate > 0.05 for s in SIGMAS if s >= 0.05)
    assert by[(1, 0.05)].error_rate <= by[(2, 0.05)].error_rate <= by[(4, 0.05)].error_rate
    assert ml.level_error_rate(1, 0.1, device="cpu", seed=3) == ml.level_error_rate(
        1, 0.1, device="cpu", seed=3)

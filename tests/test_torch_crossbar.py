"""The port's crossbar simulators against the JAX package's, on the same
numpy-seeded inputs: the bit-level helpers of ``core/bnn.py``, the tile
geometry and ADC of ``core/crossbar.py``, and ``tacitmap.apply``,
``wdm.mmm`` / ``wdm.wdm_apply`` and ``custbinarymap.apply`` --
``torch.equal`` to JAX (as numpy arrays), with a lossy ADC at
``adc_bits`` 4-8 too. The readout noise is held to its statistics only:
``jax.random``'s stream cannot be matched.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnn as jbnn
from repro.core import crossbar as jcrossbar
from repro.core import custbinarymap as jcbm
from repro.core import tacitmap as jtacitmap
from repro.core import wdm as jwdm
from repro_torch.core import bnn, crossbar, custbinarymap, tacitmap, wdm

torch.set_num_threads(1)

# (m, n): m not a multiple of 128, n not a multiple of 256, several row
# tiles (2m > 256) and several column tiles (n > 256)
SHAPES = [(1, 3), (33, 17), (200, 300), (300, 513), (384, 256)]


def _bits(rng, shape):
    return rng.integers(0, 2, size=shape).astype(np.float32)


def _equal(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.shape == want.shape and got.dtype == want.dtype and np.array_equal(got, want)


def _spec_pair(tech: str, **kw):
    base = (jcrossbar.EPCM_TILE, crossbar.EPCM_TILE) if tech == "ePCM" else (
        jcrossbar.OPCM_TILE, crossbar.OPCM_TILE)
    return dataclasses.replace(base[0], **kw), dataclasses.replace(base[1], **kw)


HELPERS = ["xnor", "xnor_popcount", "binary_dot_eq1", "tacitmap_vmm"]


@pytest.mark.parametrize("name", HELPERS)
def test_bit_helpers_on_pairs_equal_jax(name):
    rng = np.random.default_rng(len(name))
    a, w = _bits(rng, (4, 37)), _bits(rng, (37, 9))
    if name == "tacitmap_vmm":
        args = (a, w)
    else:  # elementwise helpers take (…, m) operands of one shape
        args = (a, _bits(rng, (4, 37)))
    want = getattr(jbnn, name)(*(jnp.asarray(x) for x in args))
    got = getattr(bnn, name)(*(torch.from_numpy(x) for x in args))
    assert _equal(got, want)


@pytest.mark.parametrize("name", ["bits_to_signs", "popcount", "concat_complement_input",
                                  "stack_complement_weights"])
def test_bit_helpers_on_one_operand_equal_jax(name):
    x = _bits(np.random.default_rng(7), (6, 21))
    assert _equal(getattr(bnn, name)(torch.from_numpy(x)), getattr(jbnn, name)(jnp.asarray(x)))


def test_tacitmap_binary_matmul_equals_jax_and_the_signs_product():
    rng = np.random.default_rng(3)
    a = rng.choice(np.array([-1.0, 1.0], np.float32), size=(5, 70))
    w = rng.choice(np.array([-1.0, 1.0], np.float32), size=(70, 12))
    got = bnn.tacitmap_binary_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert _equal(got, jbnn.tacitmap_binary_matmul(jnp.asarray(a), jnp.asarray(w)))
    assert np.array_equal(got.numpy(), a @ w)


@pytest.mark.parametrize("tech", ["ePCM", "oPCM"])
@pytest.mark.parametrize("rows,cols", [(1, 1), (512, 256), (513, 257), (4096, 5632)])
def test_tile_grid_and_spec_counters_equal_jax(rows, cols, tech):
    jspec, spec = _spec_pair(tech)
    jg, g = jcrossbar.TileGrid(rows, cols, jspec), crossbar.TileGrid(rows, cols, spec)
    for attr in ("row_tiles", "col_tiles", "n_tiles", "n_devices"):
        assert getattr(g, attr) == getattr(jg, attr)
    assert spec.adc_levels == jspec.adc_levels
    for args in ((256, 256), (100, 7, 16), (1, 1)):
        assert spec.vmm_energy_pj(*args) == jspec.vmm_energy_pj(*args)


@pytest.mark.parametrize("adc_bits", [4, 5, 6, 7, 8, 9])
def test_adc_quantize_equals_jax_on_every_popcount_and_between(adc_bits):
    """Every integer popcount 0..256 -- the exact ties of round-half-even
    among them -- and seeded values between, through ADCs from lossy (4
    bits) to lossless (9)."""
    pc = np.concatenate([np.arange(257, dtype=np.float32),
                         np.random.default_rng(adc_bits).uniform(0, 256, 500).astype(np.float32)])
    jspec, spec = _spec_pair("ePCM", adc_bits=adc_bits)
    got = crossbar.adc_quantize(torch.from_numpy(pc), spec, active_rows=256)
    assert _equal(got, jcrossbar.adc_quantize(jnp.asarray(pc), jspec, 256))
    if adc_bits == 9:
        assert np.array_equal(got.numpy(), pc)


def test_readout_noise_statistics():
    """Identity without a generator or at sigma 0; otherwise mean 0 and
    std sigma within 5% (200k draws: the std's standard error is 0.16%),
    from a generator that reproduces its draws."""
    pc = torch.zeros(200_000)
    assert crossbar.readout_noise(pc, 0.5, None) is pc
    assert crossbar.readout_noise(pc, 0.0, torch.Generator().manual_seed(0)) is pc
    sigma = 0.5
    noisy = crossbar.readout_noise(pc, sigma, torch.Generator().manual_seed(0))
    assert abs(noisy.mean().item()) < 0.01
    assert abs(noisy.std().item() / sigma - 1) < 0.05
    again = crossbar.readout_noise(pc, sigma, torch.Generator().manual_seed(0))
    assert torch.equal(noisy, again)


@pytest.mark.parametrize("m,n", SHAPES)
def test_tacitmap_apply_equals_jax(m, n):
    rng = np.random.default_rng(m + n)
    w, a = _bits(rng, (m, n)), _bits(rng, (2, 3, m))
    jl = jtacitmap.map_weights(jnp.asarray(w, jnp.int32))
    tl = tacitmap.map_weights(torch.from_numpy(w).to(torch.int32))
    assert _equal(tl.tiles, jl.tiles)
    assert (tl.grid.row_tiles, tl.grid.col_tiles) == (jl.grid.row_tiles, jl.grid.col_tiles)
    got = tacitmap.apply(tl, torch.from_numpy(a))
    assert _equal(got, jtacitmap.apply(jl, jnp.asarray(a)))
    assert np.array_equal(got.numpy(), np.asarray(jbnn.tacitmap_vmm(jnp.asarray(a), jnp.asarray(w))))
    with pytest.raises(ValueError, match="input length"):
        tacitmap.apply(tl, torch.zeros((1, m + 1)))


@pytest.mark.parametrize("tech", ["ePCM", "oPCM"])
@pytest.mark.parametrize("adc_bits", [4, 5, 6, 7, 8])
def test_tacitmap_apply_through_a_lossy_adc_equals_jax(adc_bits, tech):
    rng = np.random.default_rng(adc_bits)
    m, n = 300, 270
    w, a = _bits(rng, (m, n)), _bits(rng, (7, m))
    jspec, spec = _spec_pair(tech, adc_bits=adc_bits)
    want = jtacitmap.apply(jtacitmap.map_weights(jnp.asarray(w), jspec), jnp.asarray(a))
    got = tacitmap.apply(tacitmap.map_weights(torch.from_numpy(w), spec), torch.from_numpy(a))
    assert _equal(got, want)
    # lossy: the quantized popcount is not the exact one
    assert not np.array_equal(got.numpy(), a @ w + (1 - a) @ (1 - w))


@pytest.mark.parametrize("m,n", [(33, 17), (300, 513)])
def test_tacitmap_binary_matmul_and_steps_equal_jax(m, n):
    rng = np.random.default_rng(m)
    a = rng.choice(np.array([-1.0, 1.0], np.float32), size=(4, m))
    w = rng.choice(np.array([-1.0, 1.0], np.float32), size=(m, n))
    got = tacitmap.binary_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert _equal(got, jtacitmap.binary_matmul(jnp.asarray(a), jnp.asarray(w)))
    assert tacitmap.steps_for(m, n, 9) == jtacitmap.steps_for(m, n, 9)


@pytest.mark.parametrize("b,k", [(1, 16), (5, 4), (16, 16), (17, 16), (9, 8)])
def test_wdm_group_apply_and_mmm_equal_jax(b, k):
    """Ragged tails pad with zero vectors (idle comb lines) whose outputs
    are dropped."""
    rng = np.random.default_rng(b * 31 + k)
    m, n = 130, 300
    w, a = _bits(rng, (m, n)), _bits(rng, (b, m))
    jspec, spec = _spec_pair("oPCM", wdm_k=k)
    jl = jtacitmap.map_weights(jnp.asarray(w), jspec)
    tl = tacitmap.map_weights(torch.from_numpy(w), spec)
    jgroups, jb = jwdm.group_inputs(jnp.asarray(a), k)
    groups, tb = wdm.group_inputs(torch.from_numpy(a), k)
    assert tb == jb and _equal(groups, jgroups)
    assert _equal(wdm.mmm(tl, groups), jwdm.mmm(jl, jgroups))
    assert _equal(wdm.wdm_apply(tl, torch.from_numpy(a)), jwdm.wdm_apply(jl, jnp.asarray(a)))
    assert _equal(wdm.wdm_apply(tl, torch.from_numpy(a), 3), jwdm.wdm_apply(jl, jnp.asarray(a), 3))
    assert wdm.steps_for(b, k) == jwdm.steps_for(b, k)
    assert wdm.effective_speedup(b, k) == jwdm.effective_speedup(b, k)


@pytest.mark.parametrize("m,n", SHAPES)
def test_custbinarymap_apply_equals_jax(m, n):
    """One fp32 product over the pair axis and m together gives the
    reference's (…, n, m) XNOR bits summed over m."""
    rng = np.random.default_rng(m * 3 + n)
    w, a = _bits(rng, (m, n)), _bits(rng, (2, 3, m))
    jl = jcbm.map_weights(jnp.asarray(w, jnp.int32))
    tl = custbinarymap.map_weights(torch.from_numpy(w).to(torch.int32))
    assert _equal(tl.rows, jl.rows)
    assert (tl.grid.rows, tl.grid.cols, tl.grid.n_tiles) == (jl.grid.rows, jl.grid.cols,
                                                             jl.grid.n_tiles)
    assert _equal(custbinarymap.apply(tl, torch.from_numpy(a)), jcbm.apply(jl, jnp.asarray(a)))
    assert _equal(custbinarymap.interleave_complement(torch.from_numpy(a)),
                  jcbm.interleave_complement(jnp.asarray(a)))
    sa = 2 * a[0] - 1
    sw = 2 * w - 1
    got = custbinarymap.binary_matmul(torch.from_numpy(sa), torch.from_numpy(sw))
    assert _equal(got, jcbm.binary_matmul(jnp.asarray(sa), jnp.asarray(sw)))
    assert custbinarymap.steps_for(m, n, 5) == jcbm.steps_for(m, n, 5)
    with pytest.raises(ValueError, match="input length"):
        custbinarymap.apply(tl, torch.zeros((1, m + 1)))

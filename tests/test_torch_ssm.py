"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``, on the reference's parameters
(``mamba_init``) and numpy-seeded inputs, run op by op
(``jax.disable_jit``).

Tolerances: ``ssd_chunked`` / ``ssd_step`` in fp32 within 1e-5 of the
largest magnitude (their einsums and the chunk cumsum sum in another
order than XLA's); the conv taps are summed tap by tap as the reference
does and agree exactly; ``mamba_block`` / ``mamba_step`` outputs within
two bf16 ulps of their largest magnitude (the bf16 projections and the
SSD sums round in another order); the decode cache's conv tails equal
exactly and the state within 1e-5 of its largest magnitude. Prompts of 1
and 2 tokens fall below the conv tail (K - 1 = 3), as the serving path
meets them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import ssm as jax_ssm
import torch_resident
from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.convert import mamba_from_jax
from repro_torch.models import ssm
from repro_torch.models.layers import CAST_COUNTER

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

ARCH = "mamba2-2.7b"


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(got: torch.Tensor, want, rel: float):
    w = _np(want)
    g = got.to(torch.float32).numpy()
    assert g.shape == w.shape
    err = np.abs(g - w).max()
    assert err <= rel * np.abs(w).max(), f"max |diff| {err} vs {rel} x {np.abs(w).max()}"


def _bf16_close(got: torch.Tensor, want, n_ulp: int = 2):
    w = _np(want)
    ulp = np.exp2(np.floor(np.log2(np.abs(w).max())) - 7)
    err = np.abs(got.to(torch.float32).numpy() - w).max()
    assert err <= n_ulp * ulp, f"max |diff| {err} beyond {n_ulp} bf16 ulps ({ulp})"


def _ssd_inputs(s, h=8, p=16, g=2, n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(2, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)
    b = rng.normal(size=(2, s, g, n)).astype(np.float32)
    c = rng.normal(size=(2, s, g, n)).astype(np.float32)
    return x, dt, a, b, c


@pytest.mark.parametrize("s,chunk,g", [(40, 16, 1), (40, 16, 2), (37, 256, 2), (1, 16, 1)])
def test_ssd_chunked(s, chunk, g):
    ins = _ssd_inputs(s, g=g)
    with jax.disable_jit():
        jy, jfinal = jax_ssm.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    y, final = ssm.ssd_chunked(*map(torch.from_numpy, ins), chunk=chunk)
    _close(y, jy, 1e-5)
    _close(final, jfinal, 1e-5)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_step(g):
    x, dt, a, b, c = _ssd_inputs(1, g=g, seed=1)
    state = np.random.default_rng(2).normal(size=(2, 8, 16, 16)).astype(np.float32)
    args = (state, x[:, 0], dt[:, 0], a, b[:, 0], c[:, 0])
    with jax.disable_jit():
        jstate, jy = jax_ssm.ssd_step(*map(jnp.asarray, args))
    new_state, y = ssm.ssd_step(*map(torch.from_numpy, args))
    _close(new_state, jstate, 1e-5)
    _close(y, jy, 1e-5)


def test_causal_conv_and_conv_step():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 9, 24)), jnp.bfloat16)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    with jax.disable_jit():
        jy = jax_ssm.causal_conv1d(x, jnp.asarray(w), jnp.asarray(b))
        jst, jyt = jax_ssm.conv_step(x[:, :3], x[:, 3], jnp.asarray(w), jnp.asarray(b))
    xt = torch.from_numpy(_np(x)).to(torch.bfloat16)
    y = ssm.causal_conv1d(xt, torch.from_numpy(w), torch.from_numpy(b))
    st, yt = ssm.conv_step(xt[:, :3], xt[:, 3], torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(y.float().numpy(), _np(jy))
    np.testing.assert_array_equal(st.float().numpy(), _np(jst))
    _bf16_close(yt, jyt, 1)


def _mixer(seed=0):
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    p = jax_ssm.mamba_init(jax.random.key(seed), jcfg)
    return jcfg, cfg, p, mamba_from_jax(jax.tree.map(np.asarray, p), device="cpu")


@pytest.mark.parametrize("s", [1, 2, 7, 40])
def test_mamba_block_and_cache(s):
    jcfg, cfg, p, m = _mixer()
    u = np.random.default_rng(s).normal(size=(2, s, cfg.d_model)).astype(np.float32)
    ub = jnp.asarray(u, jnp.bfloat16)
    with jax.disable_jit():
        jout, jcache = jax_ssm.mamba_block(p, ub, jcfg)
    out, cache = ssm.mamba_block(m, torch.from_numpy(_np(ub)).to(torch.bfloat16), cfg)
    assert out.dtype == torch.bfloat16
    _bf16_close(out, jout)
    assert set(cache) == set(jcache) == {"conv_x", "conv_b", "conv_c", "ssm"}
    for key in ("conv_x", "conv_b", "conv_c"):
        assert cache[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(cache[key].float().numpy(), _np(jcache[key]))
    _close(cache["ssm"], jcache["ssm"], 1e-5)


def test_mamba_step_updates_the_cache_in_place():
    jcfg, cfg, p, m = _mixer(1)
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.normal(size=(3, 6, cfg.d_model)), jnp.bfloat16)
    with jax.disable_jit():
        _, jcache = jax_ssm.mamba_block(p, u[:, :5], jcfg)
        jout, jnew = jax_ssm.mamba_step(p, u[:, 5:], jcache, jcfg)
    ut = torch.from_numpy(_np(u)).to(torch.bfloat16)
    _, cache = ssm.mamba_block(m, ut[:, :5], cfg)
    pool = {key: t.clone() for key, t in cache.items()}
    tensors = dict(pool)
    out, new = ssm.mamba_step(m, ut[:, 5:], pool, cfg)
    assert new is pool and all(pool[key] is t for key, t in tensors.items())
    _bf16_close(out, jout)
    for key in ("conv_x", "conv_b", "conv_c"):
        np.testing.assert_array_equal(pool[key].float().numpy(), _np(jnew[key]))
    _close(pool["ssm"], jnew["ssm"], 1e-5)


def test_decode_lanes_do_not_depend_on_the_lane_count():
    _, cfg, _, m = _mixer(2)
    rng = np.random.default_rng(6)
    u = torch.from_numpy(rng.normal(size=(8, 4, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    _, cache = ssm.mamba_block(m, u[:, :3], cfg)
    full = {key: t.clone() for key, t in cache.items()}
    out_full, _ = ssm.mamba_step(m, u[:, 3:], full, cfg)
    for n in (1, 3):
        part = {key: t[:n].clone() for key, t in cache.items()}
        out, _ = ssm.mamba_step(m, u[:n, 3:], part, cfg)
        assert torch.equal(out, out_full[:n])
        for key in part:
            assert torch.equal(part[key], full[key][:n])


# ---------------------------------------------------------------------------
# Resident bf16 projections (lm.program_weights) == the per-call cast
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graph"])
def test_resident_projections_give_the_per_call_casts_bits(graphed):
    """mamba2's prefill and decode_step, eager or replayed, on the
    programmed model == on the same model casting per call, bit for bit."""
    torch_resident.assert_resident_equals_cast(ARCH, graphed)


def test_programming_leaves_the_input_mixers_and_the_fp32_leaves_as_they_were():
    torch_resident.assert_programming_leaves_the_input_as_it_was(ARCH)


@pytest.mark.parametrize("programmed", [False, True])
def test_a_mixer_with_grad_casts_from_its_live_latents(programmed):
    """Projections that require grad are cast per call, resident copies
    or not: a changed projection moves the output, and the gradient
    reaches it."""
    _, cfg, _, m = _mixer(3)
    if programmed:
        m = ssm.Mamba(resident=True, **{n: getattr(m, n) for n in m.PROJECTIONS + m.VECTORS})
        assert m.out_proj_resident is not None
    m.requires_grad_(True)
    u = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 5, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    with obs.session() as tel:
        y0, _ = ssm.mamba_block(m, u, cfg)
    c = tel.metrics.counter(CAST_COUNTER)
    assert {dict(k)["outcome"] for k in c._series} == {"cast"}
    y0.float().sum().backward()
    assert m.out_proj.grad is not None and m.out_proj.grad.abs().sum() > 0
    with torch.no_grad():
        m.out_proj.mul_(-1.0)
        y1, _ = ssm.mamba_block(m, u, cfg)
    assert torch.equal(y1, -y0.detach())

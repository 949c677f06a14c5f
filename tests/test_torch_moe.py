"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the reference's parameters
(``moe_init``) and numpy-seeded activations, run op by op
(``jax.disable_jit``).

Tolerances: the routing (``top_idx``, ``slot``, ``keep``) is equal
exactly; the renormalized gates agree within 1e-6; ``y`` within one
bf16 ulp of each row's largest magnitude (the combine sums the k bf16
products in fp32 in another order than XLA's); the aux loss within 1e-6
relative. Cases: random tokens, forced top-k ties (a duplicated router
column, so two experts tie on every token: the lower index must come
first, as ``jax.lax.top_k`` puts it), identical tokens (every token to
the same experts, past the capacity: drops), a small capacity factor
(drops everywhere) and a decode-shaped call (S = 1, capacity 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jax_moe
import torch_resident
from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.convert import moe_from_jax
from repro_torch.models import moe
from repro_torch.models.layers import CAST_COUNTER

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

ARCHS = ("qwen3-moe-235b-a22b", "grok-1-314b")
CASES = ("random", "ties", "identical", "overflow", "decode")


def _case(arch, case):
    """(jax cfg, port cfg, jax params, x (B, S, d) float32 numpy)."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    if case == "overflow":
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.5)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=0.5)
    p = jax_moe.moe_init(jax.random.key(3), jcfg)
    rng = np.random.default_rng(3)
    shape = (3, 1, cfg.d_model) if case == "decode" else (2, 24, cfg.d_model)
    x = rng.normal(size=shape).astype(np.float32)
    if case == "ties":
        p = dict(p, router=p["router"].at[:, 1].set(p["router"][:, 0]))
    if case == "identical":
        x[:] = x[:, :1]
    return jcfg, cfg, p, x


def _jax_routing(p, x, cfg):
    """The reference's routing, moe.py:70-83, op for op."""
    b, s, _ = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    c = jax_moe.capacity(cfg, s)
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gates, top_idx = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    flat_e = top_idx.reshape(b, s * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.float32)
    pos = jnp.cumsum(onehot, axis=1) - 1.0
    slot = jnp.sum(pos * onehot, axis=-1).astype(jnp.int32)
    return gates, top_idx, slot, slot < c


def _bf16_ulp(v):
    return np.exp2(np.floor(np.log2(np.maximum(v, 2.0**-126))) - 7)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, case):
    jcfg, cfg, p, x = _case(arch, case)
    xb = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        jgates, jtop, jslot, jkeep = _jax_routing(p, xb, jcfg)
        jy, jaux = jax_moe.moe_ffn(p, xb, jcfg)
    m = moe_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    _, gates, top = moe.route(m, xt, cfg)
    _, slot, keep, _ = moe.slots(top, cfg.moe_experts, moe.capacity(cfg, x.shape[1]))
    y, aux = moe.moe_ffn(m, xt, cfg)

    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=0, atol=1e-6)
    want = np.asarray(jy.astype(jnp.float32))
    got = y.to(torch.float32).numpy()
    assert y.dtype == torch.bfloat16 and got.shape == want.shape
    ulp = _bf16_ulp(np.abs(want).max(axis=-1, keepdims=True))
    assert (np.abs(got - want) <= ulp).all()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if case in ("identical", "overflow"):
        assert not keep.all()  # assignments past the capacity were dropped


def test_ties_take_the_lower_expert_first():
    """Two tied experts: whichever rank they reach, 0 comes before 1."""
    jcfg, cfg, p, x = _case("qwen3-moe-235b-a22b", "ties")
    m = moe_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    probs, _, top = moe.route(m, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert torch.equal(probs[..., 0], probs[..., 1])
    pos0 = (top == 0).float().argmax(-1)
    pos1 = (top == 1).float().argmax(-1)
    both = (top == 0).any(-1) & (top == 1).any(-1)
    assert both.any() and (pos0[both] < pos1[both]).all()


def test_dropped_assignments_contribute_zero():
    """With a capacity of 2 per expert over 24 identical tokens (each
    routed to the same experts), only the first two tokens' assignments
    are kept: every later token's output is exactly zero."""
    jcfg, cfg, p, x = _case("grok-1-314b", "identical")
    cfg = dataclasses.replace(cfg, moe_capacity_factor=0.1)
    assert moe.capacity(cfg, x.shape[1]) == 2
    m = moe_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    y, _ = moe.moe_ffn(m, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert y[:, :2].abs().amax() > 0
    assert torch.equal(y[:, 2:], torch.zeros_like(y[:, 2:]))


def test_rows_do_not_depend_on_the_row_count():
    """A decode tick's rows, computed 1, 3 or 8 at a time, have the same
    bits (the router and the expert products run in fixed-size blocks)."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    p = jax_moe.moe_init(jax.random.key(4), jax_smoke_config("qwen3-moe-235b-a22b"))
    m = moe_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(8, 1, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    full, _ = moe.moe_ffn(m, x, cfg)
    for n in (1, 3):
        part, _ = moe.moe_ffn(m, x[:n], cfg)
        assert torch.equal(part, full[:n])


# ---------------------------------------------------------------------------
# Resident bf16 expert stacks (lm.program_weights) == the per-call cast
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "jamba-1.5-large-398b"])
def test_resident_expert_stacks_give_the_per_call_casts_bits(arch, graphed):
    """prefill, prefill_continue (attention-only stacks) and decode_step,
    eager or replayed, on the programmed model == on the same model
    casting per call, bit for bit."""
    torch_resident.assert_resident_equals_cast(arch, graphed)


def test_programming_leaves_the_input_model_and_the_fp32_leaves_as_they_were():
    torch_resident.assert_programming_leaves_the_input_as_it_was("qwen3-moe-235b-a22b")


@pytest.mark.parametrize("programmed", [False, True])
def test_a_model_with_grad_casts_from_its_live_latents(programmed):
    """Leaves that require grad are cast per call, resident copies or
    not, and the output follows a change of a latent (and the gradient
    reaches it)."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    p = jax_moe.moe_init(jax.random.key(5), jax_smoke_config("qwen3-moe-235b-a22b"))
    m = moe_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    if programmed:
        m = moe.MoE(*(getattr(m, n) for n in moe.MoE.LEAVES), resident=True)
        assert m.w1_resident is not None
    m.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 4, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    with obs.session() as tel:
        y0, _ = moe.moe_ffn(m, x, cfg)
    c = tel.metrics.counter(CAST_COUNTER)
    assert {dict(k)["outcome"] for k in c._series} == {"cast"}
    y0.float().sum().backward()
    assert m.w1.grad is not None and m.w1.grad.abs().sum() > 0
    with torch.no_grad():
        m.w1.mul_(-1.0)
        m.w2.mul_(2.0)
        y1, _ = moe.moe_ffn(m, x, cfg)
    assert not torch.equal(y0.detach(), y1)

"""The port's AdamW and schedule against the JAX package's, and the
reference's own optimizer invariants (tests/test_optim.py) on the port.

One ``adamw_update`` on the smoke models' stacked trees equals the
reference's on every leaf (params, ``m``, ``v`` or its factored
``vr``/``vc``, ``step``) within 1e-6 relative (2e-7 absolute for values
near zero): the arithmetic is elementwise fp32 in the reference's order,
and only the global norm's summation order and the ``pow`` / ``sqrt``
of two libraries may differ by an ulp. The schedule is computed in the
reference's fp32 order: the warmup is equal bit for bit, and the decay
within 5e-7 relative at every step (the two libraries' fp32 ``cos`` can
round an ulp apart, which ``1 + cos`` amplifies near the end of the
decay: 2-3 ulps of the result seen).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro_torch.convert import tree_from_jax, tree_to_jax
from repro_torch.optim import OptConfig, adamw_init, adamw_update, cosine_schedule, global_norm

torch.set_num_threads(1)


def _smoke_tree(arch):
    cfg = jax_smoke_config(arch)
    init = jax_encdec.init_params if cfg.is_encdec else jax_lm.init_params
    return jax.tree.map(np.asarray, init(jax.random.key(0), cfg))


def _grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)


def _both_updates(tree, grads, cfg_kw, steps=2, lr=1e-3):
    """``steps`` updates through each package from the same tree."""
    jcfg, cfg = JaxOptConfig(**cfg_kw), OptConfig(**cfg_kw)
    jp, jstate = jax.tree.map(jnp.asarray, tree), None
    jstate = jax_adamw_init(jp, jcfg)
    p = tree_from_jax(tree, device="cpu")
    state = adamw_init(p, cfg)
    for i in range(steps):
        g = jax.tree.map(lambda x: x * (i + 1), grads)
        jp, jstate = jax_adamw_update(jax.tree.map(jnp.asarray, g), jp, jstate, lr, jcfg)
        adamw_update(tree_from_jax(g, device="cpu"), p, state, lr, cfg)
    return (jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jstate),
            tree_to_jax(p), tree_to_jax(state))


def _assert_trees_close(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(got)):
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=2e-7, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("factored", [False, True], ids=["dense", "factored"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-0.5b", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b", "seamless-m4t-large-v2"])
def test_adamw_update_equals_the_reference_on_the_stacked_tree(arch, factored):
    """Two steps on the smoke tree with gradients whose global norm is
    far above ``clip_norm`` (clipping active), weight decay on: the dense
    stacks, the (L, E, d, f) expert stacks and Mamba leaves of the MoE
    and hybrid trees, and the enc-dec ``enc_blocks`` / ``dec_blocks``."""
    tree = _smoke_tree(arch)
    grads = _grads_like(tree, 1)
    assert float(global_norm(tree_from_jax(grads, device="cpu"))) > 100 * OptConfig().clip_norm
    jp, jstate, p, state = _both_updates(tree, grads, {"factored": factored})
    _assert_trees_close(p, jp)
    _assert_trees_close(state, jstate)
    assert int(state["step"]) == 2


def test_stacked_leaf_rules_match_the_reference():
    """The reference's rules read the stacked (L, ...) leaf: block norms
    (L, d) and qkv biases (L, n) are decayed, the (d,) final norm is not;
    the FFN's (2, 64, 128) w1 is factored (16384 elements stacked, 8192
    per block) and its statistics run over the trailing two dims."""
    tree = _smoke_tree("qwen1.5-0.5b")
    zeros = jax.tree.map(np.zeros_like, tree)
    jp, jstate, p, state = _both_updates(tree, zeros, {"weight_decay": 0.5, "factored": True},
                                         steps=1, lr=0.1)
    slot = p["blocks"]["slot0"]
    assert (slot["norm1"] < tree["blocks"]["slot0"]["norm1"]).all()
    assert (slot["norm2"] < tree["blocks"]["slot0"]["norm2"]).all()
    assert np.array_equal(p["final_norm"], tree["final_norm"])
    for name in ("q", "k", "v"):  # zero-initialized biases stay zero under decay alone
        assert slot["attn"][name]["b"].shape == (2, 64)
    _assert_trees_close(p, jp)
    w1_v = state["v"]["blocks"]["slot0"]["ffn"]["w1"]["w"]
    assert set(w1_v) == {"vr", "vc"} and w1_v["vr"].shape == (2, 64) and w1_v["vc"].shape == (2, 128)
    assert set(jstate["v"]["blocks"]["slot0"]["ffn"]["w1"]["w"]) == {"vr", "vc"}
    assert 64 * 128 < OptConfig().factored_min_size <= 2 * 64 * 128
    # decay of a nonzero (L, n) bias, as the reference decays it
    tree["blocks"]["slot0"]["attn"]["q"]["b"] = np.ones((2, 64), np.float32)
    jp, _, p, _ = _both_updates(tree, zeros, {"weight_decay": 0.5}, steps=1, lr=0.1)
    assert (p["blocks"]["slot0"]["attn"]["q"]["b"] < 1).all()
    _assert_trees_close(p, jp)


@pytest.mark.parametrize("kw", [{"peak_lr": 3e-4, "warmup_steps": 2, "total_steps": 12},
                                {"peak_lr": 1.0, "warmup_steps": 10, "total_steps": 100}],
                         ids=["chip_smoke", "long"])
def test_cosine_schedule_equals_the_reference_at_every_step(kw):
    got = np.stack([cosine_schedule(s, **kw).numpy() for s in range(kw["total_steps"] + 1)])
    want = np.stack([np.asarray(jax_cosine_schedule(s, **kw))
                     for s in range(kw["total_steps"] + 1)])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)
    # the warmup steps are exact
    np.testing.assert_array_equal(got[: kw["warmup_steps"] + 1], want[: kw["warmup_steps"] + 1])


# -- the reference's tests/test_optim.py invariants, on the port -------------


def _quadratic_losses(cfg: OptConfig, steps=200, lr=0.05):
    target = torch.tensor([[1.0, -2.0], [3.0, 0.5]])
    params = {"w": torch.zeros((2, 2), requires_grad=True)}
    state = adamw_init(params, cfg)
    losses = []
    for _ in range(steps):
        loss = torch.sum((params["w"] - target) ** 2)
        (g,) = torch.autograd.grad(loss, [params["w"]])
        adamw_update({"w": g}, params, state, lr, cfg)
        losses.append(float(loss.detach()))
    return losses


def test_adamw_converges():
    losses = _quadratic_losses(OptConfig(weight_decay=0.0))
    assert losses[-1] < 1e-3 * losses[0]


def test_factored_adamw_converges():
    losses = _quadratic_losses(OptConfig(weight_decay=0.0, factored=True, factored_min_size=1))
    assert losses[-1] < 1e-2 * losses[0]


def test_factored_state_is_smaller():
    params = {"w": torch.zeros((64, 128))}
    dense = adamw_init(params, OptConfig())
    fact = adamw_init(params, OptConfig(factored=True, factored_min_size=1))
    n_dense = sum(t.size for t in jax.tree.leaves(tree_to_jax(dense["v"])))
    n_fact = sum(t.size for t in jax.tree.leaves(tree_to_jax(fact["v"])))
    assert n_fact == 64 + 128 and n_dense == 64 * 128


def test_grad_clipping_applies():
    cfg = OptConfig(clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros((4,))}
    state = adamw_init(params, cfg)
    adamw_update({"w": torch.full((4,), 1e6)}, params, state, 1.0, cfg)
    # clipped: the first-step Adam update magnitude is ~lr whatever the grad
    assert float(params["w"].abs().max()) < 2.0


def test_no_decay_on_1d_params():
    cfg = OptConfig(weight_decay=0.5)
    params = {"scale": torch.ones((8,)), "w": torch.ones((8, 8))}
    state = adamw_init(params, cfg)
    adamw_update({k: torch.zeros_like(v) for k, v in params.items()}, params, state, 0.1, cfg)
    assert torch.allclose(params["scale"], torch.ones(8))  # norms untouched
    assert float(params["w"][0, 0]) < 1.0                  # matrices decayed


def test_global_norm():
    t = {"a": torch.full((3,), 2.0), "b": torch.full((4,), 1.0)}
    assert np.isclose(float(global_norm(t)), np.sqrt(12 + 4))


def test_cosine_schedule_shape():
    lr0 = cosine_schedule(0, peak_lr=1.0, warmup_steps=10, total_steps=100)
    lr_peak = cosine_schedule(10, peak_lr=1.0, warmup_steps=10, total_steps=100)
    lr_end = cosine_schedule(100, peak_lr=1.0, warmup_steps=10, total_steps=100)
    assert float(lr0) == 0.0
    assert np.isclose(float(lr_peak), 1.0)
    assert np.isclose(float(lr_end), 0.1, atol=1e-6)
    mid = cosine_schedule(55, peak_lr=1.0, warmup_steps=10, total_steps=100)
    assert 0.1 < float(mid) < 1.0


def test_master_weights_keep_fp32_and_emit_the_param_dtype():
    """Sub-fp32 params get an fp32 master copy in the state (the
    reference's rule) and are written back in their own dtype."""
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    cfg = OptConfig(weight_decay=0.0)
    state = adamw_init(params, cfg)
    assert state["master"]["w"].dtype == torch.float32
    adamw_update({"w": torch.ones((4, 4), dtype=torch.bfloat16)}, params, state, 1e-3, cfg)
    assert params["w"].dtype == torch.bfloat16
    assert torch.equal(params["w"], state["master"]["w"].to(torch.bfloat16))
    assert float(state["master"]["w"][0, 0]) == pytest.approx(1 - 1e-3, rel=1e-6)
    assert dataclasses.replace(cfg, master_weights=False) != cfg

"""Gradients of the port's training forward against the JAX package's.

The straight-through estimator and RMSNorm's hand-written backward are
compared exactly; ``loss_fn``'s value and every gradient leaf are held
to ``jax.value_and_grad(repro.models.lm.loss_fn)`` run op by op
(``jax.disable_jit``: under ``jit`` XLA fuses the residual add into the
next RMSNorm, see tests/test_torch_generate.py), leaf by leaf through
``convert.grads_to_jax`` on the reference's stacked tree.

Tolerances. The loss agrees to 1e-6 relative: the forward is the
serving forward, equal bit for bit, but for the fp32 log-sum-exp's
summation order. A gradient leaf agrees to 2e-2 of its largest
magnitude: the backward rounds its bf16 cotangents after sums taken in
another order (XLA's reductions vs PyTorch's), a bf16 ulp is 2^-8 of a
value, and a bias's gradient is itself a bf16 sum over every position;
the quant="none" leaves agree to 1e-4 (fp32 GEMM order only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import bnn as jax_bnn
from repro.core import model as jax_model
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import grads_to_jax, params_dict, params_from_jax
from repro_torch.core import bnn
from repro_torch.core import model as port_model
from repro_torch.models import layers, lm

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

# the STE table: ties at ±1, signed zeros, signed subnormals, NaN
STE_VALUES = [-2.0, -1.0, -0.5, 0.0, -0.0, 2.0**-130, -(2.0**-130), 0.5, 1.0, 1.5, float("nan")]
STE_GRAD = [0.0, 0.5, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5, 0.0, 0.0]
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _jax_ste(fn, dtype):
    x = jnp.asarray(STE_VALUES, jnp.float32).astype(dtype)
    val = fn(x)
    grad = jax.grad(lambda v: jnp.sum(fn(v).astype(jnp.float32)))(x)
    return np.asarray(val.astype(jnp.float32)), np.asarray(grad.astype(jnp.float32))


def _port_ste(fn, dtype):
    x = torch.tensor(STE_VALUES, dtype=torch.float32).to(dtype).requires_grad_(True)
    val = fn(x)
    val.to(torch.float32).sum().backward()
    return val.detach().float().numpy(), x.grad.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["binarize_ste", "binarize_ste_bits"])
def test_ste_equals_the_reference(name, dtype):
    """Forward and gradient on the table, exactly: 1/2 at ±1 (XLA splits
    the clip's tie), 1 at signed zeros and subnormals, 0 past ±1 and for
    NaN. The forward of NaN is the port's binarize bit (-1, or 0 as a
    bit), where the reference's STE arithmetic gives NaN."""
    tdt, jdt = DTYPES[dtype]
    jv, jg = _jax_ste(getattr(jax_bnn, name), jdt)
    pv, pg = _port_ste(getattr(bnn, name), tdt)
    np.testing.assert_array_equal(pg, jg)
    np.testing.assert_array_equal(jg, np.asarray(STE_GRAD) * (0.5 if name.endswith("bits") else 1.0))
    np.testing.assert_array_equal(pv[:-1], jv[:-1])
    assert np.isnan(jv[-1]) and pv[-1] == (0.0 if name.endswith("bits") else -1.0)


def test_rms_norm_backward_equals_the_reference_vjp():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((3, 5, 64)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, s: jax_layers.rms_norm(a, s, 1e-5),
                       jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    y = layers.rms_norm(xt, st, 1e-5)
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    np.testing.assert_array_equal(y.detach().float().numpy(), np.asarray(out.astype(jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(jdx.astype(jnp.float32)))
    # d_scale sums 15 rows in another order
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jds), rtol=1e-6, atol=1e-7)
    # the backward keeps only the bf16 input and the scale
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        layers.rms_norm(xt, st, 1e-5)
    assert [(t.dtype, t.shape) for t in saved] == [(torch.bfloat16, xt.shape),
                                                   (torch.float32, st.shape)]


def _pair(arch, quant):
    jcfg = dataclasses.replace(jax_smoke_config(arch), quant=quant)
    cfg = dataclasses.replace(get_smoke_config(arch), quant=quant)
    jparams = jax_lm.init_params(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu").requires_grad_(True)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return jcfg, jparams, cfg, model, tokens


def _port_loss_grads(model, tokens, cfg):
    loss = lm.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, cfg)
    loss.backward()
    return float(loss.detach()), grads_to_jax(model)


@pytest.mark.parametrize("arch,quant", [("tinyllama-1.1b", "none"), ("tinyllama-1.1b", "bnn"),
                                        ("qwen1.5-0.5b", "bnn")])
def test_loss_and_every_gradient_leaf_match_the_reference(arch, quant):
    """tinyllama smoke without and with BNN projections, and qwen1.5
    smoke (tied head: ``embed`` gets the head's gradient too; qkv
    biases): the value and each leaf of the reference's gradient tree."""
    jcfg, jparams, cfg, model, tokens = _pair(arch, quant)
    with jax.disable_jit():
        jloss, jgrads = jax.value_and_grad(jax_lm.loss_fn)(
            jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    loss, grads = _port_loss_grads(model, tokens, cfg)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    tol = 1e-4 if quant == "none" else 2e-2
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    pleaves = jax.tree.leaves(grads)
    assert len(jleaves) == len(pleaves) and jax.tree.structure(grads) == jax.tree.structure(
        jax.tree.map(np.asarray, jgrads))
    for (path, want), got in zip(jleaves, pleaves):
        want = np.asarray(want)
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        scale = float(np.abs(want).max())
        assert scale > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                                   err_msg=jax.tree_util.keystr(path))
    if cfg.tie_embeddings:
        assert "head" not in grads


def test_remat_equals_the_plain_loop_bit_for_bit():
    _, _, cfg, model, tokens = _pair("tinyllama-1.1b", "bnn")
    loss_r, grads_r = _port_loss_grads(model, tokens, cfg)
    loss_p, grads_p = _port_loss_grads(model, tokens, dataclasses.replace(cfg, remat=False))
    assert loss_r == loss_p
    for a, b in zip(jax.tree.leaves(grads_r), jax.tree.leaves(grads_p), strict=True):
        np.testing.assert_array_equal(a, b)


def _saved_activations(model, tokens, cfg) -> list[tuple[torch.dtype, tuple]]:
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        lm.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, cfg)
    return saved


def test_checkpointed_backbone_saves_no_fp32_residual():
    """The reference's test_residual_stack_stays_bf16 on the port: with
    remat, the blocks' fp32 internals (the BitLinear's fp32 input, the
    FFN's fp32 pre-activation) are recomputed in the backward, so no
    fp32 (B, S, d) tensor is saved; without remat they are saved per
    block."""
    _, _, cfg, model, tokens = _pair("tinyllama-1.1b", "bnn")
    bsd = (*tokens.shape, cfg.d_model)
    remat = _saved_activations(model, tokens, cfg)
    plain = _saved_activations(model, tokens, dataclasses.replace(cfg, remat=False))
    assert (torch.float32, bsd) not in remat
    assert plain.count((torch.float32, bsd)) >= cfg.n_layers


def test_flash_attention_refuses_a_gradient():
    _, _, cfg, model, tokens = _pair("tinyllama-1.1b", "bnn")
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    with pytest.raises(layers.FlashBackwardError, match="attn_impl='jnp'"):
        lm.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, cfg)


def _ce(logits, y, xp):
    if xp is jnp:
        return -jnp.mean(jnp.sum(jax.nn.one_hot(y, 10) * jax.nn.log_softmax(logits), axis=-1))
    return torch.nn.functional.cross_entropy(logits, y)


def test_paper_mlp_gradient_matches_the_reference():
    """``mlp_forward_train``'s STE gradient (examples/train_bnn.py's loss)
    against ``jax.grad``: each leaf within 1e-4 of its largest magnitude
    (the fp32 edge layers sum in another order)."""
    cfg_j, cfg_t = jax_model.MLPConfig(dims=(784, 64, 32, 10)), port_model.MLPConfig(
        dims=(784, 64, 32, 10))
    jparams = jax_model.init_mlp(jax.random.key(0), cfg_j)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 784)).astype(np.float32)
    y = rng.integers(0, 10, 16)
    jg = jax.grad(lambda p: _ce(jax_model.mlp_forward_train(p, jnp.asarray(x), cfg_j),
                                jnp.asarray(y), jnp))(jparams)
    params = {k: v.requires_grad_(True) for k, v in params_dict(
        jax.tree.map(np.asarray, jparams), device="cpu").items()}
    _ce(port_model.mlp_forward_train(params, torch.from_numpy(x), cfg_t),
        torch.from_numpy(y), torch).backward()
    for k, want in jg.items():
        want = np.asarray(want)
        # the last layer's g is unused: no gradient reaches it (zeros in JAX)
        got = torch.zeros_like(params[k]) if params[k].grad is None else params[k].grad
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1e-30), err_msg=k)


def test_lenet_training_forward_carries_the_ste_gradient():
    """``conv_forward(train=True)`` against ``jax.grad`` of the
    reference's, leaf by leaf (1e-4 of each leaf's largest magnitude);
    ``train=False`` records no graph."""
    cfg_j, cfg_t = jax_model.ConvConfig(), port_model.ConvConfig()
    jparams = jax_model.init_conv(jax.random.key(1), cfg_j)
    x = np.random.default_rng(3).standard_normal((4, 28, 28, 1)).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jax_model.conv_forward(p, jnp.asarray(x), cfg_j) ** 2))(jparams)
    params = {k: v.requires_grad_(True) for k, v in params_dict(
        jax.tree.map(np.asarray, jparams), device="cpu").items()}
    (port_model.conv_forward(params, torch.from_numpy(x), cfg_t) ** 2).sum().backward()
    for k, want in jg.items():
        want = np.asarray(want)
        np.testing.assert_allclose(params[k].grad.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=k)
    assert port_model.conv_forward(params, torch.from_numpy(x), cfg_t, train=False).grad_fn is None

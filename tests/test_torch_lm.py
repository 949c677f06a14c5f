"""The port's LM spine against the JAX package, on the tinyllama-1.1b and
qwen1.5-0.5b smoke configs with the reference's parameters converted
(``repro_torch.convert.params_from_jax``).

Tolerances and their reasons:

* programmed words are bit-exact; ``alpha = mean|w|`` agrees to 2^-20
  relative (torch and XLA sum the m*n terms in different orders);
* single ops (RMSNorm, RoPE, both attention paths, the BitLinear) run
  eagerly in JAX and agree to one bf16 ulp on bf16 activations (the only
  differences are fp32 summation orders that move a value across a bf16
  rounding boundary);
* whole-model logits run against the reference's compiled model op by
  op and agree to 1e-6 of their largest magnitude (see
  test_torch_generate.py for why op by op, and why that tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jax_compiler
from repro.core import engine as jax_engine
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro_torch import compiler
from repro_torch.core import engine as engine_lib
from repro_torch.models import layers, lm
from test_torch_generate import ARCHS, jax_steps, pair, port_steps

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, dtype=np.float32))
    return t if dtype is None else t.to(dtype)


def _assert_bf16_ulp(got: torch.Tensor, want, n_ulp: int = 1):
    """|got - want| <= n_ulp bf16 ulps of |want| (ulp 2^(e-7))."""
    g, w = got.to(torch.float32).numpy(), _np(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0**-126))) - 7)
    bad = np.abs(g - w) > n_ulp * ulp
    assert not bad.any(), f"{bad.sum()} of {bad.size} beyond {n_ulp} bf16 ulp"


@pytest.mark.parametrize("arch", ARCHS)
def test_program_weights_words_bit_exact(arch):
    jcfg, jparams, cfg, model = pair(arch)
    jprog, jn = jax_lm.program_weights(jparams, jcfg, jax_engine.get_engine("packed"))
    prog, n = lm.program_weights(model, cfg, engine_lib.get_engine("packed"))
    assert n == jn == 7 * cfg.n_layers
    for layer, blk in enumerate(prog.blocks):
        jslot = jprog["blocks"]["slot0"]
        for part, names in lm.BINARIZED_PROJECTIONS.items():
            for name in names:
                ours = getattr({"attn": blk.mixer, "ffn": blk.ffn}[part], name)
                theirs = jslot[part][name]
                np.testing.assert_array_equal(
                    ours.words.numpy(), np.asarray(theirs["prepared"].data[layer])
                )
                np.testing.assert_allclose(
                    ours.alpha.numpy(), np.asarray(theirs["alpha"][layer]), rtol=2.0**-20
                )
        np.testing.assert_array_equal(
            blk.mixer.qkv.words.numpy(), np.asarray(jslot["attn"]["qkv"]["prepared"].data[layer])
        )


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm(dtype):
    rng = np.random.default_rng(1)
    x, s = rng.normal(size=(3, 7, 64)), rng.uniform(0.5, 1.5, size=(64,))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_layers.rms_norm(jnp.asarray(x, jdt), jnp.asarray(s, jnp.float32), 1e-5)
    got = layers.rms_norm(_t(_np(jnp.asarray(x, jdt)), dtype), _t(s), 1e-5)
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        _assert_bf16_ulp(got, want)
    else:
        np.testing.assert_array_max_ulp(got.numpy(), _np(want), maxulp=4)


@pytest.mark.parametrize("positions", ["shared", "per_row"])
def test_rope(positions):
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 5, 4, 16)), jnp.bfloat16)
    pos = np.arange(3, 8) if positions == "shared" else rng.integers(0, 100, size=(2, 5))
    want = jax_layers.rope(x, jnp.asarray(pos), 10_000.0)
    got = layers.rope(_t(_np(x), torch.bfloat16), torch.from_numpy(pos), 10_000.0)
    _assert_bf16_ulp(got, want)


@pytest.mark.parametrize(
    "sq,skv,chunk,h,kvh,causal",
    [(9, 9, 4, 4, 2, True), (6, 6, 32, 8, 2, True), (5, 12, 8, 4, 4, False), (16, 16, 16, 2, 1, True)],
)
def test_multi_head_attention(sq, skv, chunk, h, kvh, causal):
    """The chunked online-softmax path, incl. a padded last chunk and GQA."""
    rng = np.random.default_rng(sq * skv + h)
    q = jnp.asarray(rng.normal(size=(2, sq, h, 16)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(2, skv, kvh, 16)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(2, skv, kvh, 16)), jnp.bfloat16)
    qpos, kpos = jnp.arange(skv - sq, skv), jnp.arange(skv)
    want = jax_layers.multi_head_attention(q, k, v, qpos, kpos, causal=causal, chunk=chunk)
    got = layers.multi_head_attention(
        *(_t(_np(a), torch.bfloat16) for a in (q, k, v)),
        torch.arange(skv - sq, skv), torch.arange(skv), causal=causal, chunk=chunk,
    )
    _assert_bf16_ulp(got, want)


def test_multi_head_attention_pallas_waits_for_its_slice():
    """The flash-attention slice has landed: ``impl="pallas"`` runs the
    flash kernel's plain version here and agrees with the reference's
    Pallas path (interpret mode) to one bf16 ulp."""
    rng = np.random.default_rng(11)
    q = jnp.asarray(rng.normal(size=(2, 6, 4, 16)), jnp.bfloat16)
    kv = [jnp.asarray(rng.normal(size=(2, 9, 2, 16)), jnp.bfloat16) for _ in range(2)]
    qpos, kpos = jnp.arange(3, 9), jnp.arange(9)
    want = jax_layers.multi_head_attention(q, *kv, qpos, kpos, causal=True, chunk=4,
                                           impl="pallas")
    got = layers.multi_head_attention(
        *(_t(_np(a), torch.bfloat16) for a in (q, *kv)), torch.arange(3, 9), torch.arange(9),
        causal=True, chunk=4, impl="pallas",
    )
    _assert_bf16_ulp(got, want)


def test_decode_attention():
    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.normal(size=(3, 1, 8, 16)), jnp.bfloat16)
    kc = jnp.asarray(rng.normal(size=(3, 10, 2, 16)), jnp.bfloat16)
    vc = jnp.asarray(rng.normal(size=(3, 10, 2, 16)), jnp.bfloat16)
    lens = np.array([1, 6, 10])
    want = jax_layers.decode_attention(q, kc, vc, jnp.asarray(lens))
    got = layers.decode_attention(
        *(_t(_np(a), torch.bfloat16) for a in (q, kc, vc)), torch.from_numpy(lens)
    )
    _assert_bf16_ulp(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block_dense_and_ffn(arch):
    """Layer 0 of the smoke model, op by op, on the same input."""
    jcfg, jparams, cfg, model = pair(arch)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(2, 6, cfg.d_model)), jnp.bfloat16)
    tx = _t(_np(x), torch.bfloat16)
    sp = jax.tree.map(lambda a: a[0], jparams["blocks"]["slot0"])
    blk = model.blocks[0]
    want, (wk, wv) = jax_layers.attention_block(sp["attn"], x, jnp.arange(6), jcfg, quant="bnn")
    got, (k, v) = layers.attention_block(blk.mixer, tx, torch.arange(6), cfg, quant="bnn")
    for g, w in ((got, want), (k, wk), (v, wv)):
        _assert_bf16_ulp(g, w)
    _assert_bf16_ulp(layers.ffn(blk.ffn, tx, "bnn"), jax_layers.ffn(sp["ffn"], x, "bnn"))
    _assert_bf16_ulp(
        layers.dense(blk.mixer.q, tx, "none"), jax_layers.dense(sp["attn"]["q"], x, "none")
    )


@pytest.mark.parametrize("quant", ["none", "bnn"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch, quant):
    """Prefill + 3 decode steps on the reference engine (quant="none" is
    the full-precision path through the same layers)."""
    jcfg, jparams, cfg, model = pair(arch, quant)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 12))
    _, want = jax_steps(jcfg, jparams, jax_compiler.HardwareTarget(), tokens, 4)
    _, got = port_steps(cfg, model, compiler.HardwareTarget(), tokens, 4)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, cfg.padded_vocab)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())

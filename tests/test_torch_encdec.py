"""The encoder-decoder model (``models/encdec.py``) and cross-attention
against the JAX package's, and the enc-dec serving entry points, on the
seamless-m4t-large-v2 smoke config (2 + 2 layers, d 64, 4 heads of 16,
16 source frames, ``attn_chunk`` 32).

Against the reference (run op by op under ``jax.disable_jit``, the
helpers of test_torch_generate.py; flash in interpret mode where
``attn_impl="pallas"``), on converted parameters and numpy-seeded
inputs: ``cross_attention_block`` with fewer and with more queries than
source frames, ``encode``, ``prefill`` (logits and the four caches) and
4 greedy ``decode_step``\\ s, on the ``reference`` and ``packed``
engines and both attention paths. Logits agree within 1e-6 of their
largest magnitude (the bound the dense models are held to; on these
inputs they are equal), the caches bit for bit, the encoder output
within two bf16 ulps (a projection's alpha sums in another order than
XLA's; its binarized cross K/V absorb that), and greedy tokens are
identical.

Inside the port: ``packed`` == ``reference`` bit for bit; decode at
position n == a prefill of n + 1 tokens within the reference's own
bound (tests/test_smoke_archs.py, 5e-2); the pad-to-causal rule of the
plain-ops attention (16 frames under a 32-key chunk make the smoke
encoder causal, as in the reference); the tree round trip; compile()'s
refusal; the serve CLI's enc-dec refusals and lines.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jax_compiler
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import lm_batch as jax_lm_batch
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro_torch import compiler
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import encdec_from_jax, encdec_to_jax
from repro_torch.data import frontend_embeds, lm_batch
from repro_torch.launch import serve
from repro_torch.models import encdec, layers
from test_torch_generate import op_by_op

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
B, PROMPT, STEPS = 2, 12, 4


def _pair(engine="reference", impl="jnp", quant="bnn", seed=0):
    upd = dict(quant=quant, bnn_engine=engine, attn_impl=impl)
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **upd)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **upd)
    jparams = jax_encdec.init_params(jax.random.key(seed), jcfg)
    return jcfg, jparams, cfg, encdec_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _inputs(cfg, prompt=PROMPT, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return src, rng.integers(0, cfg.vocab_size, size=(B, prompt))


def _assert_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def _assert_two_ulps(got: torch.Tensor, want):
    """Within two bf16 ulps (rtol 2^-6, atol 2^-8 near zero): a
    projection's alpha = mean|w| sums in another order than XLA's, which
    moves an FFN output by one ulp now and then, and the encoder's final
    RMSNorm can double that (ROADMAP.md queue 3, the grok-1 entry)."""
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=2.0**-8, rtol=2.0**-6)


def jax_steps(jcfg, jparams, src, tokens, n):
    """The reference's enc-dec serving loop (its launch/serve.py), op by
    op: prefill, the caches grafted into a (prompt + n)-row cache, then
    n - 1 greedy decode steps. Returns the tokens (B, n), every step's
    logits, the prefill caches and the encoder output."""
    b, s = tokens.shape
    with op_by_op():
        src, tokens = jnp.asarray(src), jnp.asarray(tokens, jnp.int32)
        enc_out = jax_encdec.encode(jparams, src, jcfg)
        logits, pre = jax_encdec.prefill(jparams, src, tokens, jcfg)
        caches = jax_encdec.init_cache(jcfg, b, s + n, src.shape[1])
        caches = dict(
            caches, cross_k=pre["cross_k"], cross_v=pre["cross_v"],
            self_k=caches["self_k"].at[:, :, :s].set(pre["self_k"]),
            self_v=caches["self_v"].at[:, :, :s].set(pre["self_v"]),
        )
        out, all_logits = [jnp.argmax(logits, -1).astype(jnp.int32)], [np.asarray(logits)]
        for i in range(n - 1):
            logits, caches = jax_encdec.decode_step(jparams, out[-1], jnp.asarray(s + i), caches,
                                                    jcfg)
            out.append(jnp.argmax(logits, -1).astype(jnp.int32))
            all_logits.append(np.asarray(logits))
    return (np.stack([np.asarray(o) for o in out], 1), all_logits,
            {k: np.asarray(v.astype(jnp.float32)) for k, v in pre.items()}, enc_out)


@torch.no_grad()
def port_steps(cfg, model, src, tokens, n):
    """The port's loop, through the serve CLI's ``EncDecServing``."""
    served = serve.EncDecServing(model, cfg, torch.from_numpy(src), None, torch.device("cpu"))
    b, s = tokens.shape
    logits, pre = served.prefill(tokens)
    caches = served.graft_prefill_caches(served.init_cache(b, s + n), pre)
    out, all_logits = [torch.argmax(logits, -1)], [logits.numpy()]
    for i in range(n - 1):
        logits, caches = served.decode_step(out[-1], s + i, caches)
        out.append(torch.argmax(logits, -1))
        all_logits.append(logits.numpy())
    return torch.stack(out, 1).numpy(), all_logits, pre


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("sq", [5, 24])
def test_cross_attention_block_matches_reference(sq, impl):
    """5 decoder queries over 16 frames (row offset Skv - Sq = 11), and 24
    (offset -8: a prompt longer than the source)."""
    jcfg, jparams, cfg, model = _pair(impl=impl)
    rng = np.random.default_rng(sq)
    hd, kvh = cfg.hd, cfg.n_kv_heads
    x = jnp.asarray(rng.normal(size=(B, sq, cfg.d_model)), jnp.float32).astype(jnp.bfloat16)
    kv = [jnp.asarray(rng.normal(size=(B, cfg.frontend_len, kvh, hd)), jnp.float32)
          .astype(jnp.bfloat16) for _ in range(2)]
    pos = jnp.arange(sq)
    lp = jax.tree.map(lambda t: t[0], jparams["dec_blocks"])["cross_attn"]
    with op_by_op():
        want = jax_layers.cross_attention_block(lp, x, tuple(kv), pos, jcfg, "bnn")

    def t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    got = layers.cross_attention_block(model.dec_blocks[0].cross_attn, t(x), (t(kv[0]), t(kv[1])),
                                       torch.arange(sq), cfg, "bnn")
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("engine", ["reference", "packed"])
def test_encode_prefill_and_decode_match_the_reference(engine, impl):
    jcfg, jparams, cfg, model = _pair(engine, impl)
    src, tokens = _inputs(cfg)
    want, want_logits, want_caches, want_enc = jax_steps(jcfg, jparams, src, tokens, STEPS)
    with torch.no_grad():
        enc = encdec.encode(model, torch.from_numpy(src), cfg)
    _assert_two_ulps(enc, want_enc)
    got, got_logits, got_caches = port_steps(cfg, model, src, tokens, STEPS)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_logits, want_logits, strict=True):
        _assert_logits(g, w)
    assert set(got_caches) == set(want_caches)
    for key, w in want_caches.items():
        assert got_caches[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(got_caches[key].float().numpy(), w)


def test_training_decoder_matches_the_reference():
    """``decoder`` (the training pass: every projection on the plain
    path) over the reference's encoder output: the final-normed hidden
    states within two bf16 ulps."""
    jcfg, jparams, cfg, model = _pair()
    src, tokens = _inputs(cfg, seed=6)
    with op_by_op():
        enc = jax_encdec.encode(jparams, jnp.asarray(src), jcfg)
        want = jax_encdec.decoder(jparams, enc, jnp.asarray(tokens, jnp.int32), jcfg)
    enc_t = torch.from_numpy(np.asarray(enc.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        got = encdec.decoder(model, enc_t, torch.from_numpy(tokens), cfg)
    assert got.shape == (B, PROMPT, cfg.d_model) and got.dtype == torch.bfloat16
    _assert_two_ulps(got, want)


def test_lm_batch_of_the_reference_serves_equally():
    """The reference's own synthetic batch (Zipf tokens, stub frames)
    through both packages' prefill: equal logits."""
    jcfg, jparams, cfg, model = _pair("packed")
    batch = jax_lm_batch(jcfg, B, PROMPT, seed=3)
    src, tokens = np.asarray(batch["src_embeds"]), np.asarray(batch["tokens"])
    with op_by_op():
        want, _ = jax_encdec.prefill(jparams, jnp.asarray(src), jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        got, _ = encdec.prefill(model, torch.from_numpy(src), torch.from_numpy(tokens), cfg)
    _assert_logits(got.numpy(), want)


# ---------------------------------------------------------------------------
# invariants inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_packed_equals_reference_bit_for_bit(impl):
    _, _, ref_cfg, model = _pair("reference", impl)
    src, tokens = _inputs(ref_cfg, seed=5)
    want, want_logits, want_caches = port_steps(ref_cfg, model, src, tokens, 6)
    got, got_logits, got_caches = port_steps(dataclasses.replace(ref_cfg, bnn_engine="packed"),
                                             model, src, tokens, 6)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_logits, want_logits, strict=True):
        np.testing.assert_array_equal(g, w)
    for key, w in want_caches.items():
        assert torch.equal(got_caches[key], w)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_decode_matches_prefill_at_the_next_position(impl):
    """The reference's invariant (tests/test_smoke_archs.py), on its
    config (full-precision projections): prefill n tokens, decode token n
    at position n; its logits equal a prefill of n + 1 tokens within 5e-2
    (the prefill's attention rounds p and v to bf16, or runs flash;
    decode keeps them fp32). n = 19 >= 16 frames, so the plain-ops
    prefill's causal-masked cross-attention (the pad-to-causal rule) sees
    every frame at the last position, as decode does. Binarized, one
    flipped sign moves a logit by O(1): no such bound holds there."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), attn_impl=impl)
    model = encdec.init_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    src, tokens = _inputs(cfg, prompt=20, seed=4)
    src, tokens = torch.from_numpy(src), torch.from_numpy(tokens)
    n = tokens.shape[1] - 1
    with torch.no_grad():
        _, pre = encdec.prefill(model, src, tokens[:, :n], cfg)
        caches = encdec.graft_prefill_caches(encdec.init_cache(cfg, B, n + 1, src.shape[1],
                                                               device="cpu"), pre)
        got, _ = encdec.decode_step(model, tokens[:, n], n, caches, cfg)
        want, _ = encdec.prefill(model, src, tokens, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-2, rtol=5e-2)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_a_tick_names_its_latent_weight_side_for_the_profiler():
    """Every binarized projection of an enc-dec tick runs the latent path
    of ``layers.dense``, whose weight side (alpha, and the binarize + pack
    on a weight-cache miss) is one profiler span: 9 per decoder layer
    (self q/k/v/o, cross q/o, w1/w3/w2)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(get_smoke_config(ARCH), quant="bnn", bnn_engine="packed")
    model = encdec.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    src, tokens = _inputs(cfg, seed=2)
    src, tokens = torch.from_numpy(src), torch.from_numpy(tokens)
    n = tokens.shape[1] - 1
    with torch.no_grad():
        _, pre = encdec.prefill(model, src, tokens[:, :n], cfg)
        caches = encdec.graft_prefill_caches(encdec.init_cache(cfg, B, n + 1, src.shape[1],
                                                               device="cpu"), pre)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            encdec.decode_step(model, tokens[:, n], n, caches, cfg)
    spans = [e for e in prof.events() if e.name == layers.LATENT_WEIGHT_SPAN]
    assert len(spans) == 9 * cfg.n_layers


def test_smoke_encoder_is_causal_under_the_plain_ops_pad_rule():
    """16 frames under ``attn_chunk`` 32: the plain-ops attention pads the
    keys and masks them by position, which makes the encoder causal, as
    in the reference (whose encoder the port equals at this shape, above);
    the flash path has no such rule. Pinned at the attention and at the
    encoder: jnp equals an explicitly causal run and differs from the
    non-causal one."""
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, 16, 4, 16)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    pos = torch.arange(16)

    def mha(causal, chunk, impl="jnp"):
        return layers.multi_head_attention(q, k, v, pos, pos, causal=causal, chunk=chunk, impl=impl)

    assert torch.equal(mha(False, cfg.attn_chunk), mha(True, cfg.attn_chunk))
    assert not torch.equal(mha(False, cfg.attn_chunk), mha(False, 16))
    # the flash path is non-causal at this shape: it agrees with the
    # unpadded plain run (sum order apart), not with the padded one
    np.testing.assert_allclose(mha(False, 16, "pallas").float(), mha(False, 16).float(),
                               atol=2e-2, rtol=2e-2)
    # binarized projections: exact sums, so a row's bits do not depend on
    # the frame count
    cfg = dataclasses.replace(cfg, quant="bnn")
    model = encdec.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    src = torch.from_numpy(rng.normal(size=(B, 16, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        jnp_enc = encdec.encode(model, src, cfg)
        first9 = encdec.encode(model, src[:, :9], cfg)
        full = encdec.encode(model, src, dataclasses.replace(cfg, attn_chunk=16))
    # causal: the first 9 frames' outputs do not see the later 7
    assert torch.equal(jnp_enc[:, :9], first9)
    assert not torch.equal(jnp_enc, full)


def test_tree_round_trip():
    jcfg, jparams, cfg, model = _pair()
    tree = jax.tree.map(np.asarray, jparams)
    back = encdec_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree), jax.tree.leaves(back),
                            strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b)
    assert len(model.enc_blocks) == cfg.n_encoder_layers and len(model.dec_blocks) == cfg.n_layers
    again = encdec_from_jax(back, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), again.parameters(),
                                                 strict=True))


def test_init_params_shapes_match_the_reference():
    cfg = get_smoke_config(ARCH)
    model = encdec.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = jax.eval_shape(lambda: jax_encdec.init_params(jax.random.key(0),
                                                        jax_smoke_config(ARCH)))
    got = encdec_to_jax(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert model.embed.shape[0] == cfg.padded_vocab == 256


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_configs_batches_and_training_refusal():
    cfg = get_smoke_config(ARCH)
    full = get_config(ARCH)
    assert full.is_encdec and (full.n_layers, full.n_encoder_layers, full.d_model) == (24, 24, 1024)
    batch = lm_batch(cfg, B, 8, seed=1, device="cpu")
    assert batch["tokens"].shape == (B, 8) and "extra_embeds" not in batch
    assert batch["src_embeds"].shape == (B, cfg.frontend_len, cfg.d_model)
    assert torch.equal(batch["src_embeds"], lm_batch(cfg, B, 8, seed=1, device="cpu")["src_embeds"])
    embeds = frontend_embeds(cfg, B, device="cpu")
    assert embeds.dtype == torch.float32 and torch.equal(embeds, frontend_embeds(cfg, B,
                                                                                device="cpu"))
    model = encdec.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    loss = encdec.loss_fn(model.requires_grad_(True), batch, cfg)
    assert torch.isfinite(loss)
    loss.backward()
    params = list(model.parameters())
    assert params and all(p.grad is not None and torch.isfinite(p.grad).all() for p in params)


@pytest.mark.parametrize("engine", ["packed", "tiled"])
def test_compile_refuses_enc_dec_on_hardware_targets(engine):
    target = dict(engine=engine, mapping_policy="tacitmap") if engine == "tiled" else dict(
        engine=engine)
    jcfg = jax_smoke_config(ARCH)
    with pytest.raises(jax_compiler.TargetError, match="enc-dec models serve through") as want:
        jax_compiler.compile(jcfg, None, jax_compiler.HardwareTarget(**target))
    with pytest.raises(compiler.TargetError) as got:
        compiler.compile(get_smoke_config(ARCH), None, compiler.HardwareTarget(**target),
                         device="cpu")
    assert str(got.value) == str(want.value)
    cm = compiler.compile(get_smoke_config(ARCH), None, compiler.HardwareTarget(), device="cpu")
    assert cm.engine is None and cm.programmed == 0


@pytest.mark.parametrize("flags,message", [
    (["--engine", "packed", "--group-size", "2"], "--group-size applies to the decoder-only"),
    (["--engine", "tiled", "--mapping-policy", "greedy"], "--mapping-policy/--tile-budget place"),
    (["--engine", "packed", "--raw-weights"], "--raw-weights toggles the decoder-only"),
    (["--replicas", "2", "--requests", "4"], "--replicas drives the decoder-only fleet path"),
    (["--requests", "4"], "--requests drives the decoder-only scheduler path"),
])
def test_serve_cli_refuses_decoder_only_knobs(flags, message, capsys):
    with pytest.raises(SystemExit):
        serve.run(["--arch", ARCH, "--smoke", "--device", "cpu", *flags])
    assert message in capsys.readouterr().err


def test_serve_cli_lines_and_generations(capsys):
    """``--engine packed`` prints the reference's engine line and serves
    the same tokens as the ``reference`` engine, which equal a direct
    ``encdec`` loop on the same seeded weights and frames."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6",
            "--gen", "4"]
    assert serve.main(argv + ["--engine", "packed"]) == 0
    out = capsys.readouterr().out
    assert "[serve] engine=packed (bit-packed XNOR+popcount CUDA kernels" in out
    assert "arch=seamless-smoke device=cpu engine=packed quant=bnn (enc-dec: not compiled)" in out
    assert "programmed=" not in out
    assert "over 16 source frames: prefill" in out and "[serve] generated[0,:8] = " in out
    packed = serve.run(argv + ["--engine", "packed"])
    ref = serve.run(argv + ["--engine", "reference"])
    assert ref["compiled"].cfg.quant == "none" and packed["compiled"].cfg.bnn_engine == "packed"
    assert packed["generated"].shape == (2, 4)
    cfg = packed["compiled"].cfg
    model = encdec.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    src = frontend_embeds(cfg, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = serve.prompts(cfg, 2, 6, 0)
    want = serve.lockstep(serve.EncDecServing(model, cfg, src, None, torch.device("cpu")),
                          tokens, 4)
    np.testing.assert_array_equal(packed["generated"], want["generated"])
    assert torch.equal(packed["prefill_logits"], want["prefill_logits"])

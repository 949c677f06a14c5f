"""The vision frontend (``lm.prefill(extra_embeds=)``) against the JAX
package's, and its serving rules, on the internvl2-1b smoke config (2
layers, d 56, 14 / 2 heads of 4, 8 patch embeddings).

Against the reference's compiled model run op by op (the helpers of
test_torch_generate.py; flash in interpret mode where
``attn_impl="pallas"``), on converted parameters and numpy-seeded
patches and tokens: ``CompiledModel.prefill(tokens, extra_embeds)`` and
4 greedy decode steps from position ``frontend_len + prompt_len``, on
``reference`` and ``packed`` and both attention paths. Logits agree
within 1e-6 of their largest magnitude (the bound the dense models are
held to; on these inputs they are equal), and greedy tokens are
identical.

Inside the port, as in the reference: ``prefill_continue`` takes no
``extra_embeds``; a vision model never grafts a prefix; the request path
serves token prompts, 8 slots == each request alone; the serve CLI's
lockstep prepends the patches and decodes after them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jax_compiler
from repro.models import lm as jax_lm
from repro_torch import compiler
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import frontend_embeds, lm_batch
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serving import Request
from test_torch_generate import op_by_op, pair

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

ARCH = "internvl2-1b"
B, PROMPT, STEPS = 2, 12, 4


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, PROMPT))
    return tokens, rng.normal(size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)


def jax_steps(jcfg, jparams, engine, tokens, extra, n):
    """The reference's VLM serving loop (its launch/serve.py), op by op."""
    b, s = tokens.shape
    start = s + extra.shape[1]
    with op_by_op():
        cm = jax_compiler.compile(jcfg, jparams, jax_compiler.HardwareTarget(engine=engine))
        logits, pre = cm.prefill(jnp.asarray(tokens, jnp.int32), jnp.asarray(extra))
        caches = cm.graft_prefill_caches(cm.init_cache(b, start + n), pre)
        out, all_logits = [jnp.argmax(logits, -1).astype(jnp.int32)], [np.asarray(logits)]
        for i in range(n - 1):
            logits, caches = cm.decode_step(out[-1], jnp.asarray(start + i, jnp.int32), caches)
            out.append(jnp.argmax(logits, -1).astype(jnp.int32))
            all_logits.append(np.asarray(logits))
    return np.stack([np.asarray(o) for o in out], 1), all_logits


def port_steps(cm, tokens, extra, n):
    b, s = tokens.shape
    start = s + extra.shape[1]
    logits, pre = cm.prefill(tokens, torch.from_numpy(extra))
    caches = cm.graft_prefill_caches(cm.init_cache(b, start + n), pre)
    out, all_logits = [torch.argmax(logits, -1)], [logits.numpy()]
    for i in range(n - 1):
        logits, caches = cm.decode_step(out[-1], start + i, caches)
        out.append(torch.argmax(logits, -1))
        all_logits.append(logits.numpy())
    return torch.stack(out, 1).numpy(), all_logits


def _compiled(engine="packed", impl="jnp", seed=0):
    cfg = dataclasses.replace(get_smoke_config(ARCH), quant="bnn", attn_impl=impl)
    params = lm.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return compiler.compile(cfg, params, compiler.HardwareTarget(engine=engine), device="cpu")


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("engine", ["reference", "packed"])
def test_prefill_with_patches_and_decode_match_the_reference(engine, impl):
    jcfg, jparams, cfg, model = pair(ARCH, seed=1)
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    tokens, extra = _inputs(cfg)
    want, want_logits = jax_steps(jcfg, jparams, engine, tokens, extra, STEPS)
    cm = compiler.compile(cfg, model, compiler.HardwareTarget(engine=engine), device="cpu")
    got, got_logits = port_steps(cm, tokens, extra, STEPS)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_logits, want_logits, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())


def test_patches_take_the_first_positions():
    """The caches cover L + S positions, the patches' rows first; and the
    patch embeddings matter (another image, other logits)."""
    cm = _compiled()
    cfg = cm.cfg
    tokens, extra = _inputs(cfg)
    logits, pre = cm.prefill(tokens, torch.from_numpy(extra))
    assert pre["slot0"]["k"].shape == (cfg.n_layers, B, cfg.frontend_len + PROMPT,
                                       cfg.n_kv_heads, cfg.hd)
    other, _ = cm.prefill(tokens, torch.from_numpy(extra[::-1].copy()))
    assert not torch.equal(logits, other)
    # the patches' rows are those of a prefill over the patches alone
    # (causal: they do not see the tokens after them)
    _, alone = lm.prefill(cm.params, torch.zeros((B, 0), dtype=torch.int64), cfg,
                          extra_embeds=torch.from_numpy(extra), engine=cm.executor(B))
    assert torch.equal(pre["slot0"]["k"][:, :, : cfg.frontend_len], alone["slot0"]["k"])


def test_packed_equals_reference_bit_for_bit():
    tokens, extra = _inputs(get_smoke_config(ARCH), seed=3)
    want = serve.lockstep(_compiled("reference"), tokens, 6, torch.from_numpy(extra))
    got = serve.lockstep(_compiled("packed"), tokens, 6, torch.from_numpy(extra))
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert torch.equal(got["prefill_logits"], want["prefill_logits"])


def test_prefill_continue_takes_no_frontend_embeddings():
    """As the reference's: ``prefill_continue`` has no ``extra_embeds``
    (a VLM prompt's patches have positions a token-hash prefix cannot
    name), in both packages."""
    jcfg, jparams, cfg, model = pair(ARCH, seed=0)
    tokens, extra = _inputs(cfg)
    cm = compiler.compile(cfg, model, compiler.HardwareTarget(engine="packed"), device="cpu")
    _, pre = cm.prefill(tokens[:, :8])
    with pytest.raises(TypeError, match="extra_embeds"):
        cm.prefill_continue(tokens[:, 8:], pre, extra_embeds=torch.from_numpy(extra))
    with pytest.raises(TypeError, match="extra_embeds"):
        lm.prefill_continue(cm.params, torch.as_tensor(tokens[:, 8:]), pre, cfg,
                            extra_embeds=torch.from_numpy(extra))
    with pytest.raises(TypeError, match="extra_embeds"):
        jax_lm.prefill_continue(jparams, jnp.asarray(tokens[:, 8:]), None, jcfg,
                                extra_embeds=jnp.asarray(extra))


def test_request_path_serves_token_prompts_and_never_grafts():
    """8 token-prompt requests (1 to 20 tokens) in 8 slots through
    ``serve()``: every generation equals the request served alone, and
    no prefix is grafted (a vision model never grafts, as in the
    reference's serving engine)."""
    cm = _compiled()
    se = cm.serve(max_batch=8, max_len=40)
    assert not se.supports_prefix_graft
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, cm.cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=5) for i, n in enumerate((3, 9, 12, 5, 16, 7, 1, 20))]
    alone = {}
    for r in reqs:
        solo = cm.serve(max_batch=1, max_len=40)
        st = solo.submit(r)
        solo.drain()
        alone[r.rid] = st.generated
    states = [se.submit(r) for r in reqs]
    se.drain()
    assert [s.generated for s in states] == [alone[r.rid] for r in reqs]
    assert se.stats().grafted_tokens == 0


def test_configs_and_batches():
    cfg = get_smoke_config(ARCH)
    full = get_config(ARCH)
    assert full.frontend == "vision" and (full.frontend_len, full.d_model, full.n_kv_heads) == (
        256, 896, 2)
    batch = lm_batch(cfg, B, 8, seed=2, device="cpu")
    assert batch["extra_embeds"].shape == (B, cfg.frontend_len, cfg.d_model)
    assert "src_embeds" not in batch
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    loss = lm.loss_fn(model.requires_grad_(True), batch, cfg)
    assert torch.isfinite(loss)
    loss.backward()
    params = list(model.parameters())
    assert params and all(p.grad is not None and torch.isfinite(p.grad).all() for p in params)


def test_serve_cli_prepends_the_patches(capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--engine", "packed", "--batch", "2",
            "--prompt-len", "6", "--gen", "4"]
    assert serve.main(argv) == 0
    assert "prompt=6 after 8 patch embeddings: prefill" in capsys.readouterr().out
    res = serve.run(argv)
    cm = res["compiled"]
    extra = frontend_embeds(cm.cfg, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = serve.prompts(cm.cfg, 2, 6, 0)
    logits, pre = cm.prefill(tokens, extra)
    caches = cm.graft_prefill_caches(cm.init_cache(2, 8 + 6 + 4), pre)
    want = [torch.argmax(logits, -1)]
    for i in range(3):  # positions after the 8 patches and 6 tokens
        logits, caches = cm.decode_step(want[-1], 14 + i, caches)
        want.append(torch.argmax(logits, -1))
    np.testing.assert_array_equal(res["generated"], torch.stack(want, 1).numpy())
    assert serve.main(argv + ["--requests", "3"]) == 0

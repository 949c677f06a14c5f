"""The port's flash attention against the JAX package's, and the
prefix-graft continuation it carries.

* ``kernels.flash_attention.flash_attention`` (its plain version here on
  the CPU) against the reference's Pallas kernel in interpret mode and
  against ``ref.attention_ref``, on the shape/dtype/GQA sweep of
  tests/test_flash_attention.py plus Skv > Sq, ragged and non-causal
  cases, within that file's tolerances (fp32 2e-5, bf16 2e-2);
* each query row's result does not depend on Sq, in both attention
  paths: the property that makes a grafted continuation exact;
* whole smoke models with ``attn_impl="pallas"`` against the reference's
  op-by-op run, and ``prefill_continue`` == ``prefill`` bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jax_compiler
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch import compiler
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref, rows
from repro_torch.models import layers, lm
from repro_torch.models.config import LayerKind
from test_torch_generate import ARCHS, op_by_op, pair

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

DTYPES = [(jnp.float32, torch.float32, 2e-5), (jnp.bfloat16, torch.bfloat16, 2e-2)]


def _qkv(b, h, kvh, sq, skv, d, jdtype, seed=0):
    """The same numpy draws as JAX arrays of ``jdtype`` and as torch
    tensors holding the identical (already rounded) values."""
    rng = np.random.default_rng(seed)
    arrs = [
        jnp.asarray(rng.normal(size=shape), jnp.float32).astype(jdtype)
        for shape in ((b, h, sq, d), (b, kvh, skv, d), (b, kvh, skv, d))
    ]
    tdtype = torch.bfloat16 if jdtype == jnp.bfloat16 else torch.float32
    ts = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tdtype) for a in arrs]
    return arrs, ts


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32)),
        atol=tol, rtol=tol,
    )


@pytest.mark.parametrize("jdtype,tdtype,tol", DTYPES)
@pytest.mark.parametrize(
    "b,h,kvh,sq,skv,d,causal",
    [
        (1, 2, 2, 128, 128, 32, True),    # MHA square
        (2, 4, 1, 128, 256, 16, True),    # GQA g=4, longer KV (Skv > Sq)
        (1, 8, 2, 256, 256, 64, True),    # GQA g=4
        (1, 4, 2, 24, 72, 16, True),      # a continuation: 24 queries over 72 keys
        (1, 2, 2, 200, 200, 32, True),    # ragged Sq = Skv
        (1, 2, 2, 128, 128, 32, False),   # non-causal square
        (2, 4, 2, 40, 100, 16, False),    # non-causal, Skv < the reference's block
    ],
)
def test_flash_matches_jax_kernel_and_ref(b, h, kvh, sq, skv, d, causal, jdtype, tdtype, tol):
    (jq, jk, jv), (q, k, v) = _qkv(b, h, kvh, sq, skv, d, jdtype, seed=sq + skv + h)
    got = fa.flash_attention(q, k, v, causal=causal)
    assert got.shape == (b, h, sq, d) and got.dtype == tdtype
    _close(got, jax_flash(jq, jk, jv, causal=causal, interpret=True), tol)
    _close(got, jax_ref.attention_ref(jq, jk, jv, causal=causal), tol)
    _close(ref.attention_ref(q, k, v, causal=causal),
           jax_ref.attention_ref(jq, jk, jv, causal=causal), tol)


def test_non_causal_ragged_keys_raise_as_in_the_reference():
    (jq, jk, jv), (q, k, v) = _qkv(1, 2, 2, 64, 200, 16, jnp.float32)
    with pytest.raises(ValueError, match="Skv % bk"):
        jax_flash(jq, jk, jv, causal=False, interpret=True)
    with pytest.raises(ValueError, match="Skv % bk"):
        fa.flash_attention(q, k, v, causal=False)


def test_rejects_mismatched_heads():
    q = torch.zeros((1, 3, 4, 8))
    k = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="KV | H"):
        fa.flash_attention(q, k, k)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_rows_do_not_depend_on_sq(impl):
    """fp32 attention over the same keys: the rows of a suffix of the
    queries equal the same rows of the full pass bit for bit, for every
    cut (a CPU GEMM rounds a few-row product differently unless the rows
    run in blocks aligned to their positions)."""
    rng = np.random.default_rng(5)
    s = 40
    q, k, v = (torch.from_numpy(rng.normal(size=(1, s, n, 8)).astype(np.float32))
               for n in (8, 2, 2))
    pos = torch.arange(s)
    full = layers.multi_head_attention(q, k, v, pos, pos, causal=True, chunk=32, impl=impl)
    for cut in range(1, s):
        part = layers.multi_head_attention(q[:, cut:], k, v, pos[cut:], pos, causal=True,
                                           chunk=32, impl=impl)
        assert torch.equal(part, full[:, cut:]), f"cut {cut}"


def test_row_reductions_do_not_depend_on_row_count():
    """The other per-row ops of a serving step: the row mean (RMSNorm,
    the activation scale) pads calls below ``rows.MEAN_ROWS`` rows, and
    decode attention runs lanes in fixed blocks, so a row's bits do not
    depend on how many rows share the call (on the card a reduction or
    GEMM picks its layout by shape: without these, a request batched in
    8 slots decoded other tokens than alone)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(40, 96)).astype(np.float32))
    full = rows.row_mean(x)
    assert full.shape == (40, 1)
    torch.testing.assert_close(full, x.mean(dim=-1, keepdim=True), rtol=1e-6, atol=0)
    for r in range(1, 40):
        assert torch.equal(rows.row_mean(x[:r]), full[:r]), f"{r} rows"
    q = torch.from_numpy(rng.normal(size=(20, 1, 8, 16)).astype(np.float32)).to(torch.bfloat16)
    kc, vc = (torch.from_numpy(rng.normal(size=(20, 24, 2, 16)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    lens = torch.from_numpy(rng.integers(1, 25, size=(20,)))
    full = layers.decode_attention(q, kc, vc, lens)
    for b in (1, 3, 8, 16, 17):
        assert torch.equal(layers.decode_attention(q[:b], kc[:b], vc[:b], lens[:b]), full[:b])


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_pallas_matches_jax(arch):
    """Prefill logits with ``attn_impl="pallas"`` through both packages'
    compiled models (packed engine; the reference op by op, its flash
    kernel in interpret mode). At smoke size one key tile covers the
    prompt on both sides, so they agree to 1e-6 of the largest logit,
    as the plain-ops path does (test_torch_generate.py)."""
    jcfg, jparams, cfg, model = pair(arch, seed=2)
    jcfg = dataclasses.replace(jcfg, attn_impl="pallas")
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 24))
    with op_by_op():
        cm = jax_compiler.compile(jcfg, jparams, jax_compiler.HardwareTarget(engine="packed"))
        want = np.asarray(cm.prefill(jnp.asarray(tokens, jnp.int32))[0])
    got = compiler.compile(cfg, model, compiler.HardwareTarget(engine="packed"),
                           device="cpu").prefill(tokens)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("engine", ["packed", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_continue_equals_prefill(arch, engine, impl):
    """The serving invariant: a suffix prefilled over donated prefix rows
    gives the full prefill's logits and caches bit for bit, for cuts
    leaving suffixes from one token to most of the prompt."""
    _, _, cfg, model = pair(arch)
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    cm = compiler.compile(cfg, model, compiler.HardwareTarget(engine=engine), device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, 37))
    full_logits, full = cm.prefill(tokens)
    for cut in (4, 17, 36):
        _, donor = cm.prefill(tokens[:, :cut])
        logits, caches = cm.prefill_continue(tokens[:, cut:], donor)
        assert torch.equal(logits, full_logits), f"cut {cut}"
        for slot, kv in full.items():
            for key, t in kv.items():
                assert torch.equal(caches[slot][key], t), f"cut {cut} {slot}/{key}"


def test_prefix_continuation_rejects_non_attention_stacks():
    _, _, cfg, _ = pair("tinyllama-1.1b")
    hybrid = dataclasses.replace(cfg, pattern=(LayerKind(), LayerKind(mixer="mamba")))
    with pytest.raises(lm.PrefixContinuationError, match="mixer"):
        lm.prefill_continue(None, torch.zeros((1, 4), dtype=torch.int64), {}, hybrid)

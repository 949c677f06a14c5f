"""Inside the port, every engine matches ``reference`` bit for bit:
``binary_vmm``/``binary_mmm``, the fused BitLinear, K-grouping with
ragged tails, prepared vs raw weights and the block-padded artifact."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import compiler
from repro_torch.configs import get_smoke_config
from repro_torch.core import bnn
from repro_torch.core import engine as engine_lib
from repro_torch.models import layers, lm

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)


def _signs(rng, shape):
    return torch.from_numpy(rng.choice(np.array([-1.0, 1.0], np.float32), size=shape))


@pytest.mark.parametrize("prepad", [False, True])
@pytest.mark.parametrize("m,n", [(1, 3), (33, 17), (100, 48), (256, 130)])
def test_packed_matches_reference_vmm_mmm(m, n, prepad):
    rng = np.random.default_rng(m * 7 + n)
    a, w = _signs(rng, (3, 5, m)), _signs(rng, (m, n))
    ref = engine_lib.get_engine("reference")
    packed = engine_lib.get_engine("packed", prepad=prepad)
    want = ref.binary_vmm(a, w)
    torch.testing.assert_close(want, a @ w, rtol=0, atol=0)
    got_raw = packed.binary_vmm(a, w)
    got_prep = packed.binary_vmm(a, packed.prepare(w))
    assert torch.equal(got_raw.to(torch.float32), want)
    assert torch.equal(got_prep, got_raw)
    groups = a.reshape(3, 5, m)
    assert torch.equal(packed.binary_mmm(groups, w).to(torch.float32), ref.binary_mmm(groups, w))


@pytest.mark.parametrize("k,b", [(1, 5), (3, 7), (4, 4), (8, 3)])
def test_grouped_engine_ragged_tails(k, b):
    """Ragged tails pad with +1 signs and are discarded: bit-exact for any B."""
    rng = np.random.default_rng(k * 10 + b)
    a, w = _signs(rng, (b, 70)), _signs(rng, (70, 11))
    grouped = engine_lib.GroupedEngine(engine_lib.get_engine("packed"), k)
    assert torch.equal(grouped.binary_vmm(a, w).to(torch.float32), a @ w)
    assert grouped.name == f"packed@k{k}"
    assert grouped.steps_for(70, 11, b) == -(-b // k)


@pytest.mark.parametrize("prepad", [False, True])
@pytest.mark.parametrize("lead", [(1,), (6,), (2, 3)])
def test_fused_dense_matches_unfused_chain(lead, prepad):
    """The fused BitLinear == binarize -> ±1 matmul -> (alpha * beta), bit
    for bit, on bf16 activations, through the engine and a GroupedEngine."""
    rng = np.random.default_rng(sum(lead))
    x = torch.from_numpy(rng.normal(size=(*lead, 100)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(100, 48)).astype(np.float32))
    alpha = w.abs().mean()
    beta = x.abs().float().mean(dim=-1, keepdim=True)
    want = (bnn.binarize_ste(x.float()) @ bnn.binarize_ste(w)) * (alpha * beta)
    packed = engine_lib.get_engine("packed", prepad=prepad)
    pw = packed.prepare(bnn.binarize_ste(w))
    assert torch.equal(packed.fused_dense(x, pw, alpha), want)
    grouped = engine_lib.GroupedEngine(packed, 4)
    assert grouped.supports_fused_dense
    assert torch.equal(grouped.fused_dense(x, pw, alpha), want)


def test_dense_fused_unfused_raw_reference_agree():
    """``layers.dense`` on one projection: fused, unfused-prepared, raw
    (weight-cache) and the plain reference path give the same bf16."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 5, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(64, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))
    latent = layers.BitLinear(w, b)
    want = layers.dense(latent, x, "bnn", None)
    for fused in (True, False):
        eng = engine_lib.get_engine("packed", fused=fused)
        prog = lm._program(latent, eng)
        assert torch.equal(layers.dense(prog, x, "bnn", eng), want)
        assert torch.equal(layers.dense(latent, x, "bnn", eng), want)
    ref = engine_lib.get_engine("reference")
    assert torch.equal(layers.dense(lm._program(latent, ref), x, "bnn", ref), want)


def test_prepare_cached_hits_on_identity():
    eng = engine_lib.get_engine("packed")
    w = torch.ones((40, 8))
    calls = []

    def signs():
        calls.append(1)
        return w

    p1 = eng.prepare_cached(signs, key=w)
    p2 = eng.prepare_cached(signs, key=w)
    assert p1 is p2 and len(calls) == 1
    assert eng.cache_stats()["weight_cache"]["hits"] == 1
    with pytest.raises(ValueError, match="explicit cache key"):
        eng.prepare_cached(signs)


def test_prepared_for_another_engine_is_rejected():
    w = torch.ones((40, 8))
    pw = engine_lib.get_engine("reference").prepare(w)
    with pytest.raises(ValueError, match="programmed for engine 'reference'"):
        engine_lib.get_engine("packed").binary_vmm(torch.ones((1, 40)), pw)
    with pytest.raises(ValueError, match="does not match"):
        engine_lib.get_engine("packed").binary_vmm(torch.ones((1, 39)), w)


def test_registry():
    assert engine_lib.list_engines() == [
        "custbinarymap", "packed", "reference", "tacitmap", "tiled", "wdm"]
    wdm = engine_lib.get_engine("wdm")
    assert wdm.info.native_mmm and wdm.preferred_group_size() == wdm.spec.wdm_k == 16
    with pytest.raises(ValueError, match="unknown engine"):
        engine_lib.get_engine("nope")
    assert engine_lib.resolve_group_size(engine_lib.get_engine("packed"), None, 6) == 6
    assert engine_lib.resolve_group_size(None, 4, 3) == 3
    # K: an explicit request, else the engine's wavelengths, clamped to the batch
    assert engine_lib.resolve_group_size(wdm, None, 6) == 6
    assert engine_lib.resolve_group_size(wdm, None, 40) == 16
    assert engine_lib.resolve_group_size(wdm, 3, 40) == 3


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-0.5b"])
def test_programmed_model_matches_reference_engine(arch):
    """Whole smoke model: packed (fused and unfused, programmed and raw)
    prefill logits and caches equal the reference engine's exactly."""
    cfg = dataclasses.replace(get_smoke_config(arch), quant="bnn")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)))
    ref = compiler.compile(cfg, params, compiler.HardwareTarget(), device="cpu")
    want_logits, want_caches = ref.prefill(tokens)
    for target in (
        compiler.HardwareTarget(engine="packed"),
        compiler.HardwareTarget(engine="packed", fused=False),
        compiler.HardwareTarget(engine="packed", prepare_weights=False),
    ):
        cm = compiler.compile(cfg, params, target, device="cpu")
        assert cm.programmed == (7 * cfg.n_layers if target.prepare_weights else 0)
        logits, caches = cm.prefill(tokens)
        assert torch.equal(logits, want_logits), target
        assert torch.equal(caches["slot0"]["k"], want_caches["slot0"]["k"])

"""The crossbar-simulator engines (``tacitmap``, ``wdm``, ``tiled``,
``custbinarymap``) beside ``reference`` and ``packed``: every engine's
``binary_vmm`` / ``binary_mmm`` equals the JAX package's engine of the
same name and the port's ``reference``, prepared equals raw, the
``tiled`` engine under every allocator policy and an over-subscribed
plan, the compiler's map stage and its named errors, and smoke-size
generations through ``compile()`` equal the JAX engines' (run op by op)
and the port's ``packed`` tokens.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jax_compiler
from repro import mapping as jax_mapping
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import crossbar as jcrossbar
from repro.core import engine as jengine
from repro_torch import compiler, mapping, obs
from repro_torch.configs import get_smoke_config
from repro_torch.core import crossbar
from repro_torch.core import engine as engine_lib
from repro_torch.models import lm
from test_torch_generate import jax_steps, pair, port_steps

torch.set_num_threads(1)

ENGINES = ["reference", "tacitmap", "wdm", "packed", "tiled", "custbinarymap"]
SIMULATORS = ["tacitmap", "wdm", "tiled", "custbinarymap"]


def _signs(rng, shape):
    return rng.choice(np.array([-1.0, 1.0], np.float32), size=shape)


def _same(got: torch.Tensor, want) -> bool:
    """Equal integer values (packed returns int32, the simulators fp32 as
    in the reference)."""
    want = np.asarray(want)
    return got.shape == want.shape and np.array_equal(got.numpy().astype(np.float64),
                                                      want.astype(np.float64))


def test_every_reference_engine_is_registered():
    assert engine_lib.list_engines() == sorted(jengine.list_engines())
    assert not hasattr(engine_lib, "PENDING_ENGINES")
    for name in ENGINES:
        compiler.HardwareTarget(engine=name).validate()
        info, jinfo = engine_lib.engine_info(name), jengine.engine_info(name)
        assert (info.name, info.native_mmm, info.packed, info.default_spec) == (
            jinfo.name, jinfo.native_mmm, jinfo.packed, jinfo.default_spec)


@pytest.mark.parametrize("m,n", [(33, 17), (300, 513)])
@pytest.mark.parametrize("name", ENGINES)
def test_vmm_mmm_equal_jax_and_reference(name, m, n):
    """(…, m) x (m, n) with two leading dims and (G, K, m) groups; raw
    weights, the prepared artifact, and JAX's engine on the same signs."""
    rng = np.random.default_rng(m * 7 + n)
    a, w, groups = _signs(rng, (2, 3, m)), _signs(rng, (m, n)), _signs(rng, (2, 5, m))
    eng, jeng = engine_lib.get_engine(name), jengine.get_engine(name)
    ref = engine_lib.get_engine("reference")
    ta, tw, tg = (torch.from_numpy(x) for x in (a, w, groups))
    want = ref.binary_vmm(ta, tw)
    assert np.array_equal(want.numpy(), a @ w)
    raw = eng.binary_vmm(ta, tw)
    pw = eng.prepare(tw)
    assert torch.equal(eng.binary_vmm(ta, pw), raw)
    assert torch.equal(raw.to(torch.float32), want)
    assert _same(raw, jeng.binary_vmm(jnp.asarray(a), jnp.asarray(w)))
    mmm = eng.binary_mmm(tg, pw)
    assert torch.equal(mmm, eng.binary_mmm(tg, tw))
    assert torch.equal(mmm.to(torch.float32), ref.binary_mmm(tg, tw))
    assert _same(mmm, jeng.binary_mmm(jnp.asarray(groups), jnp.asarray(w)))
    assert eng.steps_for(m, n, 9) == jeng.steps_for(m, n, 9)
    assert eng.preferred_group_size() == jeng.preferred_group_size()
    if name in SIMULATORS[:3]:  # complement cell states, fp32, compact
        assert pw.data.shape == (2 * m, n) and pw.data.dtype == torch.float32


@pytest.mark.parametrize("tech", ["ePCM", "oPCM"])
@pytest.mark.parametrize("name", SIMULATORS)
def test_spec_binding_and_step_counts_equal_jax(name, tech):
    spec = crossbar.EPCM_TILE if tech == "ePCM" else crossbar.OPCM_TILE
    jspec = jcrossbar.EPCM_TILE if tech == "ePCM" else jcrossbar.OPCM_TILE
    eng, jeng = engine_lib.get_engine(name, spec), jengine.get_engine(name, jspec)
    assert eng.preferred_group_size() == jeng.preferred_group_size()
    for m, n, b in ((64, 16, 1), (2048, 5632, 8), (5632, 2048, 37)):
        assert eng.steps_for(m, n, b) == jeng.steps_for(m, n, b)
    rebound = engine_lib.resolve(eng, dataclasses.replace(spec, rows=128))
    assert rebound.name == name and rebound.spec.rows == 128
    assert engine_lib.resolve(eng, dataclasses.replace(spec)) is eng


@pytest.mark.parametrize("budget", [None, 3])
@pytest.mark.parametrize("policy", mapping.POLICIES)
def test_tiled_per_plan_equals_jax_and_reference(policy, budget):
    """A two-layer plan (one shape with a ragged last block) under every
    policy, dedicated and over-subscribed: the placement indices equal
    JAX's, the output equals JAX's tiled engine and the reference, and
    a shape outside the plan is placed ad hoc under the plan's policy."""
    from repro.mapping import ir as jir
    from repro_torch.mapping import ir

    layers = [("a", 300, 513), ("b", 130, 260)]
    tplan = mapping.allocate(
        ir.ModelIR("two", "adhoc", tuple(ir.LayerIR(nm, m, n) for nm, m, n in layers)),
        policy=policy, tile_budget=budget)
    jplan = jax_mapping.allocate(
        jir.ModelIR("two", "adhoc", tuple(jir.LayerIR(nm, m, n) for nm, m, n in layers)),
        policy=policy, tile_budget=budget)
    eng = engine_lib.get_engine("tiled", plan=tplan)
    jeng = jengine.get_engine("tiled", plan=jplan)
    rng = np.random.default_rng(len(policy) + (budget or 0))
    for m, n in [(300, 513), (130, 260), (70, 20)]:
        a, w = _signs(rng, (5, m)), _signs(rng, (m, n))
        pw = eng.prepare(torch.from_numpy(w))
        assert pw.aux == jeng.prepare(jnp.asarray(w)).aux
        got = eng.binary_vmm(torch.from_numpy(a), pw)
        assert np.array_equal(got.numpy(), a @ w)
        assert _same(got, jeng.binary_vmm(jnp.asarray(a), jnp.asarray(w)))
        assert eng.steps_for(m, n, 8) == jeng.steps_for(m, n, 8)
    assert eng.cache_stats()["adhoc_placements"]["size"] == 1
    assert set(eng.cache_stats()) == set(jeng.cache_stats())


def test_tiled_builds_its_index_tensors_once_per_shape_and_device():
    eng = engine_lib.get_engine("tiled")
    rng = np.random.default_rng(0)
    w = torch.from_numpy(_signs(rng, (300, 513)))
    pw = eng.prepare(w)
    for _ in range(3):
        eng.binary_vmm(torch.from_numpy(_signs(rng, (2, 300))), pw)
    assert eng._device_indices.misses == 1 and eng._device_indices.hits == 2
    assert eng.cache_stats()["placement_indices"]["misses"] == 1
    with pytest.raises(ValueError, match="re-run prepare"):
        engine_lib.get_engine("tiled", dataclasses.replace(crossbar.EPCM_TILE, rows=128)
                              ).binary_vmm(torch.ones((1, 300)), pw)


@pytest.mark.parametrize("name", SIMULATORS)
def test_grouped_engine_ragged_tails(name):
    rng = np.random.default_rng(5)
    a, w = _signs(rng, (7, 70)), _signs(rng, (70, 11))
    grouped = engine_lib.GroupedEngine(engine_lib.get_engine(name), 3)
    jgrouped = jengine.GroupedEngine(jengine.get_engine(name), 3)
    got = grouped.binary_vmm(torch.from_numpy(a), torch.from_numpy(w))
    assert np.array_equal(got.numpy(), a @ w)
    assert grouped.steps_for(70, 11, 7) == jgrouped.steps_for(70, 11, 7)


# -- the compiler's map stage and its errors ---------------------------------


def _errors(make):
    """The exception class name ``make`` raises (``None`` if it does not)."""
    try:
        make()
    except ValueError as e:
        return type(e).__name__
    return None


def test_target_validation_names_the_same_errors_as_jax():
    cases = [
        dict(engine="wdm", mapping_policy="tacitmap"),
        dict(engine="tiled", mapping_policy="nope"),
        dict(engine="tiled", tile_budget=0),
        dict(engine="tacitmap", tile_budget=4),
        dict(engine="packed", spare_tiles=2),
        dict(engine="tiled", spare_tiles=-1),
        dict(engine="wdm", mesh_axis="model"),
        dict(engine="tiled", mesh_axis="model"),
        dict(engine="tiled", mapping_policy="greedy", tile_budget=8, spare_tiles=1),
        dict(engine="custbinarymap", fused=False),
    ]
    for kw in cases:
        got = _errors(lambda: compiler.HardwareTarget(**kw).validate())
        want = _errors(lambda: jax_compiler.HardwareTarget(**kw).validate())
        assert got == want, kw
        if got is None:
            assert (compiler.HardwareTarget(**kw).describe()
                    == jax_compiler.HardwareTarget(**kw).describe())


def test_compile_map_stage_errors_and_span():
    arch = "tinyllama-1.1b"
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    plan = mapping.compile_plan(cfg, spec=crossbar.OPCM_TILE, policy="greedy", tile_budget=5)
    jplan = jax_mapping.compile_plan(jcfg, spec=jcrossbar.OPCM_TILE, policy="greedy",
                                     tile_budget=5)

    def both(target_kw, bind_plan=True):
        got = _errors(lambda: compiler.compile(cfg, None, compiler.HardwareTarget(**target_kw),
                                               plan=plan if bind_plan else None, device="cpu"))
        want = _errors(lambda: jax_compiler.compile(
            jcfg, None, jax_compiler.HardwareTarget(**target_kw),
            plan=jplan if bind_plan else None))
        assert got == want, target_kw
        return got

    assert both(dict(engine="wdm")) == "PlanEngineMismatchError"
    assert both(dict(engine="tiled", mapping_policy="tacitmap")) == "TargetError"
    assert both(dict(engine="tiled", tile_budget=6)) == "TargetError"
    assert both(dict(engine="tiled", group_size=17)) == "GroupSizeError"
    assert both(dict(engine="wdm", group_size=17), bind_plan=False) == "GroupSizeError"
    assert both(dict(engine="tiled", group_size=16)) is None
    with obs.session() as tel:
        cm = compiler.compile(cfg, None, compiler.HardwareTarget(engine="tiled"), plan=plan,
                              device="cpu")
    (sp,) = tel.tracer.spans("compile.map")
    assert sp.attrs == {"policy": "greedy", "n_tiles": 5}
    assert cm.plan is plan and cm.engine.plan is plan and cm.cfg.mapping_policy == "greedy"
    assert cm.group_size_for(8) == 8 and cm.group_size_for(32) == 16


def test_spec_mismatch_is_named():
    cfg = get_smoke_config("tinyllama-1.1b")
    plan = mapping.compile_plan(cfg, spec=crossbar.OPCM_TILE)
    with pytest.raises(compiler.SpecMismatchError):
        compiler.compile(cfg, None, compiler.HardwareTarget(
            engine="tiled", spec=crossbar.EPCM_TILE), plan=plan, device="cpu")


# -- whole smoke models ------------------------------------------------------

TARGETS = {
    "tacitmap": {},
    "wdm": {},
    "tiled": {"mapping_policy": "tacitmap"},
    "custbinarymap": {},
}


@pytest.fixture(scope="module")
def packed_tokens():
    jcfg, jparams, cfg, model = pair("tinyllama-1.1b", seed=1)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 12))
    got, _ = port_steps(cfg, model, compiler.HardwareTarget(engine="packed"), tokens, 8)
    return (jcfg, jparams, cfg, model, tokens), got


@pytest.mark.parametrize("engine", sorted(TARGETS))
def test_smoke_generations_equal_jax_engines_and_packed(engine, packed_tokens):
    """8 greedy tokens through both packages' compiled models on one
    simulator engine (JAX op by op), and the port's packed engine."""
    (jcfg, jparams, cfg, model, tokens), packed = packed_tokens
    kw = TARGETS[engine]
    want, want_logits = jax_steps(jcfg, jparams, jax_compiler.HardwareTarget(engine=engine, **kw),
                                  tokens, 8)
    got, got_logits = port_steps(cfg, model, compiler.HardwareTarget(engine=engine, **kw),
                                 tokens, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, packed)
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("engine", sorted(TARGETS))
def test_prefill_logits_equal_reference_engine_and_batched_equals_alone(engine):
    """Inside the port: each simulator's prefill logits and caches equal
    the reference engine's bit for bit, prepared and raw, and a batch of
    4 prompts (K = 4 for wdm, a plan's K for tiled) gives each row the
    bits it gets alone."""
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), quant="bnn")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 9)))
    ref = compiler.compile(cfg, params, compiler.HardwareTarget(), device="cpu")
    want_logits, want_caches = ref.prefill(tokens)
    for prepared in (True, False):
        cm = compiler.compile(cfg, params, compiler.HardwareTarget(
            engine=engine, prepare_weights=prepared, **TARGETS[engine]), device="cpu")
        logits, caches = cm.prefill(tokens)
        assert torch.equal(logits, want_logits)
        for slot, kv in want_caches.items():
            for key, t in kv.items():
                assert torch.equal(caches[slot][key], t)
    assert cm.group_size_for(4) == 4  # one group spans the batch; K = 1 alone
    for i in range(4):
        alone, _ = cm.prefill(tokens[i : i + 1])
        assert torch.equal(alone[0], logits[i])


def test_wdm_groups_k_slots_per_step_in_serving():
    """The wdm engine's K (16 on oPCM, clamped to the pool) drives the
    serving engine's grouping: 4 slots are one group of 4."""
    cfg = get_smoke_config("tinyllama-1.1b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    cm = compiler.compile(cfg, params, compiler.HardwareTarget(engine="wdm"), device="cpu")
    se = cm.serve(max_batch=4, max_len=24)
    assert se.group_k == 4
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    states = [se.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 6 + i)
                                .astype(np.int32), max_new_tokens=5)) for i in range(6)]
    se.drain()
    for st in states:
        one = cm.serve(max_batch=1, max_len=24)
        alone = one.submit(st.request)
        one.drain()
        assert tuple(alone.generated) == tuple(st.generated)

"""Fault injection in the port against the JAX package: the ``FaultModel``
masks and errors, ``FaultyEngine`` on every wrapped engine (null model
bit-identical, corruption equal to an independently assembled delta and
to the JAX wrapper's output, probes, ``locate``, drift, dead lanes,
refresh), the target's ``fault_model`` field, the CLI flags, and the
compiled model's sweep / refresh / remap round trip.

Everything is compared for exact equality: fault masks are numpy draws
from the same per-tile streams, and every engine output is an integer.
"""

import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jax_compiler
from repro import faults as jax_faults
from repro.core import engine as jengine
from repro.core.crossbar import EPCM_TILE as JAX_EPCM_TILE
from repro_torch import compiler, obs
from repro_torch.core import bnn
from repro_torch.core import engine as engine_lib
from repro_torch.core.crossbar import EPCM_TILE
from repro_torch.faults import (
    CELL_DATA_ENGINES,
    FaultInjectionError,
    FaultMap,
    FaultModel,
    FaultModelError,
    FaultyEngine,
)
from repro_torch.models import lm
from test_torch_generate import pair

torch.set_num_threads(1)

# 16x16 tiles: a (2*16, 40) cell matrix spans 2 x 3 tiles, the last
# column block ragged
SMALL = dataclasses.replace(EPCM_TILE, rows=16, cols=16)
JAX_SMALL = dataclasses.replace(JAX_EPCM_TILE, rows=16, cols=16)
WRAPPED = ["reference", "tacitmap", "wdm", "packed", "tiled", "custbinarymap"]
RATES = {"seed": 5, "stuck_set_rate": 0.05, "stuck_reset_rate": 0.05}


def _signs(rng, shape):
    return rng.choice(np.array([-1.0, 1.0], np.float32), size=shape)


def _equal(got: torch.Tensor, want) -> bool:
    """Same shape, same values and the same dtype as the JAX output."""
    want = np.asarray(want)
    return (got.shape == want.shape and str(got.dtype).removeprefix("torch.") == str(want.dtype)
            and np.array_equal(got.numpy(), want))


def _pair_engines(name, model_kw, spec=True):
    port = FaultyEngine(engine_lib.get_engine(name, SMALL if spec else None), FaultModel(**model_kw))
    ref = jax_faults.FaultyEngine(jengine.get_engine(name, JAX_SMALL if spec else None),
                                  jax_faults.FaultModel(**model_kw))
    return port, ref


# ---------------------------------------------------------------------------
# FaultModel / FaultMap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,tile,rows,cols,epoch,failed", [
    (dict(seed=7, stuck_set_rate=0.1, stuck_reset_rate=0.1), 3, 32, 32, 0, None),
    (dict(seed=7, stuck_set_rate=0.1, stuck_reset_rate=0.1), 4, 256, 256, 0, None),
    (dict(seed=1, stuck_reset_rate=0.05, drift_rate=0.2), 0, 64, 48, 3, None),
    (dict(seed=2, stuck_set_rate=0.3), 9, 16, 16, 0, True),
    (dict(seed=3, failed_tiles=(2,)), 2, 8, 8, 0, None),
    (dict(), 0, 8, 8, 5, False),
])
def test_tile_masks_equal_the_reference(kw, tile, rows, cols, epoch, failed):
    got = FaultModel(**kw).tile_cell_masks(tile, rows, cols, epoch, failed=failed)
    want = jax_faults.FaultModel(**kw).tile_cell_masks(tile, rows, cols, epoch, failed=failed)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == bool and np.array_equal(g, w)
    assert not (got[0] & got[1]).any()  # SET wins ties


@pytest.mark.parametrize("bad", [
    dict(seed=-1), dict(stuck_set_rate=-0.1), dict(stuck_set_rate=1.5),
    dict(stuck_set_rate=0.6, stuck_reset_rate=0.6), dict(drift_rate=-1e-3),
    dict(dead_lanes=(-1,)), dict(failed_tiles=(-2,)),
])
def test_model_validation_equals_the_reference(bad):
    with pytest.raises(FaultModelError) as got:
        FaultModel(**bad).validate()
    with pytest.raises(jax_faults.FaultModelError) as want:
        jax_faults.FaultModel(**bad).validate()
    assert str(got.value) == str(want.value)


def test_model_flags_describe_and_fault_map_equal_the_reference():
    for kw in (dict(), dict(dead_lanes=(0,)), dict(failed_tiles=(1, 4)),
               dict(seed=3, stuck_set_rate=1e-3, drift_rate=0.5)):
        a, b = FaultModel(**kw), jax_faults.FaultModel(**kw)
        assert (a.is_null, a.cell_pristine, a.describe(), a.reset_fraction(4)) == (
            b.is_null, b.cell_pristine, b.describe(), b.reset_fraction(4))
    u = FaultMap(tiles=(1,)).union(FaultMap(lanes=(0,)))
    ju = jax_faults.FaultMap(tiles=(1,)).union(jax_faults.FaultMap(lanes=(0,)))
    assert (bool(FaultMap()), bool(u), u.tiles, u.lanes, u.describe()) == (
        bool(jax_faults.FaultMap()), bool(ju), ju.tiles, ju.lanes, ju.describe())
    assert CELL_DATA_ENGINES == jax_faults.CELL_DATA_ENGINES


# ---------------------------------------------------------------------------
# FaultyEngine
# ---------------------------------------------------------------------------


def test_wrap_guards():
    base = engine_lib.get_engine("tacitmap")
    with pytest.raises(FaultInjectionError):
        FaultyEngine(FaultyEngine(base, FaultModel()), FaultModel())
    with pytest.raises(FaultInjectionError):
        FaultyEngine(engine_lib.GroupedEngine(base, 2), FaultModel())
    eng = FaultyEngine(base, FaultModel())
    assert not hasattr(eng, "base") and eng.inner is base and eng.name == "tacitmap"


@pytest.mark.parametrize("name", ["tacitmap", "wdm", "packed", "custbinarymap"])
def test_null_model_bit_identical(name):
    """Zero-fault wrapping is a no-op on every backend, packed included
    (no delta is built while pristine)."""
    rng = np.random.default_rng(0)
    w, a, g = (torch.from_numpy(_signs(rng, s)) for s in ((16, 24), (3, 16), (2, 4, 16)))
    plain = engine_lib.get_engine(name)
    faulty = FaultyEngine(engine_lib.get_engine(name), FaultModel())
    pw = faulty.prepare(w)
    assert pw.data[1] is None
    assert torch.equal(faulty.binary_vmm(a, pw), plain.binary_vmm(a, plain.prepare(w)))
    assert torch.equal(faulty.binary_mmm(g, pw), plain.binary_mmm(g, plain.prepare(w)))


@pytest.mark.parametrize("name", WRAPPED)
def test_corruption_equals_the_reference_and_the_assembled_delta(name):
    """out_faulty == out_clean + 2 * (complement_drive @ D) with D =
    SET*(1-C) - RESET*C assembled independently here from the per-tile
    masks, and == the JAX wrapper's output in value and dtype
    (vmm and mmm, raw and prepared weights)."""
    rng = np.random.default_rng(1)
    m, n = 16, 40
    w, a, g = _signs(rng, (m, n)), _signs(rng, (3, m)), _signs(rng, (2, 4, m))
    tw, ta, tg = (torch.from_numpy(x) for x in (w, a, g))
    port, ref = _pair_engines(name, RATES)
    pw = port.prepare(tw)
    got = port.binary_vmm(ta, pw)
    assert _equal(got, ref.binary_vmm(jnp.asarray(a), ref.prepare(jnp.asarray(w))))
    assert torch.equal(port.binary_vmm(ta, tw), got)
    assert _equal(port.binary_mmm(tg, pw), ref.binary_mmm(jnp.asarray(g), jnp.asarray(w)))

    set_m = np.zeros((2 * m, n), bool)
    reset_m = np.zeros((2 * m, n), bool)
    R, C = SMALL.rows, SMALL.cols
    fm = FaultModel(**RATES)
    for rb, cb, ru, cu, tile in port._placement_blocks(m, n):
        s, r = fm.tile_cell_masks(tile, R, C)
        set_m[rb * R:rb * R + ru, cb * C:cb * C + cu] |= s[:ru, :cu]
        reset_m[rb * R:rb * R + ru, cb * C:cb * C + cu] |= r[:ru, :cu]
    bits = (w + 1) / 2
    cells = np.concatenate([bits, 1 - bits], axis=0)
    d = set_m * (1.0 - cells) - reset_m * cells
    assert np.array_equal(pw.data[1].numpy(), d)
    drive = np.concatenate([(a + 1) / 2, (1 - a) / 2], axis=-1)
    clean = engine_lib.get_engine(name, SMALL).binary_vmm(ta, tw).numpy()
    assert np.array_equal(got.numpy(), clean + (2.0 * (drive @ d)).astype(clean.dtype))


@pytest.mark.parametrize("name", WRAPPED)
def test_probes_and_locate_equal_the_reference(name):
    """The cheap probe (reduced on the device) equals the executed one and
    the JAX wrapper's, a sequence of artifacts reduces as the reference's
    stacked artifact, and ``locate`` names the JAX wrapper's tiles."""
    rng = np.random.default_rng(2)
    ws = [_signs(rng, (16, 40)) for _ in range(3)]
    port, ref = _pair_engines(name, dict(seed=3, stuck_set_rate=0.03, stuck_reset_rate=0.03))
    pws = [port.prepare(torch.from_numpy(w)) for w in ws]
    jpw = ref.prepare(jnp.asarray(ws[0]))
    cheap = port.consistency_probe(pws[0])
    assert cheap.dtype == np.float64 and cheap.max() > 0
    assert np.array_equal(cheap, port.consistency_probe(pws[0], execute=True))
    assert np.array_equal(cheap, ref.consistency_probe(jpw))
    assert np.array_equal(cheap, ref.consistency_probe(jpw, execute=True))
    assert port.locate(pws[0]) == ref.locate(jpw) != frozenset()
    if name in ("reference", "tacitmap", "wdm", "custbinarymap"):
        # the reference's stacked (L, ...) artifact of the three layers
        stacked = ref.prepare(jengine.PreparedWeights(
            engine=name, m=16, n=40, aux=None,
            data=jnp.stack([ref.inner.prepare(jnp.asarray(w)).data for w in ws])))
        assert np.array_equal(port.consistency_probe(pws), ref.consistency_probe(stacked))
        assert port.locate(pws) == ref.locate(stacked)


def test_probe_silent_when_pristine():
    eng = FaultyEngine(engine_lib.get_engine("tacitmap", SMALL), FaultModel())
    pw = eng.prepare(torch.from_numpy(_signs(np.random.default_rng(2), (16, 32))))
    assert eng.consistency_probe(pw).max() == 0.0
    assert eng.consistency_probe(pw, execute=True).max() == 0.0
    assert eng.locate(pw) == frozenset()


@pytest.mark.parametrize("name", ["tacitmap", "tiled", "custbinarymap", "reference"])
def test_fail_tile_refresh_and_locate_equal_the_reference(name):
    """A runtime tile failure observed through ``refresh`` (cell data
    recovered from the artifact, padding cut) names that tile and
    corrupts as the JAX wrapper does."""
    rng = np.random.default_rng(3)
    w, a = _signs(rng, (16, 40)), _signs(rng, (5, 16))
    port, ref = _pair_engines(name, {})
    pw, jpw = port.prepare(torch.from_numpy(w)), ref.prepare(jnp.asarray(w))
    assert port.pristine
    port.fail_tile(3)
    ref.fail_tile(3)
    assert not port.pristine and port.failed_tiles() == frozenset({3})
    pw, jpw = port.refresh(pw), ref.refresh(jpw)
    assert port.locate(pw) == ref.locate(jpw) == frozenset({3})
    assert _equal(port.binary_vmm(torch.from_numpy(a), pw), ref.binary_vmm(jnp.asarray(a), jpw))
    assert port.rebind(engine_lib.get_engine(name, SMALL)).failed_tiles() == frozenset({3})


def test_packed_artifact_cannot_be_refreshed():
    eng = FaultyEngine(engine_lib.get_engine("packed", SMALL), FaultModel())
    pw = eng.prepare(torch.from_numpy(_signs(np.random.default_rng(4), (16, 32))))
    eng.fail_tile(0)
    with pytest.raises(FaultInjectionError, match="bit-packed"):
        eng.refresh(pw)


def test_fused_dense_only_while_pristine():
    rng = np.random.default_rng(5)
    w, x = torch.from_numpy(_signs(rng, (64, 24))), torch.randn(3, 64)
    eng = FaultyEngine(engine_lib.get_engine("packed"), FaultModel())
    plain = engine_lib.get_engine("packed")
    alpha = torch.tensor(0.5)
    assert eng.supports_fused_dense
    assert torch.equal(eng.fused_dense(x, eng.prepare(w), alpha),
                       plain.fused_dense(x, plain.prepare(w), alpha))
    eng.fail_tile(0)
    assert not eng.supports_fused_dense
    with pytest.raises(FaultInjectionError, match="injection seam"):
        eng.fused_dense(x, eng.prepare(w), alpha)


@pytest.mark.parametrize("epochs", [0, 1, 3])
def test_drift_equals_the_reference_and_fires_the_probe(epochs):
    rng = np.random.default_rng(4)
    w = _signs(rng, (16, 32))
    port, ref = _pair_engines("tacitmap", dict(seed=9, drift_rate=0.5))
    with pytest.raises(ValueError):
        port.advance_drift(-1)
    port.advance_drift(epochs)
    ref.advance_drift(epochs)
    got = port.consistency_probe(port.prepare(torch.from_numpy(w)))
    assert np.array_equal(got, ref.consistency_probe(ref.prepare(jnp.asarray(w))))
    assert (got.max() > 0) == (epochs > 0)
    tiles = range(8)
    assert [port.tile_is_clean(t) for t in tiles] == [ref.tile_is_clean(t) for t in tiles]


def test_dead_lanes_shrink_effective_k():
    eng = FaultyEngine(engine_lib.get_engine("wdm"), FaultModel())
    ref = jax_faults.FaultyEngine(jengine.get_engine("wdm"), jax_faults.FaultModel())
    k0 = eng.inner.preferred_group_size()
    assert k0 > 1 and eng.effective_group_cap() == k0
    for lane in (0, 2):
        eng.fail_lane(lane)
        ref.fail_lane(lane)
    assert eng.effective_group_cap() == ref.effective_group_cap() == k0 - 2
    assert eng.preferred_group_size() == k0 - 2
    assert FaultyEngine(engine_lib.get_engine("packed"), FaultModel()).effective_group_cap() is None


def test_masks_move_to_the_device_once_per_key():
    eng = FaultyEngine(engine_lib.get_engine("tacitmap", SMALL), FaultModel(**RATES))
    rng = np.random.default_rng(6)
    for _ in range(3):
        eng.prepare(torch.from_numpy(_signs(rng, (16, 40))))
    assert len(eng._device_masks) == 1 and len(eng._mask_cache) == 1
    eng.advance_drift(1)
    eng.prepare(torch.from_numpy(_signs(rng, (16, 40))))
    assert len(eng._device_masks) == 2


# ---------------------------------------------------------------------------
# target, CLI, compiled model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(engine="tacitmap", fault_model=FaultModel(seed=-1)),
    dict(engine="reference", fault_model=FaultModel()),
    dict(engine="packed", fault_model=FaultModel(stuck_set_rate=2.0)),
])
def test_target_validation_equals_the_reference(kw):
    jkw = dict(kw, fault_model=jax_faults.FaultModel(**dataclasses.asdict(kw["fault_model"])))
    with pytest.raises(compiler.TargetError, match="fault_model") as got:
        compiler.HardwareTarget(**kw).validate()
    with pytest.raises(jax_compiler.TargetError) as want:
        jax_compiler.HardwareTarget(**jkw).validate()
    if kw["engine"] != "reference":  # the plain path is named per package
        assert str(got.value) == str(want.value)


def test_target_describe_equals_the_reference():
    kw = dict(engine="tiled", mapping_policy="tacitmap", spare_tiles=2)
    fm = dict(failed_tiles=(1,), stuck_set_rate=1e-3, dead_lanes=(0,))
    d = compiler.HardwareTarget(**kw, fault_model=FaultModel(**fm)).describe()
    assert d == jax_compiler.HardwareTarget(**kw, fault_model=jax_faults.FaultModel(**fm)).describe()
    assert "spares=2" in d and "failed_tiles=[1]" in d


@pytest.mark.parametrize("argv", [
    ["--engine", "tacitmap", "--fault-rate", "0.002", "--fault-seed", "7"],
    ["--engine", "tiled", "--mapping-policy", "greedy", "--spare-tiles", "2", "--fault-rate", "0"],
    ["--engine", "packed"],
])
def test_cli_fault_flags_equal_the_reference(argv):
    ap, jap = argparse.ArgumentParser(), argparse.ArgumentParser()
    compiler.add_target_args(ap)
    jax_compiler.add_target_args(jap)
    got = compiler.target_from_args(ap.parse_args(argv))
    want = jax_compiler.target_from_args(jap.parse_args(argv))
    if want.fault_model is None:
        assert got.fault_model is None
    else:
        assert dataclasses.asdict(got.fault_model) == dataclasses.asdict(want.fault_model)
    assert got.describe() == want.describe()


@pytest.fixture(scope="module")
def smoke():
    jcfg, jparams, cfg, model = pair("tinyllama-1.1b")
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, (1, 9))
    return jcfg, jparams, cfg, model, tokens


def _tiled(spares=3, fault_model=None):
    return dict(engine="tiled", mapping_policy="tacitmap", spare_tiles=spares,
                fault_model=fault_model)


def test_null_injection_compiled_bit_identical(smoke):
    _, _, cfg, model, tokens = smoke
    for engine in ("tiled", "packed", "wdm"):
        kw = _tiled() if engine == "tiled" else dict(engine=engine)
        clean = compiler.compile(cfg, model, compiler.HardwareTarget(**kw), device="cpu")
        faulty = compiler.compile(
            cfg, model, compiler.HardwareTarget(**{**kw, "fault_model": FaultModel()}), device="cpu")
        assert torch.equal(clean.prefill(tokens)[0], faulty.prefill(tokens)[0])
        assert faulty.scan_faults() == FaultMap() and not faulty.scan_faults()


def test_remap_round_trip_equals_the_reference(smoke):
    """Fail a resident tile, refresh: the logits move and the sweep names
    the tile; remap: the same moves, cost and spares as the JAX
    package's remap, the logits restored bit for bit and a clean sweep;
    the artifact count is per block here (7 per layer) where the
    reference stacks each projection over its layers (7)."""
    jcfg, jparams, cfg, model, tokens = smoke
    clean = compiler.compile(cfg, model, compiler.HardwareTarget(**_tiled()), device="cpu")
    want_logits = clean.prefill(tokens)[0]
    cm = compiler.compile(cfg, model, compiler.HardwareTarget(**_tiled(fault_model=FaultModel())),
                          device="cpu")
    jcm = jax_compiler.compile(jcfg, jparams, jax_compiler.HardwareTarget(
        **_tiled(fault_model=jax_faults.FaultModel())))
    assert len(cm._fault_artifacts()) == 7 * cfg.n_layers and len(jcm._fault_artifacts()) == 7
    victim = min(t for pw in cm._fault_artifacts() for *_, t in cm.engine._placement_blocks(pw.m, pw.n))
    for c in (cm, jcm):
        c.engine.fail_tile(victim)
        c.refresh_faults()
    assert not torch.equal(cm.prefill(tokens)[0], want_logits)
    with obs.session() as tel:
        sweep = cm.scan_faults()
        report = cm.remap(sweep)
    jsweep = jcm.scan_faults()
    jreport = jcm.remap(jsweep)
    assert sweep.tiles == jsweep.tiles == {victim} and sweep.lanes == jsweep.lanes
    # the two packages' dataclasses compare field by field
    fields = dataclasses.astuple
    assert [fields(mv) for mv in report.moves] == [fields(mv) for mv in jreport.moves]
    assert len(report.moves) >= 1 and all(mv.src == victim for mv in report.moves)
    assert fields(report.cost) == fields(jreport.cost) and report.cost.cells > 0
    assert (report.spares_left, report.failed_tiles) == (jreport.spares_left, jreport.failed_tiles)
    assert cm.plan.avoid_tiles == jcm.plan.avoid_tiles
    assert torch.equal(cm.prefill(tokens)[0], want_logits)
    assert not cm.scan_faults().tiles and not jcm.scan_faults().tiles
    m = tel.metrics
    assert m.counter("repro_faults_detected_total").value == 1
    assert m.counter("repro_remaps_total").value == 1
    assert [s.name for s in tel.tracer.spans()] == ["remap"]


def test_remap_without_plan_or_wrapper_raises(smoke):
    _, _, cfg, model, _ = smoke
    plain = compiler.compile(cfg, model, compiler.HardwareTarget(**_tiled()), device="cpu")
    with pytest.raises(compiler.TargetError):
        plain.remap(FaultMap(tiles=(0,)))
    with pytest.raises(compiler.TargetError):
        plain.refresh_faults()
    no_plan = compiler.compile(
        cfg, model, compiler.HardwareTarget(engine="tacitmap", fault_model=FaultModel()),
        device="cpu")
    with pytest.raises(compiler.TargetError):
        no_plan.remap(FaultMap(tiles=(0,)))


def test_packed_faults_run_the_hamming_path(smoke):
    """Stuck cells on packed equal tacitmap under the same model (both
    ePCM 256x256 by default); the faulty model programs no fused [q|k|v]
    artifact and ``supports_fused_dense`` is off."""
    _, _, cfg, model, tokens = smoke
    fm = FaultModel(seed=0, stuck_set_rate=0.02, stuck_reset_rate=0.02)
    outs = {}
    for engine in ("packed", "tacitmap"):
        cm = compiler.compile(cfg, model, compiler.HardwareTarget(engine=engine, fault_model=fm),
                              device="cpu")
        outs[engine] = cm.prefill(tokens)[0]
        assert not cm.engine.supports_fused_dense
        assert all(name.split(".")[-1] != "qkv" for name, _ in lm.programmed_projections(cm.params))
    plain = compiler.compile(cfg, model, compiler.HardwareTarget(engine="packed"), device="cpu")
    assert torch.equal(outs["packed"], outs["tacitmap"])
    assert not torch.equal(outs["packed"], plain.prefill(tokens)[0])
    pristine = compiler.compile(
        cfg, model, compiler.HardwareTarget(engine="packed", fault_model=FaultModel()), device="cpu")
    assert any(name.endswith(".qkv") for name, _ in lm.programmed_projections(pristine.params))


def test_compiled_group_size_respects_dead_lanes(smoke):
    jcfg, jparams, cfg, model, _ = smoke
    fm = dict(dead_lanes=(0, 1))
    cm = compiler.compile(cfg, model, compiler.HardwareTarget(
        engine="wdm", fault_model=FaultModel(**fm)), device="cpu")
    plain = compiler.compile(cfg, model, compiler.HardwareTarget(engine="wdm"), device="cpu")
    jcm = jax_compiler.compile(jcfg, None, jax_compiler.HardwareTarget(
        engine="wdm", fault_model=jax_faults.FaultModel(**fm)))
    for batch in (1, 3, 32):
        assert cm.group_size_for(batch) == jcm.group_size_for(batch)
    assert cm.group_size_for(32) == plain.group_size_for(32) - 2


def test_bnn_cells_of_signs_match_the_reference():
    """The complement-stacked cells the wrapper derives from signs."""
    rng = np.random.default_rng(7)
    w = _signs(rng, (5, 3))
    from repro.faults.engine import _cells_from_signs as jax_cells

    from repro_torch.faults.engine import _cells_from_signs

    got = _cells_from_signs(torch.from_numpy(w))
    assert np.array_equal(got.numpy(), np.asarray(jax_cells(jnp.asarray(w))))
    assert torch.equal(got, bnn.stack_complement_weights(bnn.signs_to_bits(torch.from_numpy(w))))

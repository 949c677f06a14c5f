"""The port's cost model against the JAX package's: ``evaluate_all`` and
``speedup_over_baseline`` for every network of the paper, the Fig. 7/8
summaries of the reference's ``benchmarks/paper_latency.py`` and
``paper_energy.py`` (their ``run()``, read-only, fed the port's cost
model), the programming and decode-tick prices, ``CompiledModel.price()``
and ``describe()``, ``FleetEngine.price()`` and the telemetry
crosscheck's modeled fields on the same spans. The model is
framework-free arithmetic: every number is compared with ``==``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import paper_energy, paper_latency
from repro import compiler as jax_compiler
from repro import mapping as jmapping
from repro import obs as jax_obs
from repro.configs import get_config as jax_config
from repro.core import costmodel as jcm
from repro.core import crossbar as jcrossbar
from repro.core import networks as jnetworks
from repro.fleet import FleetEngine as JaxFleetEngine
from repro.fleet import Replica as JaxReplica
from repro_torch import compiler, mapping, obs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import costmodel as cm
from repro_torch.core import crossbar, networks
from repro_torch.fleet import FleetEngine, Replica
from test_torch_generate import pair
from test_torch_mapping import _data

torch.set_num_threads(1)

NETS = sorted(networks.NETWORKS)


@pytest.mark.parametrize("net", NETS)
def test_evaluate_all_and_speedups_equal_jax(net):
    tnet, jnet = networks.NETWORKS[net], jnetworks.NETWORKS[net]
    assert cm.evaluate_all(tnet) == jcm.evaluate_all(jnet)
    assert cm.speedup_over_baseline(tnet) == jcm.speedup_over_baseline(jnet)
    for tp, jp in ((cm.BASELINE_EPCM, jcm.BASELINE_EPCM), (cm.TACITMAP_EPCM, jcm.TACITMAP_EPCM),
                   (cm.EINSTEINBARRIER, jcm.EINSTEINBARRIER)):
        for tl, jl in zip(tnet.layers, jnet.layers):
            assert cm.layer_steps(tp, tl) == jcm.layer_steps(jp, jl)
            assert cm.layer_energy_pj(tp, tl) == jcm.layer_energy_pj(jp, jl)
            if tl.binary:
                assert cm.programming_break_even_ticks(tp, tl, 8) == \
                    jcm.programming_break_even_ticks(jp, jl, 8)
        assert _data(cm.network_programming_cost(tp, tnet)) == _data(
            jcm.network_programming_cost(jp, jnet))
        assert cm.transmitter_power_mw(tp) == jcm.transmitter_power_mw(jp)
    assert cm.gpu_network_energy_j(cm.BASELINE_GPU, tnet) == jcm.gpu_network_energy_j(
        jcm.BASELINE_GPU, jnet)


@pytest.mark.parametrize("bench", [paper_latency, paper_energy], ids=["fig7", "fig8"])
def test_paper_figure_summaries_equal_jax(bench, monkeypatch):
    """The reference's Fig. 7 / Fig. 8 ``run()`` as it is, then again on
    the port's cost model and networks: rows, summary and checks equal."""
    want = bench.run()
    monkeypatch.setattr(bench, "cm", cm)
    monkeypatch.setattr(bench, "NETWORKS", networks.NETWORKS)
    got = bench.run()
    assert got == want
    assert all(want["checks"].values())


@pytest.mark.parametrize("k", [1, 4, 16])
def test_grouped_decode_prices_equal_jax(k):
    spec, jspec = (crossbar.OPCM_TILE, jcrossbar.OPCM_TILE)
    tp, jp = cm.params_for_spec(spec), jcm.params_for_spec(jspec)
    assert _data(tp) == _data(jp)
    layer, jlayer = networks.NETWORKS["MLP-L"].layers[1], jnetworks.NETWORKS["MLP-L"].layers[1]
    tk, jk = (dataclasses.replace(p, tile=dataclasses.replace(p.tile, wdm_k=k)) for p in (tp, jp))
    assert _data(cm.grouped_decode_tick(tk, layer, 16)) == _data(
        jcm.grouped_decode_tick(jk, jlayer, 16))
    assert _data(cm.grouped_decode_sweep(tp, layer, 16, (1, 2, k))) == _data(
        jcm.grouped_decode_sweep(jp, jlayer, 16, (1, 2, k)))
    plan = mapping.compile_plan(get_config("qwen1.5-0.5b"), spec=spec, policy="greedy",
                                tile_budget=2000)
    jplan = jmapping.compile_plan(jax_config("qwen1.5-0.5b"), spec=jspec, policy="greedy",
                                  tile_budget=2000)
    for n_active in (1, 5, 16):
        assert _data(cm.plan_decode_tick(plan, n_active, params=tk)) == _data(
            jcm.plan_decode_tick(jplan, n_active, params=jk))
        assert _data(cm.scheduled_decode_tick(plan, n_active, 16)) == _data(
            jcm.scheduled_decode_tick(jplan, n_active, 16))
    assert _data(cm.plan_programming_cost(plan)) == _data(jcm.plan_programming_cost(jplan))
    assert _data(cm.price_plan(plan, batch=k)) == _data(jcm.price_plan(jplan, batch=k))


def _price_fields(price) -> dict:
    """A TargetPrice's fields, the target by its description line."""
    out = {f.name: getattr(price, f.name) for f in dataclasses.fields(price)}
    out["target"] = out["target"].describe()
    out["plan_cost"] = _data(out["plan_cost"])
    return out


TARGETS = [
    dict(engine="reference"),
    dict(engine="wdm"),
    dict(engine="tacitmap", spec="oPCM"),
    dict(engine="custbinarymap"),
    dict(engine="packed"),
    dict(engine="tiled", mapping_policy="greedy", tile_budget=3000),
    dict(engine="tiled", mapping_policy="column-major", spare_tiles=2, spec="oPCM"),
]


def _targets(kw):
    kw = dict(kw)
    tech = kw.pop("spec", None)
    spec = {"oPCM": (crossbar.OPCM_TILE, jcrossbar.OPCM_TILE), None: (None, None)}[tech]
    return (compiler.HardwareTarget(spec=spec[0], **kw),
            jax_compiler.HardwareTarget(spec=spec[1], **kw))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-0.5b"])
@pytest.mark.parametrize("kw", TARGETS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_compiled_price_and_describe_equal_jax(kw, arch):
    """Price-only compilations of the full-size configs (no parameters):
    ``price()`` at two widths equals JAX's field by field, and
    ``describe()`` equals it line for line."""
    target, jtarget = _targets(kw)
    got = compiler.compile(get_config(arch), None, target, device="cpu")
    want = jax_compiler.compile(jax_config(arch), None, jtarget)
    for n_active in (16, 5):
        assert _price_fields(got.price(n_active)) == _price_fields(want.price(n_active))
    assert got.price().summary() == want.price().summary()
    assert got.describe() == want.describe()
    assert _data(got.pricing_plan()) == _data(want.pricing_plan())
    assert got.group_size_for(8) == want.group_size_for(8)


def test_programmed_describe_differs_only_in_its_timing_line():
    jcfg, jparams, cfg, model = pair("tinyllama-1.1b")
    target, jtarget = _targets(dict(engine="tiled", mapping_policy="tacitmap"))
    got = compiler.compile(cfg, model, target, device="cpu").describe().splitlines()
    want = jax_compiler.compile(jcfg, jparams, jtarget).describe().splitlines()
    assert got[:-1] == want[:-1]
    assert got[-1].startswith("[program] 14 projection instance(s) resident in tiled form (")
    assert want[-1].startswith("[program] 14 projection instance(s) resident in tiled form (")


@pytest.fixture(scope="module")
def fleets():
    jcfg, jparams, cfg, model = pair("tinyllama-1.1b")
    target, jtarget = _targets(dict(engine="tiled", mapping_policy="greedy", tile_budget=7))
    cmod = compiler.compile(cfg, model, target, device="cpu")
    jmod = jax_compiler.compile(jcfg, jparams, jtarget)
    fleet = FleetEngine([Replica(r, cmod, max_batch=2, max_len=32) for r in range(3)])
    jfleet = JaxFleetEngine([JaxReplica(r, jmod, max_batch=2, max_len=32) for r in range(3)])
    return fleet, jfleet


@pytest.mark.parametrize("n_active", [16, 2])
def test_fleet_price_equals_jax(fleets, n_active):
    fleet, jfleet = fleets
    got, want = fleet.price(n_active), jfleet.price(n_active)
    fields = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == fields
    for name in fields:
        if name == "base":
            assert _price_fields(got.base) == _price_fields(want.base)
        else:
            assert getattr(got, name) == getattr(want, name), name
    assert got.summary() == want.summary()
    assert got.n_replicas == 3 and got.tiles_total == 3 * got.base.n_tiles


class FakeClock:
    """Deterministic ns clock: each read advances by ``step``."""

    def __init__(self, step: int):
        self.t = 0
        self.step = step

    def __call__(self) -> int:
        self.t += self.step
        return self.t


def _record_ticks(tracer, ticks):
    for engine, k, n_active in ticks:
        with tracer.span("decode_tick", track="serve", engine=engine, k=k, n_active=n_active):
            pass


def test_crosscheck_rows_equal_jax_on_the_same_spans():
    """The same decode_tick spans (engines, K, admitted widths) on two
    fake clocks: every TickCheck field equals JAX's, measured and
    modeled, and the report text is byte-equal."""
    rng = np.random.default_rng(0)
    ticks = [(e, k, int(rng.integers(1, 9))) for e, k in
             [("wdm", 8), ("wdm", 8), ("tiled", 1), ("wdm", 4), ("tiled", 1), ("wdm", 8)]]
    tr, jtr = obs.Tracer(clock=FakeClock(1234)), jax_obs.Tracer(clock=FakeClock(1234))
    _record_ticks(tr, ticks)
    _record_ticks(jtr, ticks)
    plan = mapping.compile_plan(get_config("tinyllama-1.1b"), spec=crossbar.OPCM_TILE)
    jplan = jmapping.compile_plan(jax_config("tinyllama-1.1b"), spec=jcrossbar.OPCM_TILE)
    rows = obs.crosscheck_ticks(tr, plan, pool=8)
    jrows = jax_obs.crosscheck_ticks(jtr, jplan, pool=8)
    assert [dataclasses.asdict(r) for r in rows] == [dataclasses.asdict(r) for r in jrows]
    assert [r.finite for r in rows] == [True] * 3
    assert obs.format_report(rows) == jax_obs.format_report(jrows)


def test_crosscheck_of_a_traced_serving_run():
    """A traced request run on the wdm engine: one row per (engine, K)
    priced on the compiled model's pricing plan, and the same numbers as
    ``crosscheck_ticks`` on that plan; without a session it raises."""
    cfg = get_smoke_config("tinyllama-1.1b")
    from repro_torch.models import lm
    from repro_torch.serving import Request

    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    cmod = compiler.compile(cfg, params, compiler.HardwareTarget(engine="wdm"), device="cpu")
    with pytest.raises(ValueError, match="no active telemetry session"):
        obs.crosscheck_serving(cmod.serve(max_batch=2, max_len=16))
    with obs.session() as tel:
        se = cmod.serve(max_batch=4, max_len=24)
        rng = np.random.default_rng(1)
        for i in range(5):
            se.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                              max_new_tokens=4))
        se.drain()
        rows = obs.crosscheck_serving(se)
    assert [(r.engine, r.k) for r in rows] == [("wdm", 4)]
    assert rows[0].ticks == len(tel.tracer.spans("decode_tick")) and rows[0].finite
    again = obs.crosscheck_ticks(tel.tracer, cmod.pricing_plan(), pool=4)
    assert rows == again
    assert cmod.pricing_plan().spec == crossbar.OPCM_TILE


def test_engines_built_by_the_cost_model_touch_no_device(monkeypatch):
    """``CIMParams.engine()`` constructs a registry backend for step
    counts only: no tensor is made and no CUDA call happens."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: calls.append("cuda") or False)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: calls.append("empty"))
    for params in (cm.BASELINE_EPCM, cm.TACITMAP_EPCM, cm.EINSTEINBARRIER):
        eng = params.engine()
        assert eng.name == params.engine_name
    assert calls == []
    assert cm.evaluate_all(networks.NETWORKS["CNN-S"]) == jcm.evaluate_all(
        jnetworks.NETWORKS["CNN-S"])

"""The port's mapping compiler against the JAX package's: ``compile_plan``
for the full-size tinyllama-1.1b and qwen1.5-0.5b configs (price-only,
no parameters) equals JAX's field by field under every policy, on both
tile specs, with and without a tile budget and with spares; the
schedule, the reports (byte for byte), the remap, and the LayerIR of
the paper's networks. All of it is framework-free arithmetic, so
equality is exact.
"""

import dataclasses

import pytest

from repro import mapping as jmapping
from repro.configs import get_config as jax_config
from repro.core import crossbar as jcrossbar
from repro.core import einsteinbarrier as jeb
from repro.core import networks as jnetworks
from repro_torch import mapping
from repro_torch.configs import get_config
from repro_torch.core import crossbar, einsteinbarrier, networks

ARCHS = ("tinyllama-1.1b", "qwen1.5-0.5b")
SPECS = {"ePCM": (crossbar.EPCM_TILE, jcrossbar.EPCM_TILE),
         "oPCM": (crossbar.OPCM_TILE, jcrossbar.OPCM_TILE)}


def _data(obj):
    """A dataclass tree as plain data, with the class names kept."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _data(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return tuple(_data(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _data(v) for k, v in obj.items()}
    return obj


def _plans(arch, tech, policy, budget, spares=0):
    spec, jspec = SPECS[tech]
    plan = mapping.compile_plan(get_config(arch), spec=spec, policy=policy,
                                tile_budget=budget, spare_tiles=spares)
    jplan = jmapping.compile_plan(jax_config(arch), spec=jspec, policy=policy,
                                  tile_budget=budget, spare_tiles=spares)
    return plan, jplan


@pytest.mark.parametrize("budget", [None, 1000])
@pytest.mark.parametrize("tech", sorted(SPECS))
@pytest.mark.parametrize("policy", ["tacitmap", "column-major", "greedy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_plans_equal_jax(arch, policy, tech, budget):
    plan, jplan = _plans(arch, tech, policy, budget)
    assert _data(plan) == _data(jplan)
    assert plan.n_tiles == jplan.n_tiles
    assert plan.n_blocks == jplan.n_blocks
    assert plan.utilization() == jplan.utilization()
    assert plan.tile_loads() == jplan.tile_loads()
    assert plan.spares == jplan.spares
    assert plan.preferred_group_size() == jplan.preferred_group_size()
    assert [lp.block_order() for lp in plan.layers] == [lp.block_order() for lp in jplan.layers]
    assert [lp.steps_per_vector for lp in plan.layers] == [
        lp.steps_per_vector for lp in jplan.layers]
    assert mapping.balance_ratio(plan) == jmapping.balance_ratio(jplan)
    assert mapping.report.summarize(plan) == jmapping.report.summarize(jplan)


@pytest.mark.parametrize("tech", sorted(SPECS))
@pytest.mark.parametrize("arch", ARCHS)
def test_schedule_and_reports_equal_jax(arch, tech):
    from repro.core import costmodel as jcostmodel
    from repro_torch.core import costmodel

    plan, jplan = _plans(arch, tech, "greedy", 3000, spares=4)
    sch, jsch = mapping.schedule_plan(plan), jmapping.schedule_plan(jplan)
    assert _data(sch) == _data(jsch)
    assert (sch.total_steps, sch.total_latency_ns, sch.total_energy_pj) == (
        jsch.total_steps, jsch.total_latency_ns, jsch.total_energy_pj)
    assert mapping.report.format_plan(plan) == jmapping.report.format_plan(jplan)
    assert mapping.report.format_plan(plan, max_rows=3) == jmapping.report.format_plan(
        jplan, max_rows=3)
    assert mapping.report.format_priced(costmodel.price_plan(plan)) == \
        jmapping.report.format_priced(jcostmodel.price_plan(jplan))
    assert mapping.required_tiles(get_config(arch), SPECS[tech][0]) == jmapping.required_tiles(
        jax_config(arch), SPECS[tech][1])


def test_remap_onto_spares_equals_jax():
    plan, jplan = _plans("qwen1.5-0.5b", "oPCM", "tacitmap", None, spares=6)
    failed = {3, 17}
    new, delta = mapping.remap_plan(plan, failed, tile_ok=lambda t: t != plan.spares[0])
    jnew, jdelta = jmapping.remap_plan(jplan, failed, tile_ok=lambda t: t != jplan.spares[0])
    assert _data(new) == _data(jnew)
    assert _data(delta) == _data(jdelta)
    assert new.avoid_tiles == (3, 17) and len(delta.moves) > 0
    with pytest.raises(mapping.SpareTilesExhaustedError):
        mapping.remap_plan(plan, set(range(8)))
    same, empty = mapping.remap_plan(plan, ())
    assert same is plan and empty.moves == ()
    avoided = mapping.compile_plan(get_config("qwen1.5-0.5b"), spec=crossbar.OPCM_TILE,
                                   tile_budget=64, spare_tiles=2, avoid_tiles=new.avoid_tiles)
    javoided = jmapping.compile_plan(jax_config("qwen1.5-0.5b"), spec=jcrossbar.OPCM_TILE,
                                     tile_budget=64, spare_tiles=2, avoid_tiles=jnew.avoid_tiles)
    assert _data(avoided) == _data(javoided)


@pytest.mark.parametrize("net", sorted(networks.NETWORKS))
def test_network_irs_plans_and_placements_equal_jax(net):
    """The paper's six BNNs: their LayerIR, a plan on oPCM tiles, and the
    EinsteinBarrier Node -> Tile -> ECore -> VCore placement."""
    tnet, jnet = networks.NETWORKS[net], jnetworks.NETWORKS[net]
    assert _data(tnet) == _data(jnet)
    assert _data(mapping.from_network_desc(tnet)) == _data(jmapping.from_network_desc(jnet))
    plan = mapping.compile_plan(tnet, spec=crossbar.OPCM_TILE, policy="greedy", tile_budget=40)
    jplan = jmapping.compile_plan(jnet, spec=jcrossbar.OPCM_TILE, policy="greedy",
                                  tile_budget=40)
    assert _data(plan) == _data(jplan)
    ir = mapping.to_ir(get_config("tinyllama-1.1b"))
    assert _data(ir.to_network_desc()) == _data(
        jmapping.to_ir(jax_config("tinyllama-1.1b")).to_network_desc())
    place, jplace = einsteinbarrier.place(tnet), jeb.place(jnet)
    assert _data(place) == _data(jplace)
    assert (place.total_vcores, place.nodes_needed, place.utilization) == (
        jplace.total_vcores, jplace.nodes_needed, jplace.utilization)
    from repro.core import costmodel as jcostmodel
    from repro_torch.core import costmodel

    assert einsteinbarrier.schedule_summary(place, costmodel.EINSTEINBARRIER) == \
        jeb.schedule_summary(jplace, jcostmodel.EINSTEINBARRIER)


def test_ir_and_allocator_reject_what_jax_rejects():
    for make in (lambda m: m.LayerIR("x", 0, 4), lambda m: m.LayerIR("x", 4, 4, count=0),
                 lambda m: m.to_ir(3)):
        with pytest.raises((ValueError, TypeError)) as got:
            make(mapping)
        with pytest.raises((ValueError, TypeError)) as want:
            make(jmapping)
        assert got.type.__name__ == want.type.__name__
    cfg = get_config("tinyllama-1.1b")
    for kw in (dict(policy="nope"), dict(tile_budget=0), dict(spare_tiles=-1),
               dict(avoid_tiles=(-1,))):
        with pytest.raises(ValueError):
            mapping.allocate(cfg, **kw)
    assert mapping.adhoc_layer(70, 20).layers[0].name == jmapping.adhoc_layer(70, 20).layers[0].name

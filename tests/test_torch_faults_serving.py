"""Fault tolerance while serving: the port's health monitor against the
JAX package's on the same script. A resident tile fails mid-serve and
is remapped with every generation equal to a solo run; a request
preempted inside the fault window comes back exact; spare exhaustion
degrades (failed requests, rejected submissions, a streamed request
raising ``DegradedServiceError``); a fleet fails over off the degraded
replica; dead WDM lanes shrink K without changing a token.

The JAX serving engine runs op by op (``jax.disable_jit``), the program
the port implements; its spans, events and counters must equal the
port's (timings aside).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import compiler as jax_compiler
from repro import faults as jax_faults
from repro import obs as jax_obs
from repro.serving import Request as JaxRequest
from repro_torch import compiler, obs
from repro_torch.compiler import decode_graph
from repro_torch.faults import FaultModel
from repro_torch.fleet import FleetEngine, Replica
from repro_torch.serving import (
    DegradedServiceError,
    Request,
    RequestRejectedError,
    RequestStatus,
)
from test_torch_generate import op_by_op, pair

torch.set_num_threads(1)

MAX_LEN = 32
GEN = 6
TICKS = 200


@pytest.fixture(scope="module")
def model():
    """The smoke tinyllama in BNN mode; three prompts of one length, so
    the op-by-op JAX side compiles each primitive's shapes once."""
    jcfg, jparams, cfg, lm_model = pair("tinyllama-1.1b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, (6,), np.int32) for _ in range(3)]
    return jcfg, jparams, cfg, lm_model, prompts


def _target(pkg, spares=3, fault_model=None, engine="tiled"):
    kw = dict(engine=engine, fault_model=fault_model)
    if engine == "tiled":
        kw.update(mapping_policy="tacitmap", spare_tiles=spares)
    return pkg.HardwareTarget(**kw)


def _port(model, spares=3, fault_model=None, engine="tiled"):
    _, _, cfg, lm_model, _ = model
    return compiler.compile(cfg, lm_model, _target(compiler, spares, fault_model, engine),
                            device="cpu")


@pytest.fixture(scope="module")
def solo(model):
    """Each prompt served alone on the fault-free tiled target."""
    cm = _port(model)
    out = {}
    for i, p in enumerate(model[4]):
        se = cm.serve(max_batch=1, max_len=MAX_LEN)
        st = se.submit(Request(rid=i, prompt=p, max_new_tokens=GEN))
        se.drain(TICKS)
        out[i] = tuple(st.generated)
    return out


def _victim(cm) -> int:
    """The lowest physical tile the wrapper executes (placements resolve
    by shape, so a planted failure must land on one of these)."""
    return min(t for pw in cm._fault_artifacts() for *_, t in cm.engine._placement_blocks(pw.m, pw.n))


def _fail(cm, se, tile) -> None:
    cm.engine.fail_tile(tile)
    cm.refresh_faults()
    se._rebind()


def _script(cm, se, requests, fail_at, victim, extra=None):
    """Submit, step until idle, failing ``victim`` before tick
    ``fail_at`` (and submitting ``extra`` then)."""
    states = [se.submit(r) for r in requests]
    for tick in range(TICKS):
        if tick == fail_at:
            if extra is not None:
                states.append(se.submit(extra))
            _fail(cm, se, victim)
        se.step()
        if se.idle():
            break
    return states


TIMINGS = {"program_s"}


def _records(tel) -> list:
    return [(type(r).__name__, r.name, r.track, getattr(r, "depth", None),
             {k: v for k, v in r.attrs.items() if k not in TIMINGS})
            for r in tel.tracer.records]


# The tiled engine reads its placement-index LRU once per programmed
# artifact. The port programs each block's projections apart (7 per
# layer) where the reference stacks each projection over its layers (7 in
# all), so that cache's hit count differs by design and is left out.
PER_ARTIFACT = (("cache", "placement_indices"),)
# the port's own: how its decode steps ran (CUDA graph or eager), which
# the reference has no counterpart of
PORT_ONLY = (decode_graph.COUNTER,)


def _metrics(tel) -> dict:
    out = {}
    for name, inst in tel.metrics._metrics.items():
        for key, child in inst._series.items():
            if name == "repro_cache_events_total" and key[:1] == PER_ARTIFACT \
                    or name in PORT_ONLY:
                continue
            if inst.kind == "histogram":
                out[(name, key)] = (child.total, None if name.endswith("_seconds")
                                    else (child.counts, child.sum))
            else:
                out[(name, key)] = child.value
    return out


def _both(model, spares, script):
    """Run ``script(pkg_compiled, serving, request_cls)`` in a telemetry
    session on the port and on the JAX package (op by op)."""
    jcfg, jparams, cfg, lm_model, _ = model
    with obs.session() as tel:
        cm = _port(model, spares, FaultModel())
        got = script(cm, Request)
    with op_by_op(), jax_obs.session() as jtel:
        jcm = jax_compiler.compile(jcfg, jparams,
                                   _target(jax_compiler, spares, jax_faults.FaultModel()))
        want = script(jcm, JaxRequest)
    return got, want, tel, jtel


def test_mid_serve_failure_remaps_and_equals_the_reference(model, solo):
    """The headline gate: a tile dies mid-serve, the health monitor
    detects, remaps and restarts, every generation equals solo, and
    tokens, remaps, quarantined tiles, restarts, spans, events and
    counters equal the JAX serving engine's."""
    prompts = model[4]

    def script(cm, request_cls):
        se = cm.serve(max_batch=len(prompts), max_len=MAX_LEN)
        assert se.health is not None
        victim = _victim(cm)
        states = _script(cm, se, [request_cls(rid=i, prompt=p, max_new_tokens=GEN)
                                  for i, p in enumerate(prompts)], 2, victim)
        h = se.health
        return ({st.rid: tuple(st.generated) for st in states},
                (h.remaps, h.degraded, sorted(h.quarantined), h.last_clean_tick),
                se.stats().scheduler.restarted, victim)

    got, want, tel, jtel = _both(model, 3, script)
    assert got == want
    tokens, (remaps, degraded, quarantined, _), restarted, victim = got
    assert tokens == solo
    assert remaps == 1 and not degraded and quarantined == [victim] and restarted >= 1
    assert _records(tel) == _records(jtel)
    assert _metrics(tel) == _metrics(jtel)
    names = [r.name for r in tel.tracer.records]
    assert {"degraded_tick", "remap", "fault.remap"} <= set(names)
    assert tel.metrics.counter("repro_remaps_total").value == 1


def test_spare_exhaustion_degrades_as_the_reference(model):
    """No spares: the remap fails, the scheduler degrades, in-flight
    requests fail with the named reason, new submissions are rejected —
    states, events and counters equal the JAX engine's."""
    prompts = model[4]

    def script(cm, request_cls):
        se = cm.serve(max_batch=2, max_len=MAX_LEN)
        st = se.submit(request_cls(rid=0, prompt=prompts[0], max_new_tokens=12))
        se.step()
        _fail(cm, se, _victim(cm))
        for _ in range(20):
            se.step()
            if se.health.degraded:
                break
        st2 = se.submit(request_cls(rid=1, prompt=prompts[1], max_new_tokens=4))
        return (se.health.degraded, st.status.value, st.fail_reason, tuple(st.generated),
                st2.status.value, st2.reject_reason)

    got, want, tel, jtel = _both(model, 0, script)
    assert got == want
    degraded, status, reason, _, status2, _ = got
    assert degraded and status == RequestStatus.FAILED.value and "spare" in reason.lower()
    assert status2 == RequestStatus.REJECTED.value
    assert _records(tel) == _records(jtel)
    assert _metrics(tel) == _metrics(jtel)
    assert tel.metrics.counter("repro_degraded_total").value == 1


def test_degraded_service_rejects_streams(model):
    prompts = model[4]
    cm = _port(model, 0, FaultModel())
    se = cm.serve(max_batch=2, max_len=MAX_LEN)
    se.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=12))
    se.step()
    _fail(cm, se, _victim(cm))
    for _ in range(20):
        se.step()
    assert se.health.degraded
    with pytest.raises(RequestRejectedError, match="degraded"):
        list(se.stream(Request(rid=2, prompt=prompts[2], max_new_tokens=4)))


def test_stream_raises_degraded_service_error(model):
    """An in-flight streamed request whose service degrades surfaces
    ``DegradedServiceError`` to the consuming client."""
    cm = _port(model, 0, FaultModel())
    se = cm.serve(max_batch=1, max_len=MAX_LEN)
    _fail(cm, se, _victim(cm))
    with pytest.raises(DegradedServiceError, match="failed"):
        list(se.stream(Request(rid=0, prompt=model[4][0], max_new_tokens=20)))


def test_preempted_inside_the_fault_window_is_exact(model, solo):
    """A request preempted (priority eviction) while the fault -> remap
    window is open comes back exact: post-fault snapshots are discarded
    by the clean-tick watermark, pre-fault ones restore."""
    prompts = model[4]
    cm = _port(model, 3, FaultModel())
    se = cm.serve(max_batch=2, max_len=MAX_LEN)
    states = _script(cm, se, [Request(rid=i, prompt=p, max_new_tokens=GEN, priority=0)
                              for i, p in enumerate(prompts[:2])], 1, _victim(cm),
                     extra=Request(rid=2, prompt=prompts[2], max_new_tokens=GEN, priority=5))
    assert se.health.remaps == 1 and not se.health.degraded
    assert se.stats().scheduler.preempted >= 1
    for st in states:
        assert st.status is RequestStatus.FINISHED
        assert tuple(st.generated) == solo[st.rid]


def test_expired_partial_output_is_a_strict_solo_prefix(model, solo):
    cm = _port(model, 3, FaultModel())
    se = cm.serve(max_batch=1, max_len=MAX_LEN)
    (st,) = _script(cm, se, [Request(rid=0, prompt=model[4][0], max_new_tokens=GEN,
                                     deadline_ticks=8)], 2, _victim(cm))
    assert st.status is RequestStatus.EXPIRED
    got = tuple(st.generated)
    assert 0 < len(got) < len(solo[0]) and got == solo[0][: len(got)]


def test_fleet_fails_over_off_the_degraded_replica(model):
    """Replica 0 (fault-injected, no spares) loses a tile mid-serve and
    degrades; its requests finish on replica 1 with solo tokens and no
    request fails fleet-wide."""
    _, _, cfg, lm_model, _ = model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, (5 + i,), np.int32) for i in range(4)]
    gen = 10
    max_len = max(len(p) for p in prompts) + gen + 2
    clean = _port(model, 0)
    refs = {}
    for i, p in enumerate(prompts):
        se = clean.serve(max_batch=1, max_len=max_len)
        st = se.submit(Request(rid=i, prompt=p, max_new_tokens=gen))
        se.drain()
        refs[i] = tuple(st.generated)
    cm0 = _port(model, 0, FaultModel())
    r0 = Replica(0, cm0, max_batch=4, max_len=max_len)
    r1 = Replica(1, clean, max_batch=4, max_len=max_len)
    fleet = FleetEngine([r0, r1], routing="least-loaded")
    states = [fleet.submit(Request(rid=i, prompt=p, max_new_tokens=gen))
              for i, p in enumerate(prompts)]
    ticks = 0
    while not fleet.idle() and ticks < TICKS:
        if ticks == 2:
            _fail(cm0, r0.serving, _victim(cm0))
        fleet.step()
        ticks += 1
    assert r0.degraded_reason is not None and r1.healthy
    s = fleet.stats()
    assert s.failed == 0 and s.failovers > 0 and s.healthy_replicas == 1
    for st in states:
        assert st.status is RequestStatus.FINISHED
        assert tuple(st.generated) == refs[st.request.rid]
    moved = [st for st in states if st.failovers > 0]
    assert moved and all(st.replica == 1 for st in moved)


def test_dead_lanes_shrink_k_bit_exactly(model):
    """Dead WDM lanes are a capacity loss, never a correctness loss: a
    model compiled with dead lanes and a lane dying mid-serve both keep
    the plain engine's generations."""
    prompts = model[4]
    plain = _port(model, engine="wdm")
    want = {}
    for i, p in enumerate(prompts):
        se = plain.serve(max_batch=1, max_len=MAX_LEN)
        st = se.submit(Request(rid=i, prompt=p, max_new_tokens=GEN))
        se.drain(TICKS)
        want[i] = tuple(st.generated)
    cm = _port(model, fault_model=FaultModel(dead_lanes=(0, 3)), engine="wdm")
    se = cm.serve(max_batch=16, max_len=MAX_LEN)
    assert se.group_k == plain.group_size_for(16) - 2
    states = [se.submit(Request(rid=i, prompt=p, max_new_tokens=GEN))
              for i, p in enumerate(prompts)]
    se.drain(TICKS)
    assert {st.rid: tuple(st.generated) for st in states} == want

    cm = _port(model, fault_model=FaultModel(), engine="wdm")
    se = cm.serve(max_batch=16, max_len=MAX_LEN)
    k0 = se.group_k
    with obs.session() as tel:
        states = [se.submit(Request(rid=i, prompt=p, max_new_tokens=GEN))
                  for i, p in enumerate(prompts)]
        for tick in range(TICKS):
            if tick == 2:
                cm.engine.fail_lane(1)
            se.step()
            if se.idle():
                break
    assert se.group_k == k0 - 1 and not se.health.degraded
    assert {st.rid: tuple(st.generated) for st in states} == want
    (ev,) = [r for r in tel.tracer.records if r.name == "fault.k_shrink"]
    assert ev.attrs == {"lanes": [1], "k_before": k0, "k_after": k0 - 1}


def test_monitor_arguments_and_rebind(model):
    from repro_torch.faults import HealthMonitor

    cm = _port(model, 3, FaultModel())
    se = cm.serve(max_batch=2, max_len=MAX_LEN)
    with pytest.raises(ValueError):
        HealthMonitor(se, check_interval=0)
    with pytest.raises(ValueError):
        HealthMonitor(se, max_remaps=-1)
    exec_before = se._exec
    _fail(cm, se, _victim(cm))
    assert se._exec is not exec_before and se._exec.base is cm.engine
    plain = dataclasses.replace(cm.target, fault_model=None)
    assert compiler.compile(cm.cfg, model[3], plain, device="cpu").serve(
        max_batch=1, max_len=MAX_LEN).health is None

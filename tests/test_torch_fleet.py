"""The port's fleet: router units, prefix-grafted admission, routed ==
solo across policy x replicas x engine x attention path, failover off a
degraded replica, and routing decisions equal to the JAX package's
``FleetEngine`` on the same seeded requests.

Everything is compared for exact equality: a graft or a failover may not
change a single generated token.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import compiler as jax_compiler
from repro import fleet as jax_fleet
from repro.serving import Request as JaxRequest
from repro_torch import compiler
from repro_torch.fleet import (
    FleetEngine,
    FleetRouter,
    PrefixIndex,
    Replica,
    RoutingConfigError,
    chain_hashes,
)
from repro_torch.serving import PrefixGraft, Request, RequestStatus
from repro_torch.serving.scheduler import RequestState
from test_torch_generate import pair

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

MAX_LEN = 40
GEN = 4
BLOCK = 4
IMPLS = ("jnp", "pallas")
ENGINES = ("reference", "packed")


def _prompts(vocab: int) -> list[np.ndarray]:
    """The reference's fleet trace (tests/test_fleet.py): half the
    prompts share one block-aligned prefix."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab, (2 * BLOCK,), dtype=np.int32)
    prompts = []
    for i in range(6):
        if i % 2 == 0:
            tail = rng.integers(1, vocab, (2 + i % 3,), np.int32)
            prompts.append(np.concatenate([shared, tail]))
        else:
            prompts.append(rng.integers(1, vocab, (5,), np.int32))
    return prompts


@pytest.fixture(scope="module")
def model():
    jcfg, jparams, cfg, lm_model = pair("tinyllama-1.1b")
    return jcfg, jparams, cfg, lm_model, _prompts(cfg.vocab_size)


@pytest.fixture(scope="module")
def compiled(model):
    _, _, cfg, lm_model, _ = model
    return {
        (engine, impl): compiler.compile(
            dataclasses.replace(cfg, attn_impl=impl), lm_model,
            compiler.HardwareTarget(engine=engine), device="cpu",
        )
        for engine in ENGINES for impl in IMPLS
    }


@pytest.fixture(scope="module")
def solo(model, compiled):
    """Each request alone in a 1-slot pool, per engine and attention path."""
    prompts = model[4]
    out = {}
    for key, cm in compiled.items():
        for i, p in enumerate(prompts):
            se = cm.serve(max_batch=1, max_len=MAX_LEN)
            st = se.submit(Request(rid=i, prompt=p, max_new_tokens=GEN))
            se.drain()
            out[(*key, i)] = tuple(st.generated)
    return out


def _drive_staggered(fleet, prompts, request=Request, gen=GEN):
    """One submit per fleet tick (the prefix library fills as later
    requests arrive), then drain."""
    states = []
    for i, p in enumerate(prompts):
        states.append(fleet.submit(request(rid=i, prompt=p, max_new_tokens=gen)))
        fleet.step()
    fleet.drain()
    return states


# ---------------------------------------------------------------------------
# router units (no model involved)
# ---------------------------------------------------------------------------


def test_chain_hashes_equal_the_reference():
    rng = np.random.default_rng(1)
    for length, block in ((37, 4), (64, 16), (3, 4)):
        toks = rng.integers(0, 32000, size=(length,), dtype=np.int32)
        assert chain_hashes(toks, block) == jax_fleet.chain_hashes(toks, block)


def test_chain_hashes_name_prefixes():
    a = np.arange(100, 116, dtype=np.int32)
    b = np.concatenate([a[:8], np.arange(900, 908, dtype=np.int32)])
    ha, hb = chain_hashes(a, 4), chain_hashes(b, 4)
    assert ha[:2] == hb[:2] and ha[2:] != hb[2:]
    assert len(chain_hashes(np.arange(10, dtype=np.int32), 4)) == 2
    h = chain_hashes(np.array([1, 2, 3, 4, 1, 2, 3, 4], np.int32), 4)
    assert h[0] != h[1]  # the chain carries position


def test_prefix_index_matching_and_lru():
    idx = PrefixIndex(block_size=4)
    idx.insert(np.arange(10, dtype=np.int32), rows="rows")
    entry, common = idx.match(np.arange(9, dtype=np.int32))
    assert entry is not None and common == 9  # element-wise, past the last block
    assert idx.match(np.concatenate([np.arange(2), np.full(6, 999)]).astype(np.int32)) == (None, 0)

    lru = PrefixIndex(block_size=2, capacity=2)
    for base in (0, 100, 200):
        lru.insert(np.arange(base, base + 4, dtype=np.int32), rows=base)
    assert len(lru) == 2
    assert lru.match(np.arange(0, 4, dtype=np.int32))[0] is None
    assert lru.match(np.arange(200, 204, dtype=np.int32))[0] is not None

    longest = PrefixIndex(block_size=2)
    longest.insert(np.arange(4, dtype=np.int32), rows="short")
    longest.insert(np.arange(8, dtype=np.int32), rows="long")
    entry, common = longest.match(np.arange(8, dtype=np.int32))
    assert entry.rows == "long" and common == 8
    with pytest.raises(RoutingConfigError, match="block_size"):
        PrefixIndex(block_size=0)
    with pytest.raises(RoutingConfigError, match="capacity"):
        PrefixIndex(block_size=2, capacity=0)


def test_router_policies():
    with pytest.raises(RoutingConfigError, match="lifo"):
        FleetRouter([0, 1], policy="lifo")
    toks = np.arange(12, dtype=np.int32)
    rr = FleetRouter([0, 1, 2], policy="round-robin")
    assert [rr.route(toks, {0: 0.0, 1: 0.0, 2: 0.0}).replica for _ in range(6)] == [0, 1, 2] * 2
    assert FleetRouter([0, 1], policy="least-loaded").route(toks, {0: 5.0, 1: 1.0}).replica == 1

    r = FleetRouter([0, 1], policy="prefix", block_size=4)
    d = r.route(toks, {0: 9.0, 1: 2.0})
    assert d.replica == 1 and d.graft_length == 0 and r.prefix_hits == 0
    r.observe_prefill(1, toks, rows="kv")
    d = r.route(toks, {0: 0.0, 1: 50.0})  # affinity beats load
    assert d.replica == 1 and d.graft_length == 11 and d.entry.rows == "kv"
    r.forget_replica(1)
    d = r.route(toks, {0: 0.0})
    assert d.replica == 0 and d.graft_length == 0


# ---------------------------------------------------------------------------
# grafted admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_grafted_admission_is_exact_and_counted(compiled, model, solo, impl):
    prompt = model[4][0]
    cm = compiled[("reference", impl)]
    _, donor = cm.prefill(prompt[None, :BLOCK])
    rows = {name: {key: t[:, 0] for key, t in kv.items()} for name, kv in donor.items()}
    se = cm.serve(max_batch=1, max_len=MAX_LEN)
    assert se.supports_prefix_graft and se.health is None
    st = se.submit(Request(rid=0, prompt=prompt, max_new_tokens=GEN,
                           prefix=PrefixGraft(length=BLOCK, rows=rows)))
    se.drain()
    assert tuple(st.generated) == solo[("reference", impl, 0)]
    s = se.stats()
    assert s.grafted_tokens == BLOCK and s.prefill_tokens == len(prompt) - BLOCK


def test_prefill_observer_sees_full_prompt_rows(compiled, model):
    cm = compiled[("packed", "pallas")]
    se = cm.serve(max_batch=1, max_len=MAX_LEN)
    seen = []
    se.prefill_observer = lambda st, rows: seen.append((st.request.rid, rows))
    prompt = model[4][0]
    se.submit(Request(rid=3, prompt=prompt, max_new_tokens=1))
    se.drain()
    (rid, rows), = seen
    assert rid == 3
    k = rows["slot0"]["k"]
    assert k.shape == (cm.cfg.n_repeats, len(prompt), cm.cfg.n_kv_heads, cm.cfg.hd)


# ---------------------------------------------------------------------------
# the fleet invariant: routed == solo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n_replicas", [1, 2])
@pytest.mark.parametrize("policy", ["prefix", "least-loaded", "round-robin"])
def test_routed_equals_solo(compiled, model, solo, policy, n_replicas, engine, impl):
    prompts = model[4]
    cm = compiled[(engine, impl)]
    fleet = FleetEngine(
        [Replica(r, cm, max_batch=2, max_len=MAX_LEN) for r in range(n_replicas)],
        routing=policy, block_size=BLOCK,
    )
    states = _drive_staggered(fleet, prompts)
    for st in states:
        assert st.status is RequestStatus.FINISHED
        assert tuple(st.generated) == solo[(engine, impl, st.request.rid)]
    s = fleet.stats()
    assert s.finished == len(prompts) and s.failed == 0
    if policy == "prefix":
        assert s.prefix_hits > 0 and s.grafted_tokens > 0
    else:
        assert s.grafted_tokens == 0


def test_fleet_price_waits_for_the_cost_model(compiled):
    """The fleet prices through the cost model: replicas x one target's
    ``price()`` (tiles, programming and tick energy scale with the
    replica count; the tick's latency does not)."""
    cm = compiled[("reference", "jnp")]
    fleet = FleetEngine([Replica(r, cm, max_batch=1, max_len=MAX_LEN) for r in range(2)])
    price, base = fleet.price(n_active=4), cm.price(4)
    assert price.base == base and price.n_replicas == 2 and price.n_active == 4
    assert price.tiles_total == 2 * base.n_tiles
    assert price.tick_energy_pj == 2 * base.tick_energy_pj
    assert price.tick_latency_ns == base.tick_latency_ns
    assert price.summary().startswith(f"[fleet] 2 x {base.plan_cost.model} on ")


def test_stream_through_fleet(compiled, model, solo):
    cm = compiled[("packed", "pallas")]
    fleet = FleetEngine([Replica(r, cm, max_batch=2, max_len=MAX_LEN) for r in range(2)],
                        routing="prefix", block_size=BLOCK)
    got = list(fleet.stream(Request(rid=0, prompt=model[4][0], max_new_tokens=GEN)))
    assert tuple(got) == solo[("packed", "pallas", 0)]


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_degrade_fails_over_with_identical_tokens(compiled, model, solo, impl):
    """Replica 0 degrades mid-serve (what the health monitor does:
    ``scheduler.degrade`` then the engine's ``on_degrade`` hook); every
    request finishes on replica 1 with its solo tokens, none FAILED."""
    prompts = model[4][:4]
    cm = compiled[("packed", impl)]
    r0, r1 = (Replica(r, cm, max_batch=4, max_len=MAX_LEN) for r in range(2))
    fleet = FleetEngine([r0, r1], routing="least-loaded")
    states = [fleet.submit(Request(rid=i, prompt=p, max_new_tokens=GEN))
              for i, p in enumerate(prompts)]
    fleet.step()
    fleet.step()
    r0.scheduler.degrade("synthetic fault")
    r0.serving.on_degrade("synthetic fault")
    fleet.drain()
    assert r0.degraded_reason == "synthetic fault" and r1.healthy
    s = fleet.stats()
    assert s.failed == 0 and s.failovers > 0 and s.healthy_replicas == 1
    for st in states:
        assert st.status is RequestStatus.FINISHED
        assert tuple(st.generated) == solo[("packed", impl, st.request.rid)]
    moved = [st for st in states if st.failovers > 0]
    assert moved and all(st.replica == 1 for st in moved)


def test_all_replicas_degraded_rejects(compiled, model):
    fleet = FleetEngine([Replica(0, compiled[("reference", "jnp")], max_batch=1,
                                 max_len=MAX_LEN)], routing="least-loaded")
    fleet.replicas[0].scheduler.degrade("synthetic wipeout")
    st = fleet.submit(Request(rid=0, prompt=model[4][0], max_new_tokens=2))
    assert st.status is RequestStatus.REJECTED and "wipeout" in st.reject_reason


def test_adopt_resumes_a_snapshot_from_another_pool(compiled, model, solo):
    """The failover salvage primitive: a snapshot evicted from one pool
    resumes in another through ``scheduler.adopt``; carried tokens do
    not re-fire ``on_token``."""
    cm = compiled[("packed", "pallas")]
    prompt = model[4][0]
    se_a = cm.serve(max_batch=1, max_len=MAX_LEN)
    slot = se_a.acquire_slot()
    st_a = RequestState(request=Request(rid=0, prompt=prompt, max_new_tokens=GEN),
                        seq=0, submit_tick=0)
    se_a.prefill_into(slot, st_a)
    se_a.decode_tick({slot: st_a})
    snap = se_a.evict_slot(slot)
    seen = []
    se_b = cm.serve(max_batch=2, max_len=MAX_LEN)
    st_b = se_b.scheduler.adopt(
        Request(rid=0, prompt=prompt, max_new_tokens=GEN,
                on_token=lambda r, t, i: seen.append(t)),
        generated=list(st_a.generated), snapshot=snap,
    )
    se_b.drain()
    ref = solo[("packed", "pallas", 0)]
    assert tuple(st_b.generated) == ref
    assert tuple(seen) == ref[len(st_a.generated):]
    assert se_b.stats().scheduler.resumed == 1


# ---------------------------------------------------------------------------
# routing decisions against the JAX package's fleet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_compiled(model):
    jcfg, jparams = model[0], model[1]
    return jax_compiler.compile(jcfg, jparams, jax_compiler.HardwareTarget(engine="reference"))


@pytest.mark.parametrize("policy", ["prefix", "least-loaded", "round-robin"])
def test_routing_decisions_equal_the_reference(jax_compiled, compiled, model, policy):
    """The replica each request lands on, and the prefix each graft
    skips, match the JAX ``FleetEngine`` on the same trace (the load
    scores count tokens and ticks, never logits)."""
    prompts = model[4]
    jfleet = jax_fleet.FleetEngine(
        [jax_fleet.Replica(r, jax_compiled, max_batch=2, max_len=MAX_LEN) for r in range(2)],
        routing=policy, block_size=BLOCK,
    )
    want = _drive_staggered(jfleet, prompts, request=JaxRequest)
    fleet = FleetEngine(
        [Replica(r, compiled[("reference", "jnp")], max_batch=2, max_len=MAX_LEN)
         for r in range(2)],
        routing=policy, block_size=BLOCK,
    )
    got = _drive_staggered(fleet, prompts)
    assert [st.replica for st in got] == [st.replica for st in want]
    js, s = jfleet.stats(), fleet.stats()
    assert (s.prefix_hits, s.grafted_tokens, s.prefill_tokens) == (
        js.prefix_hits, js.grafted_tokens, js.prefill_tokens)
    assert jax.tree.leaves(js.replicas[0].ticks) == [s.replicas[0].ticks]

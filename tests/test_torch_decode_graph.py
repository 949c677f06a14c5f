"""``CompiledModel.decode_step`` as a CUDA graph (compiler/decode_graph.py),
on the CPU through an injected backend: its capture runs the step once
(standing for the capture and the replay that follows it), a later
replay runs it again with the counters held, so only what the mechanism
adds back shows. Pinned: eager on a key's first sight, capture on its
second, replay after; any change of a cache's pointer, shape or batch
is eager; the LRU evicts and resets; a refresh or remap drops every
graph; a patched step function, the CPU, DTensor caches, grad and other
engines stay eager; the returned logits are the caller's; counters
after N replays read as N eager steps; each outcome is counted."""

import pytest
import torch

from repro_torch import compiler, obs
from repro_torch.compiler import decode_graph
from repro_torch.configs import get_smoke_config
from repro_torch.faults import FaultModel
from repro_torch.faults.engine import FaultyEngine
from repro_torch.kernels import fused_decode, xnor_matmul
from repro_torch.models import lm

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
BATCH = 3
PROMPT = 5
MAX_LEN = 32
STEPS = 6


def _restore(counts, cache) -> None:
    kernels, lru = counts
    for k, (n, by) in zip(decode_graph.KERNELS, kernels):
        k.launches = n
        k.launches_by_variant.update(by)
    if lru is not None:
        cache.lru.hits, cache.lru.misses, cache.lru.evictions = lru


class FakeGraphs:
    """A graph backend for CPU tensors (module docstring)."""

    def __init__(self):
        self.captures = self.replays = self.resets = 0
        self.cache = None  # the weight cache a rerun must not move

    def usable(self, device):
        return True

    def capture(self, fn, device):
        self.captures += 1
        out = fn()
        return {"fn": fn, "logits": out[0], "ran": True}, out

    def replay(self, graph):
        if graph.pop("ran", False):  # the capture's own run is this step's
            return
        self.replays += 1
        held = decode_graph._counts(self.cache)
        name = self.cache.lru.name if self.cache is not None else None
        if self.cache is not None:
            self.cache.lru.name = None  # no telemetry from the rerun either
        try:
            logits = graph["fn"]()[0]
        finally:
            if self.cache is not None:
                self.cache.lru.name = name
            _restore(held, self.cache)
        graph["logits"].copy_(logits)

    def reset(self, graph):
        self.resets += 1


def _compile(arch=ARCH, fake=True, **target):
    cfg = get_smoke_config(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    cm = compiler.compile(cfg, params, compiler.HardwareTarget(**{"engine": "packed", **target}),
                          device="cpu")
    if fake:
        backend = FakeGraphs()
        cm.decode_graphs = decode_graph.DecodeGraphs(backend)
        backend.cache = getattr(cm.executor(BATCH), "weight_cache", None)
    return cm


def _start(cm, batch=BATCH, max_len=MAX_LEN, seed=0):
    """Prefill a batch; returns (first tokens, serving caches)."""
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cm.cfg.vocab_size, (batch, PROMPT), generator=gen)
    logits, pre = cm.prefill(tokens)
    caches = cm.graft_prefill_caches(cm.init_cache(batch, max_len), pre)
    return torch.argmax(logits, dim=-1), caches


@torch.no_grad()
def _decode(cm, tok, caches, steps=STEPS, start=PROMPT):
    """Greedy steps; each step's logits (the caller's copies)."""
    out = []
    for i in range(steps):
        logits, caches = cm.decode_step(tok, start + i, caches)
        out.append(logits)
        tok = torch.argmax(logits, dim=-1)
    return out, caches


def _outcomes(tel) -> dict:
    c = tel.metrics.counter(decode_graph.COUNTER)
    return {dict(key).get("reason", dict(key)["outcome"]): int(child.value)
            for key, child in c._series.items()}


@pytest.mark.parametrize("arch", [ARCH, "mamba2-2.7b", "jamba-1.5-large-398b",
                                  "qwen3-moe-235b-a22b", "granite-4.0-h-small"])
def test_eager_then_capture_then_replay_equal_eager_steps(arch):
    """First sight eager, second capture, the rest replays; every step's
    logits and the caches (K/V, conv tails, SSD states) equal an eager
    model's bit for bit, on attention, Mamba-2, hybrid and MoE stacks
    (granite: NoPE attention, a shared expert, the multipliers)."""
    eager, graphed = _compile(arch, fake=False), _compile(arch)
    want, want_caches = _decode(eager, *_start(eager))
    with obs.session() as tel:
        got, caches = _decode(graphed, *_start(graphed))
    fake = graphed.decode_graphs.backend
    assert (fake.captures, fake.replays) == (1, STEPS - 2)
    assert _outcomes(tel) == {"first_sight": 1, "capture": 1, "replay": STEPS - 2}
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for slot, kv in want_caches.items():
        for name, t in kv.items():
            assert torch.equal(caches[slot][name], t), (slot, name)


@pytest.mark.parametrize("change", ["pointer", "shape", "batch"])
def test_a_changed_cache_or_batch_runs_eagerly(change):
    cm = _compile()
    tok, caches = _start(cm)
    _decode(cm, tok, caches, steps=3)
    assert len(cm.decode_graphs) == 1
    if change == "pointer":  # same shapes, new tensors
        tok, caches = _start(cm)
    elif change == "shape":
        tok, caches = _start(cm, max_len=MAX_LEN + 8)
    else:
        tok, caches = _start(cm, batch=BATCH + 1)
    with obs.session() as tel:
        _decode(cm, tok, caches, steps=1)
    assert _outcomes(tel) == {"first_sight": 1}
    with obs.session() as tel:
        _decode(cm, tok, caches, steps=2, start=PROMPT + 1)
    assert _outcomes(tel) == {"capture": 1, "replay": 1}
    assert len(cm.decode_graphs) == 2


def test_a_key_seen_only_apart_is_never_captured():
    """Two cache sets taking turns: each key is new to the call before."""
    cm = _compile()
    runs = [_start(cm, seed=s) for s in (0, 1)]
    with obs.session() as tel, torch.no_grad():
        for i in range(4):
            for tok, caches in runs:
                cm.decode_step(tok, PROMPT + i, caches)
    assert _outcomes(tel) == {"first_sight": 8} and len(cm.decode_graphs) == 0


def test_the_lru_evicts_and_resets():
    cm = _compile()
    fake = cm.decode_graphs.backend
    n = decode_graph.MAX_GRAPHS
    runs = [_start(cm, seed=s) for s in range(n + 1)]
    for tok, caches in runs:
        _decode(cm, tok, caches, steps=3)
    assert (fake.captures, fake.resets, len(cm.decode_graphs)) == (n + 1, 1, n)
    # the first key went: its next call is a first sight again
    with obs.session() as tel:
        _decode(cm, *runs[0], steps=2, start=PROMPT + 3)
    assert _outcomes(tel) == {"first_sight": 1, "capture": 1}
    assert (fake.captures, fake.resets) == (n + 2, 2)
    # the last key's graph stayed
    with obs.session() as tel:
        _decode(cm, *runs[-1], steps=1, start=PROMPT + 3)
    assert _outcomes(tel) == {"replay": 1}
    cm.decode_graphs.clear()
    assert (fake.resets, len(cm.decode_graphs)) == (n + 2, 0)


@pytest.mark.parametrize("how", ["refresh", "remap"])
def test_a_refresh_or_remap_drops_every_graph(how, monkeypatch):
    """A fault-injecting target runs eagerly; let its engine pass as the
    graphed one to see that new weights drop the graphs."""
    monkeypatch.setattr(decode_graph, "PackedEngine", FaultyEngine)
    target = dict(fault_model=FaultModel())
    if how == "remap":
        target.update(engine="tiled", mapping_policy="tacitmap", spare_tiles=3)
    cm = _compile(**target)
    fake = cm.decode_graphs.backend
    tok, caches = _start(cm)
    _decode(cm, tok, caches, steps=3)
    assert len(cm.decode_graphs) == 1
    if how == "refresh":
        cm.refresh_faults()
    else:
        cm.remap(cm.scan_faults())
    assert (len(cm.decode_graphs), fake.resets) == (0, 1)
    with obs.session() as tel:
        _decode(cm, tok, caches, steps=1, start=PROMPT + 3)
    assert _outcomes(tel) == {"first_sight": 1}


def test_a_patched_ffn_residual_runs_eagerly_and_sees_every_step(monkeypatch):
    cm = _compile()
    seen = []
    real = lm._ffn_residual

    def recorded(blk, h, cfg, eng):
        seen.append(h.shape)
        return real(blk, h, cfg, eng)

    monkeypatch.setattr(lm, "_ffn_residual", recorded)
    tok, caches = _start(cm)
    seen.clear()
    with obs.session() as tel:
        _decode(cm, tok, caches)
    assert _outcomes(tel) == {"patched": STEPS}
    assert len(seen) == STEPS * cm.cfg.n_layers and len(cm.decode_graphs) == 0


def _dtensor_caches(caches):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    mesh = init_device_mesh("cpu", (1,))
    return {slot: {name: DTensor.from_local(t, mesh, [Replicate()]) for name, t in kv.items()}
            for slot, kv in caches.items()}


@pytest.mark.parametrize("case", ["device", "reference", "wdm", "faulty", "sharded", "grad"])
def test_other_devices_engines_and_caches_stay_eager(case, monkeypatch):
    target, reason = {}, "engine"
    if case == "reference" or case == "wdm":
        target = {"engine": case}
    elif case == "faulty":
        target = {"fault_model": FaultModel()}
    elif case != "device":
        reason = case
    cm = _compile(fake=case != "device", **target)
    tok, caches = _start(cm)
    try:
        if case == "sharded":
            # the step of a model left unsharded is not what is tested
            caches = _dtensor_caches(caches)
            monkeypatch.setattr(lm, "decode_step", lambda model, token, pos, caches, cfg, engine:
                                (torch.zeros(token.shape[0], cfg.padded_vocab), caches))
        with obs.session() as tel:
            if case == "grad":
                for i in range(3):
                    cm.decode_step(tok, PROMPT + i, caches)
            else:
                _decode(cm, tok, caches, steps=3)
    finally:
        if case == "sharded":
            torch.distributed.destroy_process_group()
    assert _outcomes(tel) == {case if case == "device" else reason: 3}
    assert len(cm.decode_graphs) == 0


def test_returned_logits_survive_the_next_step():
    cm = _compile()
    tok, caches = _start(cm)
    got, _ = _decode(cm, tok, caches, steps=4)
    kept = [g.clone() for g in got]
    _decode(cm, torch.argmax(got[-1], dim=-1), caches, steps=2, start=PROMPT + 4)
    assert cm.decode_graphs.backend.replays >= 3
    assert all(torch.equal(a, b) for a, b in zip(got, kept))
    assert not torch.equal(got[2], got[3])


@pytest.fixture
def counted_launches(monkeypatch):
    """The CPU's plain kernels counted as their CUDA launches are."""
    for mod, name, variant in ((fused_decode, "fused_bnn_matmul_kernel", "b1"),
                               (xnor_matmul, "hamming_matmul_packed", "b1")):
        real = getattr(mod, name)

        def counted(*a, _mod=mod, _real=real, _variant=variant, **k):
            _mod.launches += 1
            _mod.launches_by_variant[_variant] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counted)


@pytest.mark.parametrize("weights", ["prepared", "raw"])
def test_counters_after_replays_read_as_eager_steps(weights, counted_launches):
    """Launches, launches by variant and the weight cache's traffic (its
    stats and the telemetry's cache events) after N steps, replays among
    them, equal N eager steps'."""
    target = {"prepare_weights": weights == "prepared"}

    def run(fake):
        cm = _compile(fake=fake, **target)
        tok, caches = _start(cm)
        cache = getattr(cm.executor(BATCH), "weight_cache", None)
        before = decode_graph._counts(cache)
        with obs.session() as tel:
            _decode(cm, tok, caches)
        after = decode_graph._counts(cache)
        events = {key: child.value for key, child in
                  tel.metrics.counter("repro_cache_events_total")._series.items()}
        return decode_graph._Deltas.between(before, after), events, cm

    want, want_events, _ = run(False)
    got, events, cm = run(True)
    assert cm.decode_graphs.backend.replays == STEPS - 2
    assert got == want and events == want_events
    n_fused, by_fused = got.kernels[decode_graph.KERNELS.index(fused_decode)]
    n_ham, _ = got.kernels[decode_graph.KERNELS.index(xnor_matmul)]
    if weights == "prepared":
        assert n_fused == by_fused["b1"] > 0 and n_ham == 0
    else:
        assert n_ham > 0 and n_fused == 0 and got.lru[0] > 0

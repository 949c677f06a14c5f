"""The port's telemetry (repro_torch.obs) against the JAX package's
(repro.obs), on the CPU.

* **Recorder parity** — the same fake clock and the same sequence of
  spans, events, counters, gauges and histogram observations give the
  same JSONL, Chrome-trace JSON and Prometheus text, byte for byte.
* **Off by default, no-op when off** — with no active session every
  helper is one ``None`` check returning the shared ``NULL_SPAN``: no
  clock read and no ``torch.cuda`` call, on a whole serving run too.
* **The fence** — CPU tensors make no CUDA call; a (fake) CUDA tensor
  reaches ``torch.cuda.synchronize`` before the end stamp, and a failed
  synchronization raises out of the span.
* **Serving** — tracing on equals tracing off token for token; the
  compile-stage span names, the serving and fleet records (timings
  aside) and the counter values equal the JAX package's on the same
  trace; the serve CLI writes a trace and a snapshot that parse.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import compiler as jax_compiler
from repro import fleet as jax_fleet
from repro import obs as jax_obs
from repro.serving import Request as JaxRequest
from repro_torch import compiler, obs
from repro_torch import fleet as port_fleet
from repro_torch.launch import serve
from repro_torch.obs import trace as trace_lib
from repro_torch.obs.trace import NULL_SPAN, Tracer
from repro_torch.serving import Request
from test_torch_generate import op_by_op, pair

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MAX_LEN = 32
GEN = 4


@pytest.fixture(autouse=True)
def _no_leaked_session():
    """Every test starts and ends with telemetry off in both packages."""
    obs.stop()
    jax_obs.stop()
    yield
    obs.stop()
    jax_obs.stop()


class FakeClock:
    """Deterministic ns clock: each read advances by ``step``."""

    def __init__(self, step: int = 1000):
        self.t = 0
        self.step = step

    def __call__(self) -> int:
        self.t += self.step
        return self.t


# ---------------------------------------------------------------------------
# recorder parity: one script, both packages, byte-identical exports
# ---------------------------------------------------------------------------


def _serving_script(o, fence):
    """Every session helper, the way the serving stack calls them."""
    with o.span("compile", track="compile", engine="packed", model="tinyllama") as root:
        with o.span("compile.validate", track="compile"):
            pass
        with o.span("compile.map", track="compile"):
            pass
        with o.span("compile.program", track="compile") as sp:
            sp.fence(fence).set(programmed=7, program_s=0.25)
        root.set(programmed=7, program_s=0.25)
    o.event("request.submit", track="sched", rid=0, prompt_len=5, max_new_tokens=4, tick=0)
    o.count("repro_requests_submitted_total", 1, "client submissions")
    for i in range(3):
        with o.span("decode_tick", track="serve", engine="packed", k=2,
                    n_active=2 - i % 2, n_groups=1, n_pad=i % 2) as sp:
            sp.fence(fence)
            sp.set(cache_hits=i, cache_misses=0)
        o.observe("repro_tick_latency_seconds", sp.duration_s, "tick wall time",
                  engine="packed", k=2)
        o.count("repro_decoded_tokens_total", 2 - i % 2, "real slot-tokens decoded",
                engine="packed")
    o.gauge_set("repro_queue_depth", 3, "requests waiting")
    o.gauge_set("repro_kv_committed_tokens", 67.5, "KV tokens held")
    o.observe("repro_ttft_ticks", 5, "ticks to first token", buckets=o.TICK_BUCKETS)
    o.observe("repro_request_latency_ticks", 200, "ticks to a terminal status",
              buckets=o.TICK_BUCKETS, status="finished")
    o.cache_event("weight_cache", "miss")
    o.cache_event("weight_cache", "hit", 2)
    o.event("fleet.route", track="fleet", rid=1, replica=0, policy="prefix",
            matched_tokens=16, graft_length=15)
    o.count("repro_fleet_routed_total", 1, "requests routed", policy="prefix", replica=0)
    o.event("request.finish", track="sched", rid=0, tick=9, n_generated=4)


def _direct_script(o, fence):
    """The tracer and registry driven directly: deep nesting, attributes
    of several types, labelled families, gauge arithmetic, custom
    buckets and observations past the last bound."""
    tel = o.active()
    tr, reg = tel.tracer, tel.metrics
    with tr.span("outer", track="a", label="x", flag=True) as outer:
        tr.event("mark", track="b", values=[1, 2], ratio=0.5)
        with tr.span("mid", track="a") as mid:
            with tr.span("inner", track="c", d={"k": 1}):
                pass
            mid.fence(fence)
        outer.set(n=3, s="y")
    c = reg.counter("x_total", "things")
    c.inc()
    c.labels(engine="wdm").inc(2.5)
    c.labels(engine="packed", k=4).inc(1e16)
    g = reg.gauge("depth")
    g.set(5)
    g.inc(2)
    g.dec(0.25)
    h = reg.histogram("lat", "latency", buckets=(0.5, 1.0, 4.0))
    for v in (0.25, 0.5, 0.75, 3.0, 100.0):
        h.labels(k=4).observe(v)
    h.observe(2.0)


CASES = {"serving helpers": _serving_script, "tracer and registry": _direct_script}


def _exports(o, script, fence, out: Path) -> dict[str, bytes]:
    with o.session(clock=FakeClock(step=750)) as tel:
        script(o, fence)
    out.mkdir()
    paths = {k: str(out / k) for k in ("trace.json", "trace.jsonl", "metrics.txt")}
    tel.write(trace_out=paths["trace.json"], jsonl_out=paths["trace.jsonl"],
              metrics_out=paths["metrics.txt"])
    return {k: Path(p).read_bytes() for k, p in paths.items()}


@pytest.mark.parametrize("case", CASES)
def test_exports_equal_the_reference_byte_for_byte(case, tmp_path):
    want = _exports(jax_obs, CASES[case], np.zeros(2), tmp_path / "jax")
    got = _exports(obs, CASES[case], torch.zeros(2), tmp_path / "torch")
    for name in want:
        assert got[name] == want[name], name
    assert json.loads(got["trace.json"])["traceEvents"]


def test_queries_and_quantiles_equal_the_reference():
    """Span/event filters, durations, histogram cumulative counts, mean
    and quantiles read the same from both packages' recorders."""
    sides = {}
    for name, o in (("jax", jax_obs), ("torch", obs)):
        with o.session(clock=FakeClock()) as tel:
            _serving_script(o, np.zeros(1) if name == "jax" else torch.zeros(1))
        h = tel.metrics.histogram("repro_tick_latency_seconds").labels(engine="packed", k=2)
        sides[name] = (
            [(s.name, s.depth, s.duration_ns) for s in tel.tracer.spans()],
            [e.attrs for e in tel.tracer.events("request.submit")],
            [s.attrs for s in tel.tracer.spans("decode_tick")],
            h.cumulative(), h.mean, [h.quantile(q) for q in (0.0, 0.5, 1.0)],
            tel.metrics.counter("repro_cache_events_total").value,
        )
    assert sides["torch"] == sides["jax"]


@pytest.mark.parametrize("call,match", [
    (lambda o: o.MetricsRegistry().counter("c").inc(-1), "only go up"),
    (lambda o: o.MetricsRegistry().histogram("h", buckets=(2.0, 1.0)), "sorted, unique"),
    (lambda o: o.MetricsRegistry().histogram("h").labels().quantile(1.5), "quantile"),
    (lambda o: (lambda r: (r.counter("x"), r.gauge("x")))(o.MetricsRegistry()),
     "already registered as counter"),
    (lambda o: o.Tracer().span("open").__enter__().duration_ns, "has not exited"),
], ids=["counter down", "buckets", "quantile", "kind conflict", "open span"])
def test_errors_equal_the_reference(call, match):
    messages = []
    for o in (jax_obs, obs):
        with pytest.raises(ValueError, match=match) as e:
            call(o)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# session + disabled path
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_calls(monkeypatch):
    """Every public function of ``torch.cuda`` replaced by a recorder of
    its calls (nothing here may reach the card's runtime)."""
    calls = []
    for name in dir(torch.cuda):
        fn = getattr(torch.cuda, name)
        if name.startswith("_") or not callable(fn) or isinstance(fn, type):
            continue
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _name=name, **k: calls.append((_name, a)))
    return calls


@pytest.fixture
def clock_reads(monkeypatch):
    """Reads of the tracer's default clock, counted."""
    reads = []
    real = time.perf_counter_ns

    def counted():
        reads.append(1)
        return real()

    monkeypatch.setattr(trace_lib.time, "perf_counter_ns", counted)
    return reads


class TestSession:
    def test_off_by_default_helpers_are_noops(self, cuda_calls, clock_reads):
        assert not obs.enabled() and obs.active() is None
        # identity: the one shared no-op span, no allocation per call
        assert obs.span("tick", engine="packed") is NULL_SPAN
        assert obs.span("other") is NULL_SPAN
        with obs.span("tick") as sp:
            sp.set(k=4).fence(torch.zeros(2), {"a": [torch.ones(1)]})
        obs.event("x")
        obs.count("c", 2)
        obs.gauge_set("g", 1)
        obs.observe("h", 0.5)
        obs.cache_event("weight_cache", "hit")
        assert obs.active() is None   # nothing sprang into existence
        assert cuda_calls == [] and clock_reads == []

    def test_start_stop_and_session_scope(self):
        tel = obs.start()
        assert obs.active() is tel and obs.enabled()
        with obs.span("tick"):
            pass
        assert len(tel.tracer.spans("tick")) == 1
        assert obs.stop() is tel
        assert not obs.enabled()
        with obs.session() as tel2:
            assert obs.active() is tel2
        assert not obs.enabled()
        # a session replaced inside a scope is not stopped by the scope
        with obs.session():
            tel3 = obs.start()
        assert obs.active() is tel3
        obs.stop()

    def test_helpers_record_on_active_session(self):
        with obs.session() as tel:
            obs.count("repro_x_total", 2, engine="packed")
            obs.gauge_set("repro_g", 7)
            obs.observe("repro_h", 0.1, buckets=(1.0,))
            obs.event("mark", rid=3)
            obs.cache_event("weight_cache", "eviction")
        assert tel.metrics.counter("repro_x_total").value == 2
        assert tel.metrics.gauge("repro_g").value == 7
        assert tel.metrics.histogram("repro_h", buckets=(1.0,)).total == 1
        assert tel.tracer.events("mark")[0].attrs == {"rid": 3}
        assert tel.metrics.counter("repro_cache_events_total").labels(
            cache="weight_cache", kind="eviction").value == 1

    def test_disabled_serving_run_reads_no_clock_and_calls_no_cuda(
            self, cuda_calls, clock_reads):
        """A whole request trace through a ServingEngine with telemetry
        off: the tracer's clock is never read and no ``torch.cuda``
        function is called (the CPU run's own ops make none either)."""
        cfg = pair("tinyllama-1.1b")[2]
        from repro_torch.models import lm
        params = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        se = compiler.compile(cfg, params, compiler.HardwareTarget(engine="packed"),
                              device="cpu").serve(max_batch=2, max_len=MAX_LEN)
        rng = np.random.default_rng(0)
        for i in range(3):
            se.submit(Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, (3 + i,), np.int32),
                              max_new_tokens=GEN))
        se.drain()
        assert se.stats().ticks > 0
        assert cuda_calls == [] and clock_reads == []


# ---------------------------------------------------------------------------
# the fence
# ---------------------------------------------------------------------------


class TestFence:
    def test_cpu_tensors_make_no_cuda_call(self, cuda_calls):
        tr = Tracer(clock=FakeClock())
        with tr.span("work") as sp:
            sp.fence(torch.zeros(3), {"slot0": {"k": torch.ones(2), "v": [torch.ones(1)]}},
                     (torch.ones(2), 7, "not a tensor"))
        assert sp._fences == [] and sp.duration_ns == 1000
        assert cuda_calls == []

    def _fake_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: a fake one is not needed")
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            return torch.empty((2, 4), device="cuda")

    def test_a_cuda_tensor_reaches_synchronize_before_the_end_stamp(self, monkeypatch):
        fake = self._fake_cuda()
        events = []
        clock = FakeClock()
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda device=None: events.append(("sync", device, clock.t)))
        tr = Tracer(clock=clock)
        with tr.span("prefill") as sp:
            sp.fence({"slot0": {"k": torch.zeros(1), "v": fake}}, [fake])
        # one synchronization per CUDA device, after the start stamp and
        # before the end stamp
        assert events == [("sync", fake.device, 2000)]
        assert fake.device.type == "cuda" and sp.t_end_ns == 2000

    def test_a_failed_synchronization_raises_out_of_the_span(self, monkeypatch):
        fake = self._fake_cuda()

        def fail(device=None):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(torch.cuda, "synchronize", fail)
        tr = Tracer(clock=FakeClock())
        with pytest.raises(RuntimeError, match="illegal memory access"):
            with tr.span("decode_tick") as sp:
                sp.fence(fake)
        assert tr.spans() == []


# ---------------------------------------------------------------------------
# serving: tracing is invisible, and the records equal the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """TestServingIntegration's trace (tests/test_obs.py): the smoke
    tinyllama in BNN mode, three prompts of 3, 4 and 5 tokens."""
    jcfg, jparams, cfg, lm_model = pair("tinyllama-1.1b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, (3 + i,), np.int32) for i in range(3)]
    return jcfg, jparams, cfg, lm_model, prompts


def _drive(se, prompts, request_cls):
    states = [se.submit(request_cls(rid=i, prompt=p, max_new_tokens=GEN))
              for i, p in enumerate(prompts)]
    se.drain()
    return {st.rid: tuple(st.generated) for st in states}


def _port_serve(cfg, lm_model, prompts, target):
    se = compiler.compile(cfg, lm_model, target, device="cpu").serve(max_batch=2,
                                                                    max_len=MAX_LEN)
    return _drive(se, prompts, Request), se


TIMINGS = {"program_s"}


def _records(tel) -> list:
    """Every record without its timings: (type, name, track, depth,
    attrs)."""
    return [
        (type(r).__name__, r.name, r.track, getattr(r, "depth", None),
         {k: v for k, v in r.attrs.items() if k not in TIMINGS})
        for r in tel.tracer.records
    ]


def _metrics(tel) -> dict:
    """Counter and gauge values by series; histogram counts by series
    (bucket counts too, except for wall-clock histograms)."""
    out = {}
    for name, inst in tel.metrics._metrics.items():
        for key, child in inst._series.items():
            if inst.kind == "histogram":
                out[(name, key)] = (child.total, None if name.endswith("_seconds")
                                    else (child.counts, child.sum))
            else:
                out[(name, key)] = child.value
    return out


@pytest.mark.parametrize("k", [1, 2])
def test_tracing_is_bit_exact(model, k):
    """The hard gate: telemetry never changes a generated token."""
    _, _, cfg, lm_model, prompts = model
    target = compiler.HardwareTarget(engine="packed", group_size=k)
    plain, _ = _port_serve(cfg, lm_model, prompts, target)
    with obs.session() as tel:
        traced, se = _port_serve(cfg, lm_model, prompts, target)
    assert traced == plain and plain
    stats = se.stats()
    assert len(tel.tracer.spans("decode_tick")) == stats.ticks
    assert len(tel.tracer.spans("prefill")) == stats.prefills == len(prompts)


def test_compile_stage_spans_equal_the_reference(model):
    jcfg, jparams, cfg, lm_model, _ = model
    with jax_obs.session() as jtel:
        jax_compiler.compile(jcfg, jparams, jax_compiler.HardwareTarget(engine="packed"))
    with obs.session() as tel:
        cm = compiler.compile(cfg, lm_model, compiler.HardwareTarget(engine="packed"),
                              device="cpu")
    names = [s.name for s in tel.tracer.spans()]
    assert names == [s.name for s in jtel.tracer.spans()] == [
        "compile.validate", "compile.map", "compile.resolve", "compile.program", "compile",
    ]
    assert _records(tel) == _records(jtel)
    root = tel.tracer.spans("compile")[0]
    assert root.attrs["programmed"] == cm.programmed > 0
    assert root.attrs["program_s"] == cm.program_s
    assert all(s.depth == 1 for s in tel.tracer.spans()[:-1]) and root.depth == 0


def test_serving_records_and_counters_equal_the_reference(model):
    """The reference's ServingEngine (run op by op) and the port's on the
    same trace, both compiled inside a session: every span and event
    with its attributes (timings aside) and every counter, gauge and
    histogram count are equal."""
    jcfg, jparams, cfg, lm_model, prompts = model
    with op_by_op():
        with jax_obs.session() as jtel:
            jse = jax_compiler.compile(
                jcfg, jparams, jax_compiler.HardwareTarget(engine="packed", group_size=2)
            ).serve(max_batch=2, max_len=MAX_LEN)
            want = _drive(jse, prompts, JaxRequest)
    with obs.session() as tel:
        got, se = _port_serve(cfg, lm_model, prompts,
                              compiler.HardwareTarget(engine="packed", group_size=2))
    assert got == want
    assert _records(tel) == _records(jtel)
    assert _metrics(tel) == _metrics(jtel)
    m = tel.metrics
    stats = se.stats()
    assert m.counter("repro_decode_ticks_total").value == stats.ticks
    assert m.counter("repro_decoded_tokens_total").value == stats.decoded
    assert m.counter("repro_mmm_groups_total").value == stats.mmm_groups
    assert m.counter("repro_prefills_total").value == stats.prefills
    assert m.histogram("repro_tick_latency_seconds").total == stats.ticks
    assert m.histogram("repro_ttft_ticks").total == len(prompts)
    assert m.gauge("repro_queue_depth").value == stats.scheduler.queue_depth


@pytest.fixture(scope="module")
def fleet_models(model):
    """One compiled ``reference``-engine model per package (the JAX one
    jitted: routing counts tokens and ticks, never logits)."""
    jcfg, jparams, cfg, lm_model, _ = model
    return (jax_compiler.compile(jcfg, jparams, jax_compiler.HardwareTarget(engine="reference")),
            compiler.compile(cfg, lm_model, compiler.HardwareTarget(engine="reference"),
                             device="cpu"))


def _fleet_prompts(vocab: int) -> list[np.ndarray]:
    """Half the prompts share one 8-token prefix (tests/test_fleet.py's
    trace), so prefix routing grafts."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab, (8,), dtype=np.int32)
    return [np.concatenate([shared, rng.integers(1, vocab, (2 + i % 3,), np.int32)])
            if i % 2 == 0 else rng.integers(1, vocab, (5,), np.int32) for i in range(6)]


def _run_fleet(pkg_fleet, compiled, prompts, request_cls, scenario):
    if scenario == "prefix":
        fleet = pkg_fleet.FleetEngine(
            [pkg_fleet.Replica(r, compiled, max_batch=2, max_len=MAX_LEN) for r in range(2)],
            routing="prefix", block_size=4)
        for i, p in enumerate(prompts):
            fleet.submit(request_cls(rid=i, prompt=p, max_new_tokens=GEN))
            fleet.step()
    else:  # replica 0 degrades mid-serve and its requests fail over
        r0, r1 = (pkg_fleet.Replica(r, compiled, max_batch=4, max_len=MAX_LEN) for r in range(2))
        fleet = pkg_fleet.FleetEngine([r0, r1], routing="least-loaded")
        for i, p in enumerate(prompts[:4]):
            fleet.submit(request_cls(rid=i, prompt=p, max_new_tokens=GEN))
        fleet.step()
        fleet.step()
        r0.scheduler.degrade("synthetic fault")
        r0.serving.on_degrade("synthetic fault")
    fleet.drain()
    return fleet.stats()


@pytest.mark.parametrize("scenario", ["prefix", "failover"])
def test_fleet_records_and_counters_equal_the_reference(model, fleet_models, scenario):
    cfg = model[2]
    prompts = _fleet_prompts(cfg.vocab_size)
    jcm, cm = fleet_models
    with jax_obs.session() as jtel:
        jstats = _run_fleet(jax_fleet, jcm, prompts, JaxRequest, scenario)
    with obs.session() as tel:
        stats = _run_fleet(port_fleet, cm, prompts, Request, scenario)
    assert _records(tel) == _records(jtel)
    assert _metrics(tel) == _metrics(jtel)
    m = tel.metrics
    assert m.counter("repro_fleet_routed_total").value == stats.submitted
    assert m.counter("repro_fleet_prefix_hits_total").value == stats.prefix_hits
    assert m.counter("repro_fleet_failovers_total").value == stats.failovers
    grafted = sum(s.attrs["grafted"] for s in tel.tracer.spans("prefill"))
    assert grafted == stats.grafted_tokens == jstats.grafted_tokens
    assert len(tel.tracer.spans("decode_tick")) == stats.ticks
    if scenario == "prefix":
        assert stats.prefix_hits > 0 and grafted > 0
    else:
        assert stats.failovers > 0 and tel.tracer.events("fleet.degrade")
        assert m.gauge("repro_fleet_replicas_healthy").value == 1


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


_SAMPLE = re.compile(r'^[a-z_]+(\{([a-z_]+="[^"]*",?)+\})? -?[0-9.e+inf]+$')


def _parses_as_prometheus(text: str) -> bool:
    return all(line.startswith(("# HELP ", "# TYPE ")) or _SAMPLE.match(line)
               for line in text.splitlines())


def test_serve_cli_writes_trace_and_metrics(tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "tinyllama-1.1b",
         "--smoke", "--engine", "packed", "--device", "cpu", "--requests", "4",
         "--gen", "4", "--trace-out", str(trace), "--metrics-out", str(metrics)],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    assert f"wrote Chrome trace (chrome://tracing / Perfetto) -> {trace}" in proc.stdout
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"compile", "compile.program", "prefill", "decode_tick", "request.submit",
            "thread_name"} <= names
    text = metrics.read_text()
    assert _parses_as_prometheus(text), text
    assert 'repro_prefills_total{engine="packed"} 4' in text
    assert "repro_requests_submitted_total 4" in text


def test_serve_run_traced_equals_untraced_and_stops_its_session(tmp_path):
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--engine", "packed", "--device", "cpu",
            "--requests", "5", "--batch", "2", "--prompt-len", "12", "--gen", "5"]
    plain = serve.run(argv)
    traced = serve.run(argv + ["--metrics-out", str(tmp_path / "m.txt")])
    assert plain["telemetry"] is None and not obs.enabled()
    tel = traced["telemetry"]
    assert [s.generated for s in traced["states"]] == [s.generated for s in plain["states"]]
    stats = traced["stats"]
    assert len(tel.tracer.spans("decode_tick")) == stats.ticks
    assert tel.metrics.counter("repro_decode_ticks_total").value == stats.ticks
    assert (tmp_path / "m.txt").read_text() == tel.metrics.render()
    assert not (tmp_path / "trace.json").exists()


def test_lockstep_traces_compile_only(tmp_path):
    """The lockstep batch loop drives ``CompiledModel`` directly: its
    session holds the compile stages, no serving spans."""
    res = serve.run(["--arch", "tinyllama-1.1b", "--smoke", "--engine", "packed", "--device",
                     "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3",
                     "--trace-out", str(tmp_path / "trace.json")])
    names = [s.name for s in res["telemetry"].tracer.spans()]
    assert names[-1] == "compile" and "decode_tick" not in names
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]

"""Telemetry for the port's serving stack: tracing spans and serving
counters (counterpart of ``repro/obs``; span, event, track, attribute
and metric names are the reference's, so one dashboard reads both
packages' traces and snapshots).

Three pieces, threaded through every layer (compiler pipeline, serving
engine, request scheduler, weight caches, fleet, launch driver):

* :mod:`repro_torch.obs.trace`      — nestable wall-clock spans fenced
  by ``torch.cuda.synchronize``, JSON-lines + Chrome-trace export.
* :mod:`repro_torch.obs.metrics`    — counters / gauges / bounded
  histograms (TTFT, admission wait, tick latency, queue depth) rendered
  as a Prometheus-style text snapshot.
* :mod:`repro_torch.obs.crosscheck` — pairs traced decode ticks with
  their ``costmodel`` prices: the measured/modeled ratio per engine x K.

**Program ranges.** :func:`range` (``with obs.range("moe.experts"):``)
marks a layer boundary for ``torch.profiler``: while a profiler collects
it is a ``record_function`` range, recorded on the clock of the device's
kernels; otherwise it is one flag read returning the shared no-op span.
An enabled :func:`span` opens a range of its name too, while a profiler
collects. Ranges are not tracer records. :data:`RANGES` names them all.

**Off by default, near-zero when off.** Instrumentation sites call the
module-level helpers (:func:`span`, :func:`event`, :func:`observe`,
:func:`count`, :func:`cache_event`); with no active session each is one
``None`` check returning a shared no-op object — no clock reads, no
allocation and **no device synchronization** added to the decode hot
path (fences only synchronize on an enabled tracer). Telemetry never
changes generated tokens: tracing on vs off is bit-identical
(tests/test_torch_obs.py).

Usage::

    from repro_torch import obs

    tel = obs.start()                          # enable for this process
    compiled = compile(cfg, params, target)    # compile-stage spans
    se = compiled.serve(max_batch=8)
    ...                                        # per-tick spans + metrics
    tel.tracer.export_chrome("trace.json")     # chrome://tracing
    print(tel.metrics.render())                # Prometheus snapshot
    print(obs.format_report(obs.crosscheck_serving(se)))
    obs.stop()

or scoped: ``with obs.session() as tel: ...``.
"""

from __future__ import annotations

import contextlib
from typing import Callable

from repro_torch.obs import crosscheck  # noqa: F401
from repro_torch.obs.crosscheck import (  # noqa: F401
    TickCheck,
    crosscheck_serving,
    crosscheck_ticks,
    format_report,
)
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    TICK_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_SPAN,
    RANGES,
    Event,
    NullTracer,
    Span,
    Tracer,
)
from repro_torch.obs.trace import profiler_range as range  # noqa: F401


class Telemetry:
    """One telemetry session: a tracer and a metrics registry that live
    and die together (started by :func:`start` / :func:`session`)."""

    def __init__(self, clock: Callable[[], int] | None = None):
        self.tracer = Tracer(clock=clock)
        self.metrics = MetricsRegistry()

    def write(self, *, trace_out: str | None = None,
              jsonl_out: str | None = None,
              metrics_out: str | None = None) -> None:
        """Export whichever artifacts were requested."""
        if trace_out:
            self.tracer.export_chrome(trace_out)
        if jsonl_out:
            self.tracer.export_jsonl(jsonl_out)
        if metrics_out:
            self.metrics.export(metrics_out)


_ACTIVE: Telemetry | None = None


def active() -> Telemetry | None:
    """The current session, or ``None`` when telemetry is off."""
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def start(clock: Callable[[], int] | None = None) -> Telemetry:
    """Begin a telemetry session (replacing any previous one)."""
    global _ACTIVE
    _ACTIVE = Telemetry(clock=clock)
    return _ACTIVE


def stop() -> Telemetry | None:
    """End the session; returns it so callers can still export."""
    global _ACTIVE
    tel, _ACTIVE = _ACTIVE, None
    return tel


@contextlib.contextmanager
def session(clock: Callable[[], int] | None = None):
    """Scoped telemetry: ``with obs.session() as tel: ...``."""
    tel = start(clock=clock)
    try:
        yield tel
    finally:
        if _ACTIVE is tel:
            stop()


# ---------------------------------------------------------------------------
# Hot-path helpers — each is one None check when telemetry is off.
# ---------------------------------------------------------------------------


def span(name: str, *, track: str = "main", **attrs):
    """Open a span on the active tracer (shared no-op span when off)."""
    if _ACTIVE is None:
        return NULL_SPAN
    return _ACTIVE.tracer.span(name, track=track, **attrs)


def event(name: str, *, track: str = "main", **attrs) -> None:
    """Record an instantaneous event on the active tracer."""
    if _ACTIVE is not None:
        _ACTIVE.tracer.event(name, track=track, **attrs)


def count(name: str, n: float = 1.0, help: str = "", **labels) -> None:
    """Increment a counter on the active registry."""
    if _ACTIVE is not None:
        c = _ACTIVE.metrics.counter(name, help)
        (c.labels(**labels) if labels else c).inc(n)


def gauge_set(name: str, value: float, help: str = "", **labels) -> None:
    """Set a gauge on the active registry."""
    if _ACTIVE is not None:
        g = _ACTIVE.metrics.gauge(name, help)
        (g.labels(**labels) if labels else g).set(value)


def observe(name: str, value: float, help: str = "",
            buckets: tuple[float, ...] = DEFAULT_BUCKETS, **labels) -> None:
    """Observe into a histogram on the active registry."""
    if _ACTIVE is not None:
        h = _ACTIVE.metrics.histogram(name, help, buckets=buckets)
        (h.labels(**labels) if labels else h).observe(value)


def cache_event(cache: str, kind: str, n: int = 1) -> None:
    """Live cache counters (WeightCache / placement LRUs hook this on
    every hit/miss/eviction; one None check when telemetry is off)."""
    if _ACTIVE is not None:
        _ACTIVE.metrics.counter(
            "repro_cache_events_total",
            "prepared-weight and placement cache traffic",
        ).labels(cache=cache, kind=kind).inc(n)

"""Nestable tracing spans with JSON-lines and Chrome-trace export
(counterpart of ``repro/obs/trace.py``; the records and both exports are
the reference's, byte for byte).

The tracer is the wall-clock half of the telemetry subsystem
(:mod:`repro_torch.obs`): host code wraps a unit of work in
``with tracer.span("decode_tick", engine="wdm", k=4) as sp`` and the
tracer records when it ran, how long it took, how deep it nested and
whatever structured attributes the instrumentation attached. Two export
formats cover the two consumers:

* :meth:`Tracer.export_jsonl` — one JSON object per record, the
  machine-readable event log (crosscheck, benchmarks, ad-hoc grep).
* :meth:`Tracer.export_chrome` — the Chrome trace-event format, loadable
  in ``chrome://tracing`` / Perfetto for a visual timeline of compile
  stages and serving ticks.

Async-dispatch honesty: PyTorch returns before the card finishes (the
kernels launch on torch's current stream), so a naive span around a
CUDA call measures only the dispatch. A span therefore accepts
**fences** — ``sp.fence(caches)`` registers tensors (or dicts, lists
and tuples of them); at exit, before stamping the span's end
time, the tracer calls ``torch.cuda.synchronize`` on each CUDA device
among them, so the device work is inside the span. CPU tensors cost
nothing, and a failed synchronization raises as it would anywhere else.
Fencing only happens on an enabled tracer: the :class:`NullTracer`'s
span ignores ``fence`` entirely, so disabled telemetry adds **no host
synchronization** to the hot path (and no timestamps, no allocation —
one shared no-op span object is returned).

The clock is injectable (``Tracer(clock=...)``) so golden-output tests
are deterministic; the default is ``time.perf_counter_ns``.

Program ranges put the port's layer boundaries on the profiler's clock,
beside the device's kernels: :func:`profiler_range` returns
``torch.profiler.record_function(name)`` while a profiler collects and
the shared no-op span otherwise (one flag read, no ``record_function``
object, no dispatcher call), and a span opens a range of its own name
while a profiler collects. Ranges are not tracer records: the records
and exports stay the reference's. :data:`RANGES` lists every range name
the port opens.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable

import torch
import torch.autograd.profiler as autograd_profiler

# every profiler range the port opens: ``obs.range``'s sites, then the
# spans, each of which opens a range of its name while a profiler collects
RANGES = (
    "scheduler.step", "model.prefill", "model.decode_step", "lm.head",
    "moe.route", "moe.dispatch", "moe.experts", "moe.combine", "dense.latent_weight",
    "moe.shared", "ssm.mixer",
    "compile", "compile.validate", "compile.map", "compile.resolve", "compile.program",
    "remap", "prefill", "decode_tick", "degraded_tick",
)


@dataclasses.dataclass
class Span:
    """One traced unit of work (open until the ``with`` block exits)."""

    name: str
    track: str                   # timeline row ("compile", "serve", ...)
    t_start_ns: int              # tracer-relative start
    depth: int                   # nesting depth at entry (0 = top level)
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    t_end_ns: int | None = None  # stamped at exit, after fences drain
    _fences: list[Any] = dataclasses.field(default_factory=list, repr=False)

    def set(self, **attrs) -> "Span":
        """Attach structured attributes (merged over the entry attrs)."""
        self.attrs.update(attrs)
        return self

    def fence(self, *values) -> "Span":
        """Register tensors (or containers of them) whose devices are
        synchronized before the end timestamp — the span then covers the
        device work it dispatched, not just the host-side enqueue."""
        self._fences.extend(values)
        return self

    @property
    def duration_ns(self) -> int:
        if self.t_end_ns is None:
            raise ValueError(f"span {self.name!r} has not exited yet")
        return self.t_end_ns - self.t_start_ns

    @property
    def duration_s(self) -> float:
        return self.duration_ns * 1e-9


@dataclasses.dataclass(frozen=True)
class Event:
    """One instantaneous record (request lifecycle transitions etc.)."""

    name: str
    track: str
    t_ns: int
    attrs: dict[str, Any]


class _NullSpan:
    """The shared no-op span: disabled tracing costs one attribute
    lookup and a context-manager protocol round trip, nothing else."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def fence(self, *values) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


def _collecting_reader() -> Callable[[], bool]:
    """Whether a profiler collects: torch's Python-side flag (one
    attribute read) where this torch has it, else its C++ state."""
    if hasattr(autograd_profiler, "_is_profiler_enabled"):
        return lambda: autograd_profiler._is_profiler_enabled
    return torch._C._autograd._profiler_enabled


profiler_collecting = _collecting_reader()


def profiler_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler collects, else the shared :data:`NULL_SPAN`."""
    if profiler_collecting():
        return torch.profiler.record_function(name)
    return NULL_SPAN


class NullTracer:
    """The disabled recorder: every call is a no-op, ``span`` returns
    the shared :data:`NULL_SPAN` (no allocation, no clock read, no
    device synchronization)."""

    enabled = False

    def span(self, name: str, *, track: str = "main", **attrs) -> _NullSpan:
        return NULL_SPAN

    def event(self, name: str, *, track: str = "main", **attrs) -> None:
        return None


def _cuda_devices(values) -> list[torch.device]:
    """The CUDA devices of the tensors in ``values`` (tensors, dicts,
    lists and tuples, nested), each once."""
    devices: list[torch.device] = []
    stack = list(values)
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda" and v.device not in devices:
                devices.append(v.device)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
    return devices


class _OpenSpan:
    """Context manager binding one :class:`Span` to its tracer stack (and,
    while a profiler collects, to a profiler range of the span's name)."""

    __slots__ = ("tracer", "span", "range")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer = tracer
        self.span = span
        self.range = None

    def __enter__(self) -> Span:
        self.tracer._stack.append(self.span)
        if profiler_collecting():
            self.range = torch.profiler.record_function(self.span.name)
            self.range.__enter__()
        return self.span

    def __exit__(self, *exc) -> bool:
        sp = self.span
        try:
            if sp._fences:
                for device in _cuda_devices(sp._fences):
                    torch.cuda.synchronize(device)
                sp._fences.clear()
            sp.t_end_ns = self.tracer._now()
            self.tracer._stack.pop()
            self.tracer.records.append(sp)
        finally:
            if self.range is not None:
                self.range.__exit__(None, None, None)
                self.range = None
        return False


class Tracer:
    """Records nestable spans and instant events on a relative clock.

    ``records`` holds finished spans and events in completion order —
    a child span lands before its parent, matching Chrome-trace
    expectations. Open spans live on a stack; ``depth`` is the nesting
    level at entry.
    """

    enabled = True

    def __init__(self, clock: Callable[[], int] | None = None):
        self._clock = clock or time.perf_counter_ns
        self._t0 = self._clock()
        self._stack: list[Span] = []
        self.records: list[Span | Event] = []

    def _now(self) -> int:
        return self._clock() - self._t0

    def span(self, name: str, *, track: str = "main", **attrs) -> _OpenSpan:
        """Open a span; use as ``with tracer.span("x", k=4) as sp``."""
        return _OpenSpan(
            self,
            Span(
                name=name,
                track=track,
                t_start_ns=self._now(),
                depth=len(self._stack),
                attrs=dict(attrs),
            ),
        )

    def event(self, name: str, *, track: str = "main", **attrs) -> None:
        """Record one instantaneous event."""
        self.records.append(
            Event(name=name, track=track, t_ns=self._now(), attrs=dict(attrs))
        )

    # -- queries -------------------------------------------------------------

    def spans(self, name: str | None = None) -> list[Span]:
        out = [r for r in self.records if isinstance(r, Span)]
        return out if name is None else [s for s in out if s.name == name]

    def events(self, name: str | None = None) -> list[Event]:
        out = [r for r in self.records if isinstance(r, Event)]
        return out if name is None else [e for e in out if e.name == name]

    # -- export --------------------------------------------------------------

    def to_records(self) -> list[dict]:
        """Plain-dict view of every record (the JSONL rows)."""
        rows = []
        for r in self.records:
            if isinstance(r, Span):
                rows.append({
                    "type": "span",
                    "name": r.name,
                    "track": r.track,
                    "ts_us": r.t_start_ns / 1e3,
                    "dur_us": r.duration_ns / 1e3,
                    "depth": r.depth,
                    "attrs": r.attrs,
                })
            else:
                rows.append({
                    "type": "event",
                    "name": r.name,
                    "track": r.track,
                    "ts_us": r.t_ns / 1e3,
                    "attrs": r.attrs,
                })
        return rows

    def export_jsonl(self, path: str) -> int:
        """One JSON object per line; returns the record count."""
        rows = self.to_records()
        with open(path, "w") as f:
            for row in rows:
                f.write(json.dumps(row, default=str) + "\n")
        return len(rows)

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event document (``chrome://tracing`` /
        Perfetto): complete ("X") events for spans, instant ("i") for
        events, one named thread per track."""
        tids: dict[str, int] = {}

        def tid(track: str) -> int:
            if track not in tids:
                tids[track] = len(tids)
            return tids[track]

        trace_events: list[dict] = []
        for r in self.records:
            if isinstance(r, Span):
                trace_events.append({
                    "name": r.name, "ph": "X", "pid": 0, "tid": tid(r.track),
                    "ts": r.t_start_ns / 1e3, "dur": r.duration_ns / 1e3,
                    "args": dict(r.attrs),
                })
            else:
                trace_events.append({
                    "name": r.name, "ph": "i", "s": "t", "pid": 0,
                    "tid": tid(r.track), "ts": r.t_ns / 1e3,
                    "args": dict(r.attrs),
                })
        meta = [
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": n,
             "args": {"name": track}}
            for track, n in tids.items()
        ]
        return {"traceEvents": meta + trace_events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> int:
        """Write the Chrome-trace JSON; returns the span+event count."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1, default=str)
        return len(self.records)

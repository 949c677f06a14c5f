"""Counters, gauges and bounded histograms with a Prometheus-style
text snapshot (the port's own copy of ``repro/obs/metrics.py``, which
has no jax in it: the same names, buckets and render, so one dashboard
reads both packages' snapshots).

The metrics registry is the aggregate half of the telemetry subsystem
(:mod:`repro_torch.obs`): where the tracer records *each* tick, the registry
keeps distributions and running totals — TTFT, admission wait, tick
latency, queue depth, cache hits — cheap enough to leave on for a whole
serving run and render at the end:

    reg = MetricsRegistry()
    reg.counter("repro_ticks_total", "decode ticks").inc()
    reg.histogram("repro_tick_latency_seconds", "tick wall time")\\
       .labels(engine="wdm", k=4).observe(0.0012)
    print(reg.render())          # Prometheus text exposition format

Design constraints (mirroring the zero-dependency premise):

* **Bounded**: a histogram is a fixed bucket vector + count + sum —
  observing a million ticks costs the same memory as observing ten.
* **Labeled**: every instrument supports ``.labels(engine="wdm")``
  child series, keyed by sorted (name, value) tuples, so one metric
  covers an engine x K grid without string formatting on the hot path.
* **Deterministic render**: metrics and series print sorted, so golden
  tests can compare the full exposition text.
"""

from __future__ import annotations

import math

# default latency buckets (seconds): 100us .. 10s, roughly log-spaced
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# small-integer buckets (ticks, queue depths)
TICK_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Instrument:
    """Shared label plumbing: an instrument is a family of child series
    keyed by label tuples; the bare instrument is the unlabeled child."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict[tuple, object] = {}

    def labels(self, **labels):
        key = _label_key(labels)
        child = self._series.get(key)
        if child is None:
            child = self._new_child()
            self._series[key] = child
        return child

    def _child(self):
        return self.labels()

    def _new_child(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _render_series(self, key: tuple, child) -> list[str]:  # pragma: no cover
        raise NotImplementedError

    def render(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._series):
            lines.extend(self._render_series(key, self._series[key]))
        return lines


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        self.value += n


class Counter(_Instrument):
    """Monotonic running total."""

    kind = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, n: float = 1.0) -> None:
        self._child().inc(n)

    @property
    def value(self) -> float:
        """Sum across every labeled series."""
        return sum(c.value for c in self._series.values())

    def _render_series(self, key, child) -> list[str]:
        return [f"{self.name}{_label_str(key)} {_num(child.value)}"]


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Gauge(_Instrument):
    """Point-in-time value (queue depth, running slots, KV commitment)."""

    kind = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._child().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._child().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._child().dec(n)

    @property
    def value(self) -> float:
        return self._child().value

    def _render_series(self, key, child) -> list[str]:
        return [f"{self.name}{_label_str(key)} {_num(child.value)}"]


class _HistogramChild:
    __slots__ = ("buckets", "counts", "total", "sum")

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)   # per-bucket (non-cumulative)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.total += 1
        self.sum += v
        for i, bound in enumerate(self.buckets):
            if v <= bound:
                self.counts[i] += 1
                return
        # beyond the last bound: lands only in the implicit +Inf bucket

    def cumulative(self) -> list[int]:
        """Prometheus-style cumulative counts per ``le`` bound (without
        the trailing +Inf, which equals ``total``)."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the
        bucket holding the q-th observation; +inf if it lies past the
        last bound)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.total == 0:
            return 0.0
        rank = q * self.total
        for bound, cum in zip(self.buckets, self.cumulative()):
            if cum >= rank:
                return bound
        return math.inf


class Histogram(_Instrument):
    """Bounded-bucket distribution (fixed memory, any observation count)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"histogram buckets must be sorted, unique and non-empty, "
                f"got {buckets!r}"
            )
        self.buckets = tuple(float(b) for b in buckets)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self._child().observe(v)

    @property
    def total(self) -> int:
        return sum(c.total for c in self._series.values())

    def _render_series(self, key, child) -> list[str]:
        lines = []
        for bound, cum in zip(child.buckets, child.cumulative()):
            labels = _label_str(key + (("le", _num(bound)),))
            lines.append(f"{self.name}_bucket{labels} {cum}")
        inf_labels = _label_str(key + (("le", "+Inf"),))
        lines.append(f"{self.name}_bucket{inf_labels} {child.total}")
        lines.append(f"{self.name}_sum{_label_str(key)} {_num(child.sum)}")
        lines.append(f"{self.name}_count{_label_str(key)} {child.total}")
        return lines


def _num(v: float) -> str:
    """Render 4.0 as "4" but keep real fractions — Prometheus accepts
    both; the short form keeps golden outputs readable."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """Named instruments, memoized by name, rendered sorted.

    ``counter``/``gauge``/``histogram`` create-or-return, so
    instrumentation sites can call them unconditionally; re-registering
    a name as a different kind is a hard error (two call sites fighting
    over one metric name is a bug worth surfacing).
    """

    def __init__(self):
        self._metrics: dict[str, _Instrument] = {}

    def _get(self, cls, name: str, help: str, **kw):
        inst = self._metrics.get(name)
        if inst is None:
            inst = cls(name, help, **kw)
            self._metrics[name] = inst
        elif not isinstance(inst, cls):
            raise ValueError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {cls.kind}"
            )
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Instrument | None:
        return self._metrics.get(name)

    def render(self) -> str:
        """The Prometheus text exposition snapshot (deterministic)."""
        lines = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + ("\n" if lines else "")

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.render())

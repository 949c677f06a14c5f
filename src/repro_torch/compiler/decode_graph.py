"""The decode step as a CUDA graph (``CompiledModel.decode_step``).

A decode step launches every kernel of every layer from Python: ~3200
launches for internvl2-1b at full depth, ~270 for one qwen3-moe layer,
each costing the host far more than the card. While a caller keeps its
caches, the step's shapes and addresses stay fixed (a lockstep wave, a
serving pool whose every slot is busy), so :class:`DecodeGraphs`
captures the step into a ``torch.cuda.CUDAGraph`` once and replays it.
No kernel changes: each runs inside the graph as it is launched eagerly.

* **Key**: the token's and the position's shapes, ``(data_ptr, shape,
  stride, dtype)`` of every cache tensor, and the executor. Token and
  position *values* are not in it: they go into the graph's own device
  buffers before each replay (``copy_``, or ``fill_`` for a Python int).
  The graph writes the caller's caches in place, as the eager step does,
  and the caller gets its own copy of the logits.
* **When**: a key is captured on its second call in a row; the first
  runs eagerly and is the capture's warm-up. A key that changes on every
  call is never captured. At most :data:`MAX_GRAPHS` graphs are kept,
  the least recently used reset when evicted. No caller's tensor is
  held.
* **Eager**, with a reason, wherever a replay could differ from the
  Python it stands for: the device has no graphs (``device``); the
  engine is not the fault-free ``packed`` one (``engine``: a faulty
  engine sweeps, a simulator draws noise); a cache is not a plain tensor
  (``sharded``); autograd is on at the call (``grad``); ``lm._mix_step``,
  ``lm._ffn_residual`` or ``lm._logits`` is not the module's own
  (``patched``: a wrapper must see every step); and a key's first call
  (``first_sight``). Every stack's step captures: attention, Mamba-2,
  the hybrid and MoE (chip_smoke.py's decode graph phase). ``CompiledModel`` drops every graph when its
  weights change (``refresh_faults``, ``remap``).
* **Counters**: the kernel wrappers' launch counts and the weight
  cache's hits, misses and evictions that the captured step's Python
  made are added again on every replay, so they read as eagerly.
  ``model_decode_graph_total{outcome="replay"|"capture"|"eager"}``
  (``eager`` with its ``reason``) counts each step.

A replayed step emits no inner profiler ranges (``moe.*``, ``lm.head``):
only ``model.decode_step`` around it, whose kernels the profiler
attributes to the graph's launch.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable

import torch

from repro_torch import obs
from repro_torch.core.engine import PackedEngine
from repro_torch.kernels import bitlinear, flash_attention, fused_decode, wdm_mmm, xnor_matmul
from repro_torch.models import lm as lm_lib

MAX_GRAPHS = 4
# the kernel wrappers' module-level launch counters
KERNELS = (fused_decode, xnor_matmul, flash_attention, bitlinear, wdm_mmm)
# the functions a captured step runs through; anything else in their
# place (a test's monkeypatch, a recording hook) runs eagerly
OWN_STEP = (lm_lib._mix_step, lm_lib._ffn_residual, lm_lib._logits)

COUNTER = "model_decode_graph_total"
COUNTER_HELP = "decode steps by CUDA-graph outcome"


class CudaGraphs:
    """``torch.cuda.CUDAGraph`` capture on a side stream, each graph with
    its own memory pool; the backend :class:`DecodeGraphs` uses unless
    given another (the CPU tests inject one)."""

    def __init__(self):
        self._streams: dict[torch.device, torch.cuda.Stream] = {}

    def usable(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
            # cuBLAS sets up a handle and workspace per stream on its
            # first call: do that here, outside any capture
            with torch.cuda.stream(stream):
                for dtype in (torch.float32, torch.bfloat16):
                    a = torch.ones((16, 16), dtype=dtype, device=device)
                    torch.mm(a, a)
            torch.cuda.current_stream(device).wait_stream(stream)
        return stream

    def capture(self, fn: Callable[[], Any], device: torch.device):
        """``(graph, fn())`` with ``fn``'s launches recorded, not run."""
        with torch.cuda.device(device):
            stream = self._stream(device)
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                graph.capture_begin()
                try:
                    out = fn()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
            current.wait_stream(stream)
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()

    def reset(self, graph) -> None:
        graph.reset()


def _counts(cache) -> tuple:
    """The counters a step's Python moves: per kernel wrapper its
    launches and launches by variant; the weight cache's traffic."""
    kernels = tuple((k.launches, dict(k.launches_by_variant)) for k in KERNELS)
    lru = (cache.lru.hits, cache.lru.misses, cache.lru.evictions) if cache is not None else None
    return kernels, lru


@dataclasses.dataclass
class _Deltas:
    """What one captured step added to :func:`_counts`."""

    kernels: tuple
    lru: tuple | None

    @classmethod
    def between(cls, before: tuple, after: tuple) -> "_Deltas":
        kernels = tuple(
            (n1 - n0, {v: c - by0[v] for v, c in by1.items()})
            for (n0, by0), (n1, by1) in zip(before[0], after[0])
        )
        lru = None if after[1] is None else tuple(a - b for a, b in zip(after[1], before[1]))
        return cls(kernels, lru)

    def apply(self, cache) -> None:
        for k, (n, by) in zip(KERNELS, self.kernels):
            k.launches += n
            for v, c in by.items():
                k.launches_by_variant[v] += c
        if self.lru is not None and cache is not None:
            cache.lru.count(*self.lru)


@dataclasses.dataclass
class _Graph:
    graph: Any
    tok: torch.Tensor       # the step's token buffer
    pos: torch.Tensor       # its position buffer
    logits: torch.Tensor    # its output, in the graph's pool
    deltas: _Deltas
    cache: Any              # the executor's weight cache, or None
    held: list              # weight-cache entries the step may read


def _shape(x) -> tuple:
    if hasattr(x, "shape"):
        return tuple(x.shape)
    return tuple(torch.as_tensor(x).shape)


def _load(buf: torch.Tensor, value) -> None:
    """A token or position value into its device buffer."""
    if isinstance(value, int):
        buf.fill_(value)
    else:
        buf.copy_(torch.as_tensor(value))


class DecodeGraphs:
    """The CUDA graphs of one ``CompiledModel``'s decode steps (module
    docstring): :meth:`step` runs one step, replayed, captured or eager."""

    def __init__(self, backend=None):
        self.backend = backend if backend is not None else CudaGraphs()
        self._graphs: collections.OrderedDict[tuple, _Graph] = collections.OrderedDict()
        self._last: tuple | None = None

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        """Reset and drop every graph (the weights changed under them)."""
        while self._graphs:
            self.backend.reset(self._graphs.popitem(last=False)[1].graph)
        self._last = None

    def _eager_reason(self, cm, caches: dict, grad: bool) -> str | None:
        if not self.backend.usable(cm.device):
            return "device"
        if type(cm.engine) is not PackedEngine:
            return "engine"
        if grad:
            return "grad"
        if (lm_lib._mix_step, lm_lib._ffn_residual, lm_lib._logits) != OWN_STEP:
            return "patched"
        if any(type(t) is not torch.Tensor for kv in caches.values() for t in kv.values()):
            return "sharded"
        return None

    def step(self, cm, token, pos, caches: dict, *, grad: bool = False):
        """One decode step of ``cm`` (``lm.decode_step``'s arguments and
        result); ``grad``: autograd was on at the call."""
        reason = self._eager_reason(cm, caches, grad)
        if reason is not None:
            self._last = None
            return self._eager(cm, token, pos, caches, reason)
        ex = cm.executor(int(_shape(token)[0]))
        key = (
            _shape(token), _shape(pos), ex,
            tuple((slot, name, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for slot, kv in caches.items() for name, t in kv.items()),
        )
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
            obs.count(COUNTER, 1, COUNTER_HELP, outcome="replay")
            _load(g.tok, token)
            _load(g.pos, pos)
            self.backend.replay(g.graph)
            g.deltas.apply(g.cache)
            return g.logits.clone(), caches
        if key != self._last:
            self._last = key
            return self._eager(cm, token, pos, caches, "first_sight")
        obs.count(COUNTER, 1, COUNTER_HELP, outcome="capture")
        g = self._capture(cm, ex, token, pos, caches)
        self._graphs[key] = g
        while len(self._graphs) > MAX_GRAPHS:
            self.backend.reset(self._graphs.popitem(last=False)[1].graph)
        self.backend.replay(g.graph)
        return g.logits.clone(), caches

    def _eager(self, cm, token, pos, caches: dict, reason: str):
        obs.count(COUNTER, 1, COUNTER_HELP, outcome="eager", reason=reason)
        token = cm._tokens(token)
        pos = torch.as_tensor(pos).to(device=cm.device, dtype=torch.int64)
        ex = cm.executor(int(token.shape[0]))
        return lm_lib.decode_step(cm.params, token, pos, caches, cm.cfg, engine=ex)

    def _capture(self, cm, ex, token, pos, caches: dict) -> _Graph:
        tok = torch.empty(_shape(token), dtype=torch.int64, device=cm.device)
        pos_buf = torch.empty(_shape(pos), dtype=torch.int64, device=cm.device)
        _load(tok, token)
        _load(pos_buf, pos)
        cache = getattr(ex, "weight_cache", None)
        # an entry the step reads must outlive its eviction from the cache
        held = cache.lru.values() if cache is not None else []
        before = _counts(cache)
        graph, (logits, _) = self.backend.capture(
            lambda: lm_lib.decode_step(cm.params, tok, pos_buf, caches, cm.cfg, engine=ex),
            cm.device,
        )
        deltas = _Deltas.between(before, _counts(cache))
        if cache is not None:
            held += cache.lru.values()
        return _Graph(graph, tok, pos_buf, logits, deltas, cache, held)

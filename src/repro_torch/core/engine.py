"""Execution-engine registry (counterpart of ``repro/core/engine.py``).

Every engine computes the same XNOR+popcount contract (Eq. 1) and is
therefore bit-exact and swappable. An :class:`Engine` executes ±1
binary matmuls::

    binary_vmm(a_signs, w)         # (..., m) x (m, n) -> (..., n)
    binary_mmm(groups, w)          # (G, K, m) x (m, n) -> (G, K, n)

Two-phase program/execute contract: ``prepare(w_signs)`` runs the
weight-side transforms once (bit-packing for ``packed``) and returns a
:class:`PreparedWeights` artifact; ``binary_vmm``/``binary_mmm`` accept
raw ±1 weights or that artifact, and the raw path delegates through
``prepare``, so prepared and raw execution are bit-identical by
construction. ``prepare_cached`` memoizes programming on the identity
of the weight tensor in a bounded :class:`WeightCache`.

This slice registers the main-path backends:

=============  ==========================================  ================
name           models                                      prepared artifact
=============  ==========================================  ================
``reference``  Eq. 1 as a plain ±1 matmul (ground truth)   ±1 signs
``packed``     bit-packed XNOR+popcount CUDA kernels       int32 words
=============  ==========================================  ================

``tacitmap``, ``wdm``, ``tiled`` and ``custbinarymap`` arrive with later
slices (:data:`PENDING_ENGINES`).
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any, Callable, Protocol, runtime_checkable

import torch

from repro_torch import obs
from repro_torch.core import bnn
from repro_torch.core.crossbar import EPCM_TILE, OPCM_TILE, CrossbarSpec

# engines of the reference that later slices of the port bring
PENDING_ENGINES = {
    "tacitmap": "the paper-simulator slice",
    "wdm": "the paper-simulator slice",
    "tiled": "the paper-simulator slice (mapping plans)",
    "custbinarymap": "the paper-simulator slice",
}


# ---------------------------------------------------------------------------
# Prepared weights (the programming-phase artifact) + caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PreparedWeights:
    """Weights programmed into one engine's resident execution form.

    ``data`` is the engine's tensor (±1 signs, or int32 words); ``m`` and
    ``n`` are the logical weight dims; ``aux`` is hashable host-side
    metadata (unused by this slice's engines).
    """

    engine: str          # name of the backend that programmed this
    m: int               # logical contraction length
    n: int               # stored weight vectors (output columns)
    data: Any            # engine-specific tensor
    aux: Any = None


class LRUCache:
    """Small bounded LRU with hit/miss/eviction counters (host-side).

    A ``name`` makes the counters *live*: every hit/miss/eviction is
    mirrored into the active telemetry session's metrics registry
    (``repro_cache_events_total{cache=<name>,kind=...}``) — one ``None``
    check per event when telemetry is off. The ``stats`` snapshot stays
    the source of truth either way.
    """

    def __init__(self, maxsize: int = 32, name: str | None = None):
        if maxsize < 1:
            raise ValueError(f"cache maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self.name = name
        self._store: OrderedDict[Any, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        try:
            value = self._store[key]
        except KeyError:
            self.misses += 1
            if self.name is not None:
                obs.cache_event(self.name, "miss")
            return default
        self._store.move_to_end(key)
        self.hits += 1
        if self.name is not None:
            obs.cache_event(self.name, "hit")
        return value

    def put(self, key, value) -> None:
        self._store[key] = value
        self._store.move_to_end(key)
        while len(self._store) > self.maxsize:
            self._store.popitem(last=False)
            self.evictions += 1
            if self.name is not None:
                obs.cache_event(self.name, "eviction")

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key) -> bool:
        return key in self._store

    @property
    def stats(self) -> dict[str, int]:
        return {
            "size": len(self._store),
            "maxsize": self.maxsize,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }


class WeightCache:
    """Prepared-weight cache keyed by weight-tensor *identity*.

    Each entry keeps a strong reference to its key tensor, so an
    ``id()`` can never be recycled while the entry is alive; a replaced
    weight is a guaranteed miss and its stale entry ages out of the LRU.
    """

    def __init__(self, maxsize: int = 32):
        self._lru = LRUCache(maxsize, name="weight_cache")

    def get(self, w) -> PreparedWeights | None:
        entry = self._lru.get(id(w))
        if entry is not None and entry[0] is w:
            return entry[1]
        return None

    def put(self, w, pw: PreparedWeights) -> None:
        self._lru.put(id(w), (w, pw))

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def stats(self) -> dict[str, int]:
        return self._lru.stats


@dataclasses.dataclass(frozen=True)
class EngineInfo:
    """Capability/cost metadata for one backend (the capability matrix)."""

    name: str
    description: str
    hardware: str                 # what physical substrate this models
    native_mmm: bool = False      # executes K input vectors per step (WDM)
    packed: bool = False          # bit-packed operands (1 bit / lane)
    default_spec: str = "ePCM"    # which tile catalogue entry it defaults to


@runtime_checkable
class Engine(Protocol):
    """The execution contract every backend implements.

    ``binary_vmm``/``binary_mmm`` consume ±1-valued activations against
    raw ±1 weights or a :class:`PreparedWeights` from this engine's
    ``prepare``, and return the exact ±1 dot products (integer valued;
    the carrier dtype may differ per backend — callers cast).
    """

    name: str
    info: EngineInfo
    spec: CrossbarSpec

    def prepare(self, w_signs) -> PreparedWeights: ...

    def binary_vmm(self, a_signs: torch.Tensor, w) -> torch.Tensor: ...

    def binary_mmm(self, groups: torch.Tensor, w) -> torch.Tensor: ...

    def steps_for(self, m: int, n: int, n_inputs: int) -> int: ...

    def preferred_group_size(self) -> int: ...


class _EngineBase:
    """Shared plumbing: spec binding, the two-phase program/execute
    contract, MMM-via-VMM fallback, weight cache.

    Subclasses implement ``_program`` (weight signs -> resident tensor)
    and ``_vmm_prepared`` (execute against the artifact).
    """

    info: EngineInfo

    def __init__(self, spec: CrossbarSpec | None = None):
        default = OPCM_TILE if self.info.default_spec == "oPCM" else EPCM_TILE
        self.spec = spec or default
        self.weight_cache = WeightCache()

    @property
    def name(self) -> str:
        return self.info.name

    # -- programming phase --------------------------------------------------

    def _program(self, w_signs: torch.Tensor):
        """Engine-specific weight compilation; default: the ±1 signs."""
        return w_signs

    def prepare(self, w_signs) -> PreparedWeights:
        """Program ±1 weights (m, n) into this engine's resident form.
        Idempotent on an artifact this engine programmed."""
        if isinstance(w_signs, PreparedWeights):
            return self._check_prepared(w_signs)
        m, n = w_signs.shape
        return PreparedWeights(
            engine=self.name, m=int(m), n=int(n), data=self._program(w_signs)
        )

    def prepare_cached(self, w_signs, key=None) -> PreparedWeights:
        """``prepare`` memoized on the identity of ``key`` (default: the
        weight tensor). ``w_signs`` may be a zero-arg callable producing
        the signs; it is only invoked on a cache miss."""
        if isinstance(w_signs, PreparedWeights):
            return self._check_prepared(w_signs)
        lazy = callable(w_signs)
        if key is None:
            if lazy:
                raise ValueError("a callable w_signs needs an explicit cache key")
            key = w_signs
        pw = self.weight_cache.get(key)
        if pw is None:
            pw = self.prepare(w_signs() if lazy else w_signs)
            self.weight_cache.put(key, pw)
        return pw

    def _check_prepared(self, pw: PreparedWeights) -> PreparedWeights:
        if pw.engine != self.name:
            raise ValueError(
                f"prepared weights were programmed for engine {pw.engine!r}; "
                f"this engine is {self.name!r} — re-run prepare()"
            )
        return pw

    def cache_stats(self) -> dict[str, dict[str, int]]:
        """Hit/miss counters for every cache this engine maintains."""
        return {"weight_cache": self.weight_cache.stats}

    # -- execution phase ----------------------------------------------------

    def _check_operands(self, a_signs: torch.Tensor, pw: PreparedWeights) -> PreparedWeights:
        if a_signs.shape[-1] != pw.m:
            raise ValueError(
                f"activation length {a_signs.shape[-1]} does not match the "
                f"prepared weights' m={pw.m} (engine {self.name}) — wrong "
                f"artifact for this projection?"
            )
        return pw

    def binary_vmm(self, a_signs: torch.Tensor, w) -> torch.Tensor:
        """(..., m) x (m, n) -> (..., n); ``w`` raw or prepared."""
        return self._vmm_prepared(a_signs, self._check_operands(a_signs, self.prepare(w)))

    def binary_mmm(self, groups: torch.Tensor, w) -> torch.Tensor:
        """(G, K, m) x (m, n) -> (G, K, n); default: flatten to a VMM."""
        g, k, m = groups.shape
        pw = self._check_operands(groups, self.prepare(w))
        out = self._vmm_prepared(groups.reshape(g * k, m), pw)
        return out.reshape(g, k, -1)

    def preferred_group_size(self) -> int:
        """K-vectors the substrate executes per hardware step (1: the
        serving engine groups them as one batched call)."""
        return 1

    def with_spec(self, spec: CrossbarSpec) -> "Engine":
        """Same backend rebound to another tile spec."""
        return type(self)(spec)

    def steps_for(self, m: int, n: int, n_inputs: int) -> int:
        """Sequential hardware steps for ``n_inputs`` vectors (cost model)."""
        del m, n
        return n_inputs

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Engine {self.name} spec={self.spec.technology}>"


class ReferenceEngine(_EngineBase):
    """Eq. 1 as a plain ±1 matmul — the ground truth every backend matches."""

    info = EngineInfo(
        name="reference",
        description="plain torch ±1 matmul (Eq. 1 ground truth)",
        hardware="any (torch.matmul)",
    )

    def _vmm_prepared(self, a_signs: torch.Tensor, pw: PreparedWeights) -> torch.Tensor:
        return bnn.binary_matmul_signs(a_signs, pw.data.to(a_signs.dtype))


class PackedEngine(_EngineBase):
    """Bit-packed XNOR+popcount on hand-written CUDA kernels.

    32 binary weights per int32 word; ``prepare`` holds the weight words
    resident (``ops.pack_weights``) so only the activation side packs per
    call. ``binary_vmm`` runs the Hamming kernel (``kernels/xnor_matmul``).
    ``fused=True`` (the default) advertises :meth:`fused_dense`: the
    whole BitLinear — binarize + pack + XNOR + popcount + Eq. 1 + α/β
    rescale — as ONE ``kernels/fused_decode`` launch against prepared
    weights; ``fused=False`` keeps the unfused chain as the baseline.
    ``prepad=True`` makes ``prepare`` emit words padded to the reference's
    block multiples (``ops.pad_packed_weights``); results are
    bit-identical either way. CPU tensors run the kernels' plain
    versions.
    """

    info = EngineInfo(
        name="packed",
        description="bit-packed XNOR+popcount CUDA kernels (Eq. 1 affine)",
        hardware="NVIDIA Hopper (plain torch on CPU tensors)",
        packed=True,
    )

    def __init__(
        self, spec: CrossbarSpec | None = None, *, fused: bool = True, prepad: bool = False
    ):
        super().__init__(spec)
        self.fused = bool(fused)
        self.prepad = bool(prepad)

    def with_spec(self, spec: CrossbarSpec) -> "PackedEngine":
        return type(self)(spec, fused=self.fused, prepad=self.prepad)

    def _program(self, w_signs: torch.Tensor):
        from repro_torch.kernels import ops

        wp = ops.pack_weights(w_signs)
        return ops.pad_packed_weights(wp) if self.prepad else wp

    def _vmm_prepared(self, a_signs: torch.Tensor, pw: PreparedWeights) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.xnor_matmul_packed_weights(a_signs, pw.data, m=pw.m, n=pw.n)

    @property
    def supports_fused_dense(self) -> bool:
        """Capability flag the BitLinear seam (``layers.dense``) probes."""
        return self.fused

    def fused_dense(self, x: torch.Tensor, pw: PreparedWeights, alpha) -> torch.Tensor:
        """Whole BitLinear against prepared weights in one kernel launch:
        (..., m) RAW activations x words x alpha (scalar or (n,)) ->
        (..., n) fp32 of ``(binarize(x) @ w±1) * (alpha * mean|x|)``."""
        from repro_torch.kernels import ops

        pw = self._check_operands(x, self._check_prepared(pw))
        return ops.fused_bnn_matmul(x, pw.data, alpha, m=pw.m, n=pw.n)

    def steps_for(self, m: int, n: int, n_inputs: int) -> int:
        # one kernel launch executes the whole (B, m, n) matmul
        del m, n, n_inputs
        return 1


# ---------------------------------------------------------------------------
# K-group batching adapter
# ---------------------------------------------------------------------------


class GroupedEngine:
    """Execute a backend's VMMs as K-grouped ``binary_mmm`` calls.

    A batch of B input vectors becomes G = ceil(B / K) stacked K-groups
    and ONE ``binary_mmm`` call. Ragged tails are padded with +1 signs
    (idle comb lines in WDM hardware) and the pad outputs are discarded,
    so the adapter is bit-exact for any B. Programming and the fused
    BitLinear pass straight through to the base backend.
    """

    def __init__(self, base: Engine, k: int):
        if k < 1:
            raise ValueError(f"group size must be >= 1, got {k}")
        self.base = base
        self.k = int(k)
        self.info = base.info
        self.spec = base.spec

    @property
    def name(self) -> str:
        return f"{self.base.name}@k{self.k}"

    @property
    def weight_cache(self) -> WeightCache | None:
        return getattr(self.base, "weight_cache", None)

    def prepare(self, w_signs):
        if hasattr(self.base, "prepare"):
            return self.base.prepare(w_signs)
        return w_signs

    def prepare_cached(self, w_signs, key=None):
        if hasattr(self.base, "prepare_cached"):
            return self.base.prepare_cached(w_signs, key)
        return w_signs() if callable(w_signs) else w_signs

    def cache_stats(self) -> dict[str, dict[str, int]]:
        if hasattr(self.base, "cache_stats"):
            return self.base.cache_stats()
        return {}

    def binary_vmm(self, a_signs: torch.Tensor, w) -> torch.Tensor:
        m = a_signs.shape[-1]
        flat = a_signs.reshape(-1, m)
        b = flat.shape[0]
        g = max(1, math.ceil(b / self.k))
        pad = g * self.k - b
        if pad:
            flat = torch.cat([flat, flat.new_ones((pad, m))], dim=0)
        out = self.base.binary_mmm(flat.reshape(g, self.k, m), w)
        out = out.reshape(g * self.k, -1)[:b]
        return out.reshape(*a_signs.shape[:-1], -1)

    def binary_mmm(self, groups: torch.Tensor, w) -> torch.Tensor:
        return self.base.binary_mmm(groups, w)

    @property
    def supports_fused_dense(self) -> bool:
        return getattr(self.base, "supports_fused_dense", False)

    def fused_dense(self, x: torch.Tensor, pw, alpha) -> torch.Tensor:
        """The fused kernel flattens leading dims itself: a stacked
        (G, K, m) group is already one launch."""
        return self.base.fused_dense(x, pw, alpha)

    def with_spec(self, spec: CrossbarSpec) -> "GroupedEngine":
        return GroupedEngine(resolve(self.base, spec), self.k)

    def steps_for(self, m: int, n: int, n_inputs: int) -> int:
        groups = math.ceil(n_inputs / self.k)
        return groups * self.base.steps_for(m, n, self.k)

    def preferred_group_size(self) -> int:
        return self.k

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<GroupedEngine {self.name}>"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., Engine]] = {}


def register_engine(name: str, factory: Callable[..., Engine]) -> None:
    """Register a backend factory: ``factory(spec=None, **kw) -> Engine``."""
    _REGISTRY[name] = factory


def list_engines() -> list[str]:
    """Sorted names of every registered backend."""
    return sorted(_REGISTRY)


def get_engine(name: str, spec: CrossbarSpec | None = None, **kw) -> Engine:
    """Instantiate a registered backend, optionally binding a tile spec."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        if name in PENDING_ENGINES:
            raise NotImplementedError(
                f"engine {name!r} is not ported yet; it arrives with "
                f"{PENDING_ENGINES[name]}"
            ) from None
        raise ValueError(
            f"unknown engine {name!r}; registered: {', '.join(list_engines())}"
        ) from None
    return factory(spec, **kw)


def resolve(engine: "str | Engine", spec: CrossbarSpec | None = None) -> Engine:
    """Accept an engine name or an already-constructed Engine instance
    (rebinding the spec only when it differs by value)."""
    if isinstance(engine, str):
        return get_engine(engine, spec)
    if spec is not None and engine.spec != spec:
        if hasattr(engine, "with_spec"):
            return engine.with_spec(spec)
        return get_engine(engine.name, spec)
    return engine


def resolve_group_size(engine: Engine | None, requested: int | None, batch: int) -> int:
    """The K-group sizing policy shared by the serving engine and CLIs.

    Explicit request (> 0) wins; else an engine whose
    ``preferred_group_size()`` exceeds 1 contributes it; else one group
    spans the batch. Always clamped to [1, batch]. (Mapping plans, which
    can also set K in the reference, arrive with a later slice.)
    """
    if requested:
        k = requested
    elif engine is not None and engine.preferred_group_size() > 1:
        k = engine.preferred_group_size()
    else:
        k = batch
    return max(1, min(int(k), batch))


for _cls in (ReferenceEngine, PackedEngine):
    register_engine(_cls.info.name, _cls)

"""Execution-engine registry (counterpart of ``repro/core/engine.py``).

Every engine computes the same XNOR+popcount contract (Eq. 1) and is
therefore bit-exact and swappable. An :class:`Engine` executes ±1
binary matmuls::

    binary_vmm(a_signs, w)         # (..., m) x (m, n) -> (..., n)
    binary_mmm(groups, w)          # (G, K, m) x (m, n) -> (G, K, n)

Two-phase program/execute contract: ``prepare(w_signs)`` runs the
weight-side transforms once (complement-stacked cell states for the
crossbar simulators, bit-packing for ``packed``) and returns a
:class:`PreparedWeights` artifact; ``binary_vmm``/``binary_mmm`` accept
raw ±1 weights or that artifact, and the raw path delegates through
``prepare``, so prepared and raw execution are bit-identical by
construction. ``prepare_cached`` memoizes programming on the identity
of the weight tensor in a bounded :class:`WeightCache`.

``binary_mmm`` is the batching contract: engines with
``info.native_mmm`` (WDM) execute each K-group as one hardware step and
report that K from ``preferred_group_size()``; every other backend
reports 1 and serves ``binary_mmm`` as one flattened VMM.

====================  ==========================================  ==========  ====================
name                  models                                      native MMM  prepared artifact
====================  ==========================================  ==========  ====================
``reference``         Eq. 1 as a plain ±1 matmul (ground truth)   no          ±1 signs
``tacitmap``          tiled ePCM/oPCM crossbar simulator          no          complement cell states
``wdm``               oPCM + K-wavelength WDM (EinsteinBarrier)   yes (K)     complement cell states
``packed``            bit-packed XNOR+popcount CUDA kernels       no          int32 words
``tiled``             mapping-plan placed tile execution          no          cell states + placement
                                                                              indices
``custbinarymap``     2T2R/PCSA row-serial baseline [15]          no          ±1 signs
====================  ==========================================  ==========  ====================

The crossbar simulators (``tacitmap``, ``wdm``, ``tiled``,
``custbinarymap``) are plain tensor products in fp32 on {0,1} cell
states, as in the reference (which has no Pallas kernel for them): every
sum is an integer below 2^24, so they are exact on the CPU and the card.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any, Callable, Protocol, runtime_checkable

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import bnn, custbinarymap, tacitmap, wdm
from repro_torch.core.crossbar import EPCM_TILE, OPCM_TILE, CrossbarSpec, adc_quantize


# ---------------------------------------------------------------------------
# Prepared weights (the programming-phase artifact) + caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PreparedWeights:
    """Weights programmed into one engine's resident execution form.

    ``data`` is the engine's tensor (±1 signs, cell states or int32
    words); ``m`` and ``n`` are the logical weight dims; ``aux`` is
    hashable host-side metadata (the ``tiled`` engine's placement
    indices).
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

    def count(self, hits: int = 0, misses: int = 0, evictions: int = 0) -> None:
        """Add traffic that ran without ``get``/``put`` (a replayed CUDA
        graph's, ``compiler/decode_graph.py``), mirrored as any other."""
        self.hits += hits
        self.misses += misses
        self.evictions += evictions
        if self.name is not None:
            for kind, n in (("hit", hits), ("miss", misses), ("eviction", evictions)):
                if n:
                    obs.cache_event(self.name, kind, n)

    def values(self) -> list:
        return list(self._store.values())

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


def _version(w) -> int | None:
    """A tensor's in-place version counter (None where there is none)."""
    try:
        return w._version
    except (AttributeError, RuntimeError):  # not a tensor; an inference tensor
        return None


class WeightCache:
    """Prepared-weight cache keyed by weight-tensor *identity* and version.

    Each entry keeps a strong reference to its key tensor, so an
    ``id()`` can never be recycled while the entry is alive; a replaced
    weight is a guaranteed miss and its stale entry ages out of the LRU.
    A weight updated in place (an optimizer step: the reference's arrays
    are immutable, the port's parameters are not) bumps its version
    counter, which is a miss too.
    """

    def __init__(self, maxsize: int = 32):
        self._lru = LRUCache(maxsize, name="weight_cache")

    def get(self, w) -> PreparedWeights | None:
        entry = self._lru.get(id(w))
        if entry is not None and entry[0] is w and entry[1] == _version(w):
            return entry[2]
        return None

    def put(self, w, pw: PreparedWeights) -> None:
        self._lru.put(id(w), (w, _version(w), pw))

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def lru(self) -> LRUCache:
        """The LRU behind the cache: its entries are ``(weight, version,
        artifact)``."""
        return self._lru

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

    Subclasses implement ``_program`` (weight signs -> resident tensor),
    optionally ``_program_aux`` (hashable host-side placement metadata)
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

    def _program_aux(self, m: int, n: int):
        """Hashable host-side placement metadata (``tiled`` overrides)."""
        del m, n
        return None

    def prepare(self, w_signs) -> PreparedWeights:
        """Program ±1 weights (m, n) into this engine's resident form.
        Idempotent on an artifact this engine programmed."""
        if isinstance(w_signs, PreparedWeights):
            return self._check_prepared(w_signs)
        m, n = w_signs.shape
        return PreparedWeights(
            engine=self.name,
            m=int(m),
            n=int(n),
            data=self._program(w_signs),
            aux=self._program_aux(int(m), int(n)),
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


def _stacked_cells(w_signs: torch.Tensor) -> torch.Tensor:
    """The crossbar simulators' programmed state: the complement-stacked
    {0,1} cell matrix (2m, n) in fp32 — Fig. 2-(b), the mapping's PCM
    write. Stored compact: the tile grid is a reshape of it (a view when
    the tiles divide it), so an execute reads 2m x n cells, not the
    padded grid."""
    return bnn.stack_complement_weights(bnn.signs_to_bits(w_signs)).to(torch.float32)


def _mapped_layer(pw: PreparedWeights, spec: CrossbarSpec) -> tacitmap.MappedLayer:
    """Rehydrate a :class:`tacitmap.MappedLayer` around prepared cell
    states (the tile grid is a pure function of (m, n, spec))."""
    return tacitmap.layer_from_cells(pw.data, pw.m, pw.n, spec)


class ReferenceEngine(_EngineBase):
    """Eq. 1 as a plain ±1 matmul — the ground truth every backend matches."""

    info = EngineInfo(
        name="reference",
        description="plain torch ±1 matmul (Eq. 1 ground truth)",
        hardware="any (torch.matmul)",
    )

    def _vmm_prepared(self, a_signs: torch.Tensor, pw: PreparedWeights) -> torch.Tensor:
        return bnn.binary_matmul_signs(a_signs, pw.data.to(a_signs.dtype))


class TacitMapEngine(_EngineBase):
    """The paper's mapping run through the full tiled-crossbar simulator."""

    info = EngineInfo(
        name="tacitmap",
        description="tiled crossbar functional simulator (complement VMM)",
        hardware="ePCM/oPCM crossbar tiles + ADC readout",
    )

    def _program(self, w_signs: torch.Tensor):
        # the paper's programming step: write the complement cell states
        return _stacked_cells(w_signs)

    def _vmm_prepared(self, a_signs: torch.Tensor, pw: PreparedWeights) -> torch.Tensor:
        pc = tacitmap.apply(_mapped_layer(pw, self.spec), bnn.signs_to_bits(a_signs))
        return 2 * pc - pw.m

    def steps_for(self, m: int, n: int, n_inputs: int) -> int:
        return tacitmap.steps_for(m, n, n_inputs, self.spec)


class WDMEngine(_EngineBase):
    """EinsteinBarrier: oPCM crossbar + K-wavelength MMM steps."""

    info = EngineInfo(
        name="wdm",
        description="oPCM + WDM: K input vectors per crossbar step (MMM)",
        hardware="oPCM photonic crossbar, K-wavelength transmitter",
        native_mmm=True,
        default_spec="oPCM",
    )

    def _program(self, w_signs: torch.Tensor):
        return _stacked_cells(w_signs)

    def _vmm_prepared(self, a_signs: torch.Tensor, pw: PreparedWeights) -> torch.Tensor:
        flat = a_signs.reshape(-1, pw.m)
        pc = wdm.wdm_apply(_mapped_layer(pw, self.spec), bnn.signs_to_bits(flat))
        return (2 * pc - pw.m).reshape(*a_signs.shape[:-1], -1)

    def binary_mmm(self, groups: torch.Tensor, w) -> torch.Tensor:
        pw = self._check_operands(groups, self.prepare(w))
        pc = wdm.mmm(_mapped_layer(pw, self.spec), bnn.signs_to_bits(groups))
        return 2 * pc - pw.m

    def steps_for(self, m: int, n: int, n_inputs: int) -> int:
        del m, n
        return wdm.steps_for(n_inputs, self.spec.wdm_k)

    def preferred_group_size(self) -> int:
        """The wavelength count: K input vectors ride one crossbar step."""
        return self.spec.wdm_k


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


class TiledEngine(_EngineBase):
    """Mapping-plan-driven tile execution.

    Where ``tacitmap`` simulates the whole tiled array in one product,
    this backend executes the *compiled placement*: the cell states are
    cut into exactly the ``spec.rows x spec.cols`` blocks a
    :class:`repro_torch.mapping.allocator.MappingPlan` placed, gathered
    in the plan's block order into one (T, R, C) stack, the per-block
    partial popcounts run as ONE batched product over the tile axis, and
    digital partial-sum accumulation adds them back per output column
    group (``index_add_``). Bit-exact vs ``reference`` for every
    allocator policy — placement permutes tile order, never the math.

    ``prepare`` programs the placement: the complement cell states are
    compiled once, and the host-side placement indices (block order and
    the row/column block of each placed tile) ride along as hashable aux
    metadata. Ad-hoc placements and their index lists are memoized per
    (m, n) in bounded LRUs (``adhoc_placements``, ``placement_indices``);
    the index tensors an execute gathers with are built once per
    (m, n, device), not on every call.

    ``mesh_axis`` names the mesh axis the tile axis shards over: inside
    ``distributed.activation_hints`` a DTensor tile stack and its
    partial sums are redistributed to shard it (``distributed.hints``);
    a plain tensor stays on its device.

    Construction: ``get_engine("tiled", plan=plan)`` executes per a
    compiled plan (and inherits its tile spec); without a plan, each
    distinct (m, n) weight shape is placed on the fly under ``policy``.
    """

    info = EngineInfo(
        name="tiled",
        description="plan-driven tile execution (complement blocks, batched over tiles)",
        hardware="ePCM/oPCM crossbar tile pool",
    )

    ADHOC_CACHE_SIZE = 32

    def __init__(
        self,
        spec: CrossbarSpec | None = None,
        *,
        plan=None,
        policy: str = "tacitmap",
        mesh_axis: str = "model",
    ):
        if plan is not None and spec is None:
            spec = plan.spec
        super().__init__(spec)
        if plan is not None and plan.spec != self.spec:
            raise ValueError(
                f"plan was compiled for {plan.spec.technology} "
                f"{plan.spec.rows}x{plan.spec.cols} tiles but the engine is "
                f"bound to {self.spec.technology} {self.spec.rows}x{self.spec.cols}"
            )
        self.plan = plan
        self.policy = policy
        self.mesh_axis = mesh_axis
        self._adhoc_cache = LRUCache(self.ADHOC_CACHE_SIZE, name="adhoc_placements")
        self._index_cache = LRUCache(self.ADHOC_CACHE_SIZE, name="placement_indices")
        # (m, n, device) -> (aux, row ids, col ids): the execute's index
        # tensors, on the device of the activations
        self._device_indices = LRUCache(self.ADHOC_CACHE_SIZE)

    def with_spec(self, spec: CrossbarSpec) -> "TiledEngine":
        keep = self.plan if (self.plan is not None and self.plan.spec == spec) else None
        return type(self)(spec, plan=keep, policy=self.policy, mesh_axis=self.mesh_axis)

    def cache_stats(self) -> dict[str, dict[str, int]]:
        return {
            **super().cache_stats(),
            "adhoc_placements": self._adhoc_cache.stats,
            "placement_indices": self._index_cache.stats,
        }

    def _placement(self, m: int, n: int):
        """The plan's LayerPlan for a (m, n) matrix, or an on-the-fly
        single-layer placement under this engine's policy (cached)."""
        if self.plan is not None:
            lp = self.plan.layer_for(m, n)
            if lp is not None:
                return lp
        lp = self._adhoc_cache.get((m, n))
        if lp is None:
            from repro_torch.mapping import allocator, ir  # lazy: mapping imports costmodel

            lp = allocator.allocate(
                ir.adhoc_layer(m, n), spec=self.spec, policy=self.policy
            ).layers[0]
            self._adhoc_cache.put((m, n), lp)
        return lp

    def _indices(self, m: int, n: int):
        """Placement + host-side index lists for a (m, n) matrix,
        memoized per shape: the block order and each placed block's
        flat, row-block and column-block index."""
        cached = self._index_cache.get((m, n))
        if cached is None:
            lp = self._placement(m, n)
            order = lp.block_order()
            ct = lp.grid.col_tiles
            block_ids = tuple(rb * ct + cb for rb, cb in order)
            row_ids = tuple(rb for rb, _ in order)
            col_ids = tuple(cb for _, cb in order)
            cached = (lp, block_ids, row_ids, col_ids)
            self._index_cache.put((m, n), cached)
        return cached

    def _program(self, w_signs: torch.Tensor):
        # programmed cell states (complement-stacked, compact); the
        # placement-ordered (T, R, C) block stack is gathered at execute
        # time, so a resident model holds 2m x n cells per projection
        return _stacked_cells(w_signs)

    def _program_aux(self, m: int, n: int):
        lp, block_ids, row_ids, col_ids = self._indices(m, n)
        return (
            block_ids,
            row_ids,
            col_ids,
            int(lp.grid.row_tiles),
            int(lp.grid.col_tiles),
            int(self.spec.rows),
            int(self.spec.cols),
        )

    def _device_ids(self, pw: PreparedWeights, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The artifact's row- and column-block ids as int64 tensors on
        ``device``, built once per (m, n, device) placement."""
        key = (pw.m, pw.n, str(device))
        hit = self._device_indices.get(key)
        if hit is None or (hit[0] is not pw.aux and hit[0] != pw.aux):
            _, row_ids, col_ids = pw.aux[:3]
            hit = (
                pw.aux,
                torch.tensor(row_ids, dtype=torch.int64, device=device),
                torch.tensor(col_ids, dtype=torch.int64, device=device),
            )
            self._device_indices.put(key, hit)
        return hit[1], hit[2]

    def _vmm_prepared(self, a_signs: torch.Tensor, pw: PreparedWeights) -> torch.Tensor:
        from repro_torch.distributed.hints import hint

        _, _, _, RT, CT, R, C = pw.aux
        if (R, C) != (self.spec.rows, self.spec.cols):
            raise ValueError(
                f"prepared cells were placed on {R}x{C} blocks but the engine "
                f"is bound to {self.spec.rows}x{self.spec.cols} tiles — re-run prepare()"
            )
        m, n = pw.m, pw.n
        row_t, col_t = self._device_ids(pw, pw.data.device)
        # the placement view: pad to the grid, gather blocks in the PLAN'S
        # order (block (rb, cb) is flat block rb * CT + cb)
        pad_r, pad_c = RT * R - 2 * m, CT * C - n
        cells = F.pad(pw.data, (0, pad_c, 0, pad_r)) if pad_r or pad_c else pw.data
        tiles = cells.reshape(RT, R, CT, C)[row_t, :, col_t, :]  # (T, R, C)
        tiles = hint(tiles, self.mesh_axis)  # shard the tile axis when a mesh is active

        # inputs: complement drive, cut into the row blocks each tile sees
        lead = a_signs.shape[:-1]
        drive = bnn.concat_complement_input(bnn.signs_to_bits(a_signs.reshape(-1, m)))
        drive = drive.to(torch.float32)
        if pad_r:
            drive = F.pad(drive, (0, pad_r))
        drive_t = drive.reshape(-1, RT, R)[:, row_t, :].transpose(0, 1)  # (T, B, R)

        # one crossbar activation per placed tile: analog MAC + that tile's ADC
        partial = adc_quantize(torch.bmm(drive_t, tiles), self.spec, active_rows=R)
        partial = hint(partial, self.mesh_axis)
        # digital partial-sum accumulation: row-block partials of each
        # output column group add up, in whatever order the plan placed them
        summed = partial.new_zeros((CT, *partial.shape[1:])).index_add_(0, col_t, partial)
        pc = summed.transpose(0, 1).reshape(-1, CT * C)[:, :n]
        return (2 * pc - m).reshape(*lead, n)

    def steps_for(self, m: int, n: int, n_inputs: int) -> int:
        """WDM-grouped stream x the plan's per-vector serialization (a
        tile co-hosting j blocks of one layer fires j times)."""
        lp = self._placement(m, n)
        groups = math.ceil(n_inputs / max(1, self.spec.wdm_k))
        return groups * lp.steps_per_vector

    def preferred_group_size(self) -> int:
        """The plan's WDM capacity (== spec.wdm_k for the bound tiles)."""
        if self.plan is not None:
            return self.plan.preferred_group_size()
        return self.spec.wdm_k

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        planned = self.plan.model.name if self.plan is not None else f"adhoc/{self.policy}"
        return f"<Engine tiled spec={self.spec.technology} plan={planned}>"


class CustBinaryMapEngine(_EngineBase):
    """The SotA baseline mapping [15]: one weight vector per step (PCSA)."""

    info = EngineInfo(
        name="custbinarymap",
        description="2T2R row-serial baseline (PCSA readout, digital popcount)",
        hardware="ePCM 2T2R arrays + precharge sense amplifiers",
    )

    def _vmm_prepared(self, a_signs: torch.Tensor, pw: PreparedWeights) -> torch.Tensor:
        return custbinarymap.binary_matmul(a_signs, pw.data, self.spec)

    def steps_for(self, m: int, n: int, n_inputs: int) -> int:
        return custbinarymap.steps_for(m, n, n_inputs, self.spec)


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


def engine_info(name: str) -> EngineInfo:
    """Capability metadata of a registered backend."""
    return get_engine(name).info


def resolve_group_size(
    engine: Engine | None, requested: int | None, batch: int, plan=None
) -> int:
    """The K-group sizing policy shared by the serving engine and CLIs.

    Explicit request (> 0) wins; else a compiled mapping plan contributes
    its WDM capacity (``plan.preferred_group_size()``: the placed tile
    technology, even when the executing backend has no native MMM); else
    an engine whose ``preferred_group_size()`` exceeds 1 contributes it
    (WDM's wavelength count, a plan-bound tiled engine's tile K); else
    one group spans the batch. Always clamped to [1, batch].
    """
    if requested:
        k = requested
    elif plan is not None and plan.preferred_group_size() > 1:
        k = plan.preferred_group_size()
    elif engine is not None and engine.preferred_group_size() > 1:
        k = engine.preferred_group_size()
    else:
        k = batch
    return max(1, min(int(k), batch))


for _cls in (
    ReferenceEngine,
    TacitMapEngine,
    WDMEngine,
    PackedEngine,
    TiledEngine,
    CustBinaryMapEngine,
):
    register_engine(_cls.info.name, _cls)

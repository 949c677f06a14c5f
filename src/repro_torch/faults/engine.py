"""``FaultyEngine`` — fault injection as an engine decorator (counterpart
of ``repro/faults/engine.py``).

Wraps any registry backend (``repro_torch.core.engine``) behind the same
``prepare`` / ``binary_vmm`` / ``binary_mmm`` contract and corrupts its
outputs exactly the way stuck PCM cells would:

* ``prepare`` composes the inner engine's artifact with a *fault delta*
  ``D = stuck_SET * (1 - cells) - stuck_RESET * cells`` over the
  complement-stacked {0,1} cell matrix (2m, n), a dense fp32 tensor on
  the artifact's device: the per-cell difference between what the
  crossbar *reads* and what was *programmed*.
* Execution is algebraically exact corruption: a complement-drive
  readout of cells ``C' = C + D`` returns ``out + 2 * (drive @ D)``
  where ``out`` is the inner engine's exact result, cast to ``out``'s
  dtype. ``drive`` is {0,1} and ``D`` is in {-1, 0, 1}, so every sum is
  an integer no larger than 2m < 2^24: the product is exact in any
  summation order, TF32 included. ``D = 0`` (fault-free) is
  bit-identical by construction: the wrapper then carries no delta.
* The delta rides inside the wrapper's :class:`PreparedWeights`
  (``data = (inner_data, delta)``), so refreshing artifacts after drift,
  a tile failure or a remap changes results without touching the inner
  engine.

Fault-to-placement resolution is per physical tile: each placed block's
tile id selects that tile's deterministic stuck-cell masks
(:meth:`FaultModel.tile_cell_masks`), so remapping a block onto a spare
tile escapes the old tile's faults. A plan-bound ``tiled`` inner engine
resolves blocks through its ``MappingPlan``; any other inner engine uses
the layer-local row-major tile grid (tile ids are then per layer shape,
and every projection of one shape shares a placement, since engines see
shapes, not instances). The masks of a shape are drawn once per (m, n,
epoch, failed-tile set) on the host and moved to each device once.

Detection: :meth:`consistency_probe` evaluates the TacitMap
complement-row invariant — for pristine cells the drives ``+1^m`` and
``-1^m`` sum to all-ones over the complement-stacked rows, so
``vmm(+1) + vmm(-1) == 0`` per column; stuck cells break it by
``2 * D.sum(rows)``. :meth:`locate` reads the delta directly and is the
exact oracle the remap path uses. Both reduce on the artifact's device
and copy only per-block flags or per-column values to the host. Both
also take a sequence of artifacts (the per-layer instances of one
projection, which the reference stacks into one artifact) and reduce
over it as the reference reduces over the stacked axis.

The wrapped engine lives on ``self.inner``, not ``self.base``:
``lm.program_weights`` unwraps one ``.base`` level (``GroupedEngine``),
and a ``.base`` here would bypass injection during programming.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import bnn
from repro_torch.core import engine as engine_lib
from repro_torch.core.crossbar import CrossbarSpec, TileGrid
from repro_torch.faults.model import FaultModel

_FAULT_TAG = "__faulty__"

# engines whose PreparedWeights.data recovers the programmed cell
# matrix, so artifacts can be *refreshed* (delta recomputed) after the
# fault state changes post-programming. ``packed`` holds bit-packed
# words: injection works at prepare time (cells derive from the raw
# signs) but a packed artifact cannot be refreshed in place.
CELL_DATA_ENGINES = ("reference", "tacitmap", "wdm", "tiled", "custbinarymap")
_SIGN_DATA_ENGINES = ("reference", "custbinarymap")
_CELLS_DATA_ENGINES = ("tacitmap", "wdm", "tiled")


class FaultInjectionError(RuntimeError):
    """Fault state cannot be applied to this engine/artifact."""


def _cells_from_signs(w_signs: torch.Tensor) -> torch.Tensor:
    """Complement-stacked {0,1} fp32 cells (2m, n) from ±1 signs (m, n)."""
    bits = bnn.signs_to_bits(w_signs.to(torch.float32))
    return torch.cat([bits, 1.0 - bits], dim=-2)


class FaultyEngine:
    """Fault-injecting decorator over a registry engine.

    Runtime state (mutable, survives :meth:`rebind`):

    * ``epoch`` — drift epochs elapsed (:meth:`advance_drift`).
    * runtime-failed tiles (:meth:`fail_tile`) and runtime-dead lanes
      (:meth:`fail_lane`) — faults that developed after construction,
      on top of the :class:`FaultModel`'s.

    Changing runtime state does not rewrite already-prepared artifacts
    (their delta is baked into the artifact data); callers refresh them
    (``CompiledModel`` does, via :meth:`refresh`) to observe new state.
    """

    def __init__(self, inner, model: FaultModel, *, epoch: int = 0):
        if isinstance(inner, engine_lib.GroupedEngine):
            raise FaultInjectionError(
                "wrap the base engine, then group: "
                "GroupedEngine(FaultyEngine(base, model), k)"
            )
        if isinstance(inner, FaultyEngine):
            raise FaultInjectionError("refusing to double-wrap a FaultyEngine")
        self.inner = inner
        self.model = model.validate()
        self.epoch = int(epoch)
        self._runtime_failed: set[int] = set()
        self._runtime_dead_lanes: set[int] = set()
        self._mask_cache: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}
        # (mask key, device) -> the masks as fp32 tensors on that device
        self._device_masks: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    # -- delegated surface --------------------------------------------------

    @property
    def name(self) -> str:
        # artifacts stay tagged with the inner backend's name, so the
        # inner engine's _check_prepared accepts the unwrapped half
        return self.inner.name

    @property
    def info(self):
        return self.inner.info

    @property
    def spec(self) -> CrossbarSpec:
        return self.inner.spec

    def steps_for(self, m: int, n: int, n_inputs: int) -> int:
        return self.inner.steps_for(m, n, n_inputs)

    def cache_stats(self) -> dict:
        if hasattr(self.inner, "cache_stats"):
            return self.inner.cache_stats()
        return {}

    def with_spec(self, spec: CrossbarSpec) -> "FaultyEngine":
        return self.rebind(engine_lib.resolve(self.inner, spec))

    def rebind(self, new_inner) -> "FaultyEngine":
        """Same fault state over a different inner engine (the remap
        path: a re-placed plan means a new tiled inner instance)."""
        out = FaultyEngine(new_inner, self.model, epoch=self.epoch)
        out._runtime_failed = set(self._runtime_failed)
        out._runtime_dead_lanes = set(self._runtime_dead_lanes)
        return out

    # -- fault state --------------------------------------------------------

    @property
    def pristine(self) -> bool:
        """No cell-value corruption under the current state (dead lanes
        don't count: capacity, not correctness)."""
        return self.model.cell_pristine and not self._runtime_failed

    def failed_tiles(self) -> frozenset[int]:
        return self.model.failed_tiles | frozenset(self._runtime_failed)

    def dead_lanes(self) -> frozenset[int]:
        return self.model.dead_lanes | frozenset(self._runtime_dead_lanes)

    def fail_tile(self, tile: int) -> None:
        """Whole-tile failure at runtime: every cell now reads RESET."""
        self._runtime_failed.add(int(tile))

    def fail_lane(self, lane: int) -> None:
        """Kill one WDM comb line at runtime (capacity loss only)."""
        self._runtime_dead_lanes.add(int(lane))

    def advance_drift(self, epochs: int = 1) -> None:
        """Advance conductance drift; stuck-RESET cells only ever grow."""
        if epochs < 0:
            raise ValueError(f"drift only moves forward, got {epochs}")
        self.epoch += int(epochs)

    def effective_group_cap(self) -> int | None:
        """Alive wavelengths among the inner engine's preferred K, or
        ``None`` when the inner engine doesn't multiplex (K <= 1)."""
        k = self.inner.preferred_group_size()
        if k <= 1:
            return None
        dead = self.dead_lanes()
        return max(1, sum(1 for lane in range(k) if lane not in dead))

    def preferred_group_size(self) -> int:
        cap = self.effective_group_cap()
        return self.inner.preferred_group_size() if cap is None else cap

    def tile_is_clean(self, tile: int) -> bool:
        """BIST one physical tile under the current epoch: usable as a
        remap destination iff it is not failed and draws no stuck
        cells. Spare tiles are real hardware — they fault too."""
        if tile in self.failed_tiles():
            return False
        s, r = self.model.tile_cell_masks(
            tile, self.spec.rows, self.spec.cols, self.epoch, failed=False
        )
        return not (bool(s.any()) or bool(r.any()))

    # -- programming (wrapper artifacts) ------------------------------------

    @staticmethod
    def _is_wrapped(pw: engine_lib.PreparedWeights) -> bool:
        return isinstance(pw.aux, tuple) and len(pw.aux) == 2 and pw.aux[0] == _FAULT_TAG

    def _split(self, pw: engine_lib.PreparedWeights):
        """Wrapper artifact -> (inner artifact, delta-or-None)."""
        inner_data, delta = pw.data
        inner_pw = engine_lib.PreparedWeights(
            engine=pw.engine, m=pw.m, n=pw.n, data=inner_data, aux=pw.aux[1]
        )
        return inner_pw, delta

    def _compose(self, inner_pw, cells) -> engine_lib.PreparedWeights:
        if self.pristine:
            delta = None
        else:
            if cells is None:
                raise FaultInjectionError(
                    f"engine {self.inner.name!r} artifacts do not expose the "
                    "programmed cell matrix (bit-packed data) — fault state "
                    "can only be injected at prepare time from raw signs, "
                    "not refreshed on an existing artifact"
                )
            delta = self._delta(cells, inner_pw.m, inner_pw.n)
        return engine_lib.PreparedWeights(
            engine=inner_pw.engine,
            m=inner_pw.m,
            n=inner_pw.n,
            data=(inner_pw.data, delta),
            aux=(_FAULT_TAG, inner_pw.aux),
        )

    def _cells_of(self, inner_pw):
        """Recover the programmed (2m, n) cell matrix from an inner
        artifact (the cell-state engines hold it compact; they pad to
        the tile grid only while executing), or ``None`` when the data
        doesn't carry it."""
        if inner_pw.engine in _CELLS_DATA_ENGINES:
            return inner_pw.data
        if inner_pw.engine in _SIGN_DATA_ENGINES:
            return _cells_from_signs(inner_pw.data)
        return None

    def prepare(self, w_signs) -> engine_lib.PreparedWeights:
        if isinstance(w_signs, engine_lib.PreparedWeights):
            if self._is_wrapped(w_signs):
                return w_signs
            inner_pw = self.inner.prepare(w_signs)  # validates engine name
            return self._compose(inner_pw, self._cells_of(inner_pw))
        inner_pw = self.inner.prepare(w_signs)
        # cells derive from the raw signs, so prepare-time injection
        # works for every inner engine (packed included)
        return self._compose(inner_pw, _cells_from_signs(w_signs))

    def prepare_cached(self, w_signs, key=None) -> engine_lib.PreparedWeights:
        """No memoization: the fault state is mutable (drift, runtime
        tile failures), and an identity-keyed cache would serve stale
        deltas. The programmed path (``lm.program_weights``) is the
        production route; this raw-weights path just stays correct."""
        del key
        if isinstance(w_signs, engine_lib.PreparedWeights):
            return self.prepare(w_signs)
        return self.prepare(w_signs() if callable(w_signs) else w_signs)

    def refresh(self, pw: engine_lib.PreparedWeights) -> engine_lib.PreparedWeights:
        """Recompute an artifact's delta (and placement aux) under the
        current fault state / inner engine — the post-remap, post-drift
        reprogramming step."""
        inner_pw, _ = self._split(pw) if self._is_wrapped(pw) else (pw, None)
        inner_pw = dataclasses.replace(
            inner_pw, aux=self.inner._program_aux(inner_pw.m, inner_pw.n)
        )
        return self._compose(inner_pw, self._cells_of(inner_pw))

    # -- the fault delta ----------------------------------------------------

    def _placement_blocks(self, m: int, n: int):
        """(row_block, col_block, rows_used, cols_used, tile) for every
        placed block of a (m, n) matrix — through the inner engine's
        MappingPlan when it has one, else the layer-local grid."""
        if hasattr(self.inner, "_placement"):
            lp = self.inner._placement(m, n)
            return [
                (b.row_block, b.col_block, b.rows_used, b.cols_used, b.tile)
                for b in lp.blocks
            ]
        grid = TileGrid(rows=2 * m, cols=n, spec=self.spec)
        R, C = self.spec.rows, self.spec.cols
        out = []
        for rb in range(grid.row_tiles):
            for cb in range(grid.col_tiles):
                out.append((
                    rb, cb,
                    min(R, 2 * m - rb * R),
                    min(C, n - cb * C),
                    rb * grid.col_tiles + cb,
                ))
        return out

    def _mask_key(self, m: int, n: int) -> tuple:
        return (m, n, self.epoch, tuple(sorted(self.failed_tiles())))

    def _layer_masks(self, m: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        """(stuck_SET, stuck_RESET) over the layer's (2m, n) cell matrix,
        assembled on the host from the per-physical-tile masks through
        the placement (cached per (shape, epoch, failed-tile set))."""
        key = self._mask_key(m, n)
        cached = self._mask_cache.get(key)
        if cached is not None:
            return cached
        failed = self.failed_tiles()
        R, C = self.spec.rows, self.spec.cols
        set_m = np.zeros((2 * m, n), bool)
        reset_m = np.zeros((2 * m, n), bool)
        for rb, cb, ru, cu, tile in self._placement_blocks(m, n):
            s, r = self.model.tile_cell_masks(
                tile, R, C, self.epoch, failed=tile in failed
            )
            r0, c0 = rb * R, cb * C
            set_m[r0:r0 + ru, c0:c0 + cu] |= s[:ru, :cu]
            reset_m[r0:r0 + ru, c0:c0 + cu] |= r[:ru, :cu]
        self._mask_cache[key] = (set_m, reset_m)
        return set_m, reset_m

    def _masks_on(self, m: int, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`_layer_masks` as fp32 tensors on ``device``, moved
        there once per mask key."""
        key = (self._mask_key(m, n), str(device))
        hit = self._device_masks.get(key)
        if hit is None:
            set_m, reset_m = self._layer_masks(m, n)
            hit = tuple(
                torch.from_numpy(x).to(device=device, dtype=torch.float32)
                for x in (set_m, reset_m)
            )
            self._device_masks[key] = hit
        return hit

    def _delta(self, cells: torch.Tensor, m: int, n: int) -> torch.Tensor:
        """What the crossbar reads minus what was programmed:
        ``D = SET * (1 - C) - RESET * C`` — dense (2m, n) fp32 on the
        cells' device, even when all-zero, so a refresh always finds a
        delta to replace."""
        s, r = self._masks_on(m, n, cells.device)
        cells = cells.to(torch.float32)
        return s * (1.0 - cells) - r * cells

    # -- execution ----------------------------------------------------------

    def _corruption(self, a_signs: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """The exact output error of reading ``C + D``: per Eq. 1 the
        complement drive hits the delta as ``2 * (drive @ D)``."""
        drive = bnn.concat_complement_input(bnn.signs_to_bits(a_signs.to(torch.float32)))
        return 2.0 * torch.matmul(drive, delta)

    def binary_vmm(self, a_signs: torch.Tensor, w) -> torch.Tensor:
        inner_pw, delta = self._split(self.prepare(w))
        out = self.inner.binary_vmm(a_signs, inner_pw)
        if delta is None:
            return out
        return out + self._corruption(a_signs, delta).to(out.dtype)

    def binary_mmm(self, groups: torch.Tensor, w) -> torch.Tensor:
        inner_pw, delta = self._split(self.prepare(w))
        out = self.inner.binary_mmm(groups, inner_pw)
        if delta is None:
            return out
        return out + self._corruption(groups, delta).to(out.dtype)

    @property
    def supports_fused_dense(self) -> bool:
        """The fused BitLinear kernel has no seam to add the fault delta,
        so the capability is only advertised while pristine —
        non-pristine models take the unfused chain, where the corruption
        applies."""
        return self.pristine and getattr(self.inner, "supports_fused_dense", False)

    def fused_dense(self, x: torch.Tensor, pw, alpha) -> torch.Tensor:
        inner_pw, delta = self._split(pw) if self._is_wrapped(pw) else (pw, None)
        if delta is not None:
            raise FaultInjectionError(
                "fused_dense has no injection seam; the dense() layer must "
                "route non-pristine models through the unfused path "
                "(supports_fused_dense is False while faults are active)"
            )
        return self.inner.fused_dense(x, inner_pw, alpha)

    # -- detection ----------------------------------------------------------

    def _instances(self, w) -> list[engine_lib.PreparedWeights]:
        """One artifact, or the per-layer instances of one projection."""
        items = list(w) if isinstance(w, Sequence) else [w]
        return [self.prepare(x) for x in items]

    def consistency_probe(self, w, *, execute: bool = False) -> np.ndarray:
        """Per-column violation magnitude of the TacitMap complement-row
        invariant (0 everywhere iff no *visible* corruption), float64
        on the host.

        ``execute=True`` runs the honest two-drive readout
        ``|vmm(+1^m) + vmm(-1^m)|`` through the full execution path (on a
        packed inner engine: the Hamming kernel); the default reads the
        identical quantity ``|2 * D.sum(rows)|`` off the delta, reduced on
        the device — the inner engines satisfy the invariant exactly, so
        the two agree bit for bit. A sequence of artifacts (one
        projection's layers) reduces to the worst violation across them.
        """
        cols = []
        for pw in self._instances(w):
            inner_pw, delta = self._split(pw)
            if execute:
                dev = inner_pw.data.device
                ones = torch.ones((pw.m,), dtype=torch.float32, device=dev)
                v = self.binary_vmm(ones, pw) + self.binary_vmm(-ones, pw)
                cols.append(np.abs(v.cpu().numpy().astype(np.float64)))
            elif delta is None:
                cols.append(np.zeros((pw.n,), np.float64))
            else:
                # integer column sums <= 2m: exact in fp32 on any device
                v = (2.0 * delta.sum(dim=0)).abs()
                cols.append(v.cpu().numpy().astype(np.float64))
        return np.max(np.stack(cols), axis=0)

    def locate(self, w) -> frozenset[int]:
        """Physical tiles holding at least one corrupted cell of this
        artifact (or of any of a sequence of artifacts) — the exact
        oracle the remap path consumes (unlike the probe, immune to
        same-column SET/RESET aliasing). Reduces each tile block of the
        delta on the device and copies one flag per block to the host."""
        R, C = self.spec.rows, self.spec.cols
        tiles: set[int] = set()
        for pw in self._instances(w):
            _, delta = self._split(pw)
            if delta is None:
                continue
            grid = TileGrid(rows=2 * pw.m, cols=pw.n, spec=self.spec)
            RT, CT = grid.row_tiles, grid.col_tiles
            grid_delta = F.pad(delta, (0, CT * C - pw.n, 0, RT * R - 2 * pw.m))
            bad = (grid_delta != 0).reshape(RT, R, CT, C).any(dim=3).any(dim=1).cpu().numpy()
            if not bad.any():
                continue
            tiles.update(
                tile for rb, cb, _, _, tile in self._placement_blocks(pw.m, pw.n)
                if bad[rb, cb]
            )
        return frozenset(tiles)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"<FaultyEngine over {self.inner!r} epoch={self.epoch} "
            f"failed={sorted(self.failed_tiles())} "
            f"dead_lanes={sorted(self.dead_lanes())}>"
        )

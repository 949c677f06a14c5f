"""Deterministic, seedable device-fault models for the PCM crossbar.

The paper's premise is weights resident *in* PCM cells — but real
(o)PCM devices suffer stuck-at faults (a cell frozen in the SET or
RESET conductance state regardless of what was programmed), conductance
drift (amorphous-phase resistance creeping up over time, which in a
binary read window manifests as cells decaying toward RESET), dead WDM
comb lines (a wavelength lane that no longer carries an input vector)
and whole-tile failures (a broken word-line driver / ADC takes every
cell in the tile to the RESET read). BCIM (arXiv:2211.06261) and the
optical XNOR-bitcount accelerator (arXiv:2302.06405) both flag this
cell non-ideality as the limiting factor for CIM BNN accuracy.

:class:`FaultModel` describes a fault *distribution*; the draw is fully
deterministic: every physical tile gets its own
``np.random.default_rng([seed, tile_id])`` stream, so

* the same (seed, tile) always produces the same stuck-cell masks —
  runs are reproducible and remapping a weight block to a DIFFERENT
  physical tile genuinely escapes the faults of the old one;
* drift is *epoch-monotone*: a cell stuck at epoch e stays stuck at
  every epoch > e (the per-cell uniform draw is fixed; only the
  threshold grows), matching physical drift's one-way direction.

:class:`FaultMap` is the detection result the tolerance half consumes:
the set of physical tiles (and WDM lanes) found faulty, handed to
``CompiledModel.remap`` / the serving health monitor.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


class FaultModelError(ValueError):
    """An inconsistent :class:`FaultModel`."""


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One deterministic description of device faults.

    * ``seed`` — root of the per-tile RNG streams (``[seed, tile]``).
    * ``stuck_set_rate`` / ``stuck_reset_rate`` — per-cell probability
      of being stuck at the SET (reads 1) / RESET (reads 0) conductance
      state. A cell drawn for both is stuck-SET (SET wins ties).
    * ``drift_rate`` — per-epoch conductance-drift rate: the effective
      stuck-RESET fraction grows monotonically as
      ``reset + (1 - reset) * (1 - exp(-drift_rate * epoch))`` — at
      epoch 0 drift has not acted; as epochs advance more cells decay
      into the RESET read window and never come back.
    * ``dead_lanes`` — WDM comb-line indices that carry no input vector
      (capacity loss: effective K shrinks; never a correctness loss —
      the serving planner just stops scheduling slots onto them).
    * ``failed_tiles`` — physical tile ids that are wholly broken:
      every cell reads RESET regardless of programming.
    """

    seed: int = 0
    stuck_set_rate: float = 0.0
    stuck_reset_rate: float = 0.0
    drift_rate: float = 0.0
    dead_lanes: frozenset[int] = frozenset()
    failed_tiles: frozenset[int] = frozenset()

    def __post_init__(self):
        # accept any iterable of ints for the set-valued fields
        object.__setattr__(self, "dead_lanes",
                           frozenset(int(x) for x in self.dead_lanes))
        object.__setattr__(self, "failed_tiles",
                           frozenset(int(x) for x in self.failed_tiles))

    # -- validation ---------------------------------------------------------

    def validate(self) -> "FaultModel":
        if self.seed < 0:
            raise FaultModelError(f"seed must be >= 0, got {self.seed}")
        for name in ("stuck_set_rate", "stuck_reset_rate"):
            rate = getattr(self, name)
            if not 0.0 <= rate <= 1.0:
                raise FaultModelError(f"{name} must be in [0, 1], got {rate}")
        if self.stuck_set_rate + self.stuck_reset_rate > 1.0:
            raise FaultModelError(
                "stuck_set_rate + stuck_reset_rate must be <= 1, got "
                f"{self.stuck_set_rate} + {self.stuck_reset_rate}"
            )
        if self.drift_rate < 0.0:
            raise FaultModelError(
                f"drift_rate must be >= 0, got {self.drift_rate}"
            )
        if any(x < 0 for x in self.dead_lanes):
            raise FaultModelError(f"dead_lanes must be >= 0: {sorted(self.dead_lanes)}")
        if any(x < 0 for x in self.failed_tiles):
            raise FaultModelError(
                f"failed_tiles must be >= 0: {sorted(self.failed_tiles)}"
            )
        return self

    # -- properties ---------------------------------------------------------

    @property
    def cell_pristine(self) -> bool:
        """No mechanism that corrupts cell *values* (dead lanes are a
        capacity loss, not a correctness loss, so they don't count)."""
        return (
            self.stuck_set_rate == 0.0
            and self.stuck_reset_rate == 0.0
            and self.drift_rate == 0.0
            and not self.failed_tiles
        )

    @property
    def is_null(self) -> bool:
        """Completely fault-free: injection is a guaranteed no-op."""
        return self.cell_pristine and not self.dead_lanes

    # -- the draw -----------------------------------------------------------

    def reset_fraction(self, epoch: int) -> float:
        """Effective stuck-RESET cell fraction after ``epoch`` drift
        epochs (monotone in epoch; equals ``stuck_reset_rate`` at 0)."""
        if self.drift_rate == 0.0 or epoch <= 0:
            return self.stuck_reset_rate
        drifted = 1.0 - math.exp(-self.drift_rate * epoch)
        return self.stuck_reset_rate + (1.0 - self.stuck_reset_rate) * drifted

    def tile_cell_masks(
        self, tile: int, rows: int, cols: int, epoch: int = 0,
        failed: bool | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(stuck_SET, stuck_RESET) boolean masks for one physical tile.

        The masks cover the tile's full (rows, cols) cell array; the
        per-cell uniforms are drawn once from ``rng([seed, tile])`` so
        the same tile always faults the same cells, and raising
        ``epoch`` only ever *adds* stuck-RESET cells (drift is one-way).
        ``failed`` overrides the whole-tile state (default: whether
        ``tile`` is in :attr:`failed_tiles`) — a failed tile reads
        RESET everywhere.
        """
        if failed is None:
            failed = tile in self.failed_tiles
        if failed:
            return (
                np.zeros((rows, cols), bool),
                np.ones((rows, cols), bool),
            )
        reset_frac = self.reset_fraction(epoch)
        if self.stuck_set_rate == 0.0 and reset_frac == 0.0:
            z = np.zeros((rows, cols), bool)
            return z, z.copy()
        rng = np.random.default_rng([int(self.seed), int(tile)])
        u = rng.random((2, rows, cols))
        set_mask = u[0] < self.stuck_set_rate
        reset_mask = (u[1] < reset_frac) & ~set_mask  # SET wins ties
        return set_mask, reset_mask

    def describe(self) -> str:
        parts = [f"seed={self.seed}"]
        if self.stuck_set_rate:
            parts.append(f"set={self.stuck_set_rate:g}")
        if self.stuck_reset_rate:
            parts.append(f"reset={self.stuck_reset_rate:g}")
        if self.drift_rate:
            parts.append(f"drift={self.drift_rate:g}/epoch")
        if self.dead_lanes:
            parts.append(f"dead_lanes={sorted(self.dead_lanes)}")
        if self.failed_tiles:
            parts.append(f"failed_tiles={sorted(self.failed_tiles)}")
        if self.is_null:
            parts.append("null")
        return "[faults] " + " ".join(parts)


@dataclasses.dataclass(frozen=True)
class FaultMap:
    """A detection sweep's result: which physical resources are bad.

    ``tiles`` feeds ``CompiledModel.remap`` (move the resident blocks
    off them); ``lanes`` feeds the serving planner's effective-K shrink.
    Truthiness means "something to act on".
    """

    tiles: frozenset[int] = frozenset()
    lanes: frozenset[int] = frozenset()

    def __post_init__(self):
        object.__setattr__(self, "tiles", frozenset(int(x) for x in self.tiles))
        object.__setattr__(self, "lanes", frozenset(int(x) for x in self.lanes))

    def __bool__(self) -> bool:
        return bool(self.tiles) or bool(self.lanes)

    def union(self, other: "FaultMap") -> "FaultMap":
        return FaultMap(tiles=self.tiles | other.tiles,
                        lanes=self.lanes | other.lanes)

    def describe(self) -> str:
        return (
            f"[faultmap] tiles={sorted(self.tiles)} lanes={sorted(self.lanes)}"
        )

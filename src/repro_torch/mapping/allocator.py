"""Tile allocator: layer IR -> explicit block-to-tile placement
(counterpart of ``repro/mapping/allocator.py``).

A static, inspectable answer to "which crossbar tile holds which
weight block". Every policy
shares the TacitMap functional layout — a binarized (m, n) matrix is
stored complement-stacked as (2m, n) (Fig. 2-(b)) and cut into
``spec.rows x spec.cols`` blocks — and differs in how those blocks are
*assigned to physical tiles*:

* ``tacitmap``      — the paper's layout order: blocks walk the stacked
  matrix row-major (a weight block and its complement land on vertically
  adjacent tiles) and claim fresh tiles sequentially.
* ``column-major``  — blocks walk column-major (all row blocks of one
  output column group stay adjacent — partial-sum adders see a
  contiguous tile run); BCIM-style column-serial layouts order this way.
* ``greedy``        — longest-processing-time load balancing: blocks
  (weighted by active cells x instance count) go to the least-loaded
  physical tile. Only meaningful under a ``tile_budget``; without one it
  degenerates to one tile per block like the others.

``tile_budget`` models a fixed accelerator: fewer physical tiles than
weight blocks forces co-residency (a tile stores several blocks side by
side in its spare columns / is time-multiplexed between them), and a
layer whose blocks share a tile pays serialized activations per input
vector — ``LayerPlan.steps_per_vector``. The *functional* engines are
unaffected (placement never changes the math, tests assert bit-exactness
for every policy); the scheduler and cost model charge the serialization.

WDM: every placement records the wavelength set its layer streams over
(``range(spec.wdm_k)``); ``MappingPlan.preferred_group_size()`` is the K
the serving BatchPlanner consults.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable

from repro_torch.core.crossbar import CrossbarSpec, EPCM_TILE, TileGrid
from repro_torch.mapping.ir import LayerIR, ModelIR, to_ir

POLICIES: tuple[str, ...] = ("tacitmap", "column-major", "greedy")


class SpareTilesExhaustedError(RuntimeError):
    """A remap needed more clean spare tiles than the plan has left."""


@dataclasses.dataclass(frozen=True)
class BlockPlacement:
    """One ``spec.rows x spec.cols`` weight block pinned to a tile."""

    layer: str          # owning layer instance (LayerPlan.name)
    row_block: int      # index over the complement-stacked (2m) row axis
    col_block: int      # index over the stored-column axis
    tile: int           # physical tile id (plan-global)
    rows_used: int      # active rows in this block (<= spec.rows)
    cols_used: int      # active cols in this block (<= spec.cols)

    @property
    def cells(self) -> int:
        return self.rows_used * self.cols_used


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Placement of ONE layer instance's complement-stacked matrix."""

    name: str                       # instance name, e.g. "slot0.ffn.w1[3]"
    ir: LayerIR                     # the IR entry this instance came from
    grid: TileGrid                  # complement-stacked (2m, n) tiling
    blocks: tuple[BlockPlacement, ...]
    wavelengths: tuple[int, ...]    # WDM comb lines this layer streams over

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def cells_used(self) -> int:
        return sum(b.cells for b in self.blocks)

    @property
    def tiles(self) -> tuple[int, ...]:
        """Distinct physical tiles this instance occupies."""
        return tuple(sorted({b.tile for b in self.blocks}))

    @property
    def steps_per_vector(self) -> int:
        """Serialized tile passes per input vector: co-resident blocks of
        the SAME layer share their tile's ADC chain and fire in turn."""
        per_tile: dict[int, int] = {}
        for b in self.blocks:
            per_tile[b.tile] = per_tile.get(b.tile, 0) + 1
        return max(per_tile.values())

    def block_order(self) -> tuple[tuple[int, int], ...]:
        """(row_block, col_block) in placement order — the slice order
        the `tiled` engine executes."""
        return tuple((b.row_block, b.col_block) for b in self.blocks)


@dataclasses.dataclass(frozen=True)
class MappingPlan:
    """The static compilation artifact: every weight block, placed.

    ``layers`` holds one :class:`LayerPlan` per layer *instance* (IR
    ``count`` is expanded, so an LM's scanned repeats are all visible).
    ``n_tiles`` is the physical tile pool the plan provisions; with a
    ``tile_budget`` smaller than the block count, utilization may exceed
    1.0 — that is over-subscription, paid for in
    ``LayerPlan.steps_per_vector`` serialization.
    """

    model: ModelIR
    spec: CrossbarSpec
    policy: str
    tile_budget: int | None
    layers: tuple[LayerPlan, ...]
    # fault tolerance: physical tiles provisioned as remap
    # destinations but holding no data yet, and tiles the allocator was
    # told to avoid (known-bad hardware / quarantined after a remap)
    spares: tuple[int, ...] = ()
    avoid_tiles: tuple[int, ...] = ()

    @property
    def n_tiles(self) -> int:
        used = max(b.tile for lp in self.layers for b in lp.blocks)
        if self.spares:
            used = max(used, max(self.spares))
        return 1 + used

    @property
    def n_blocks(self) -> int:
        return sum(lp.n_blocks for lp in self.layers)

    @property
    def cells_used(self) -> int:
        return sum(lp.cells_used for lp in self.layers)

    def utilization(self) -> float:
        """Active cells / provisioned cells (> 1.0 = over-subscribed)."""
        cap = self.n_tiles * self.spec.rows * self.spec.cols
        return self.cells_used / cap

    def tile_loads(self) -> dict[int, int]:
        """Physical tile id -> active cells resident on it."""
        loads: dict[int, int] = {}
        for lp in self.layers:
            for b in lp.blocks:
                loads[b.tile] = loads.get(b.tile, 0) + b.cells
        return loads

    def preferred_group_size(self) -> int:
        """The WDM K the serving BatchPlanner should group decode by."""
        return self.spec.wdm_k

    def layer(self, name: str) -> LayerPlan:
        for lp in self.layers:
            if lp.name == name:
                return lp
        raise KeyError(f"no layer instance {name!r} in plan for {self.model.name}")

    def layer_for(self, m: int, n: int) -> LayerPlan | None:
        """First placed instance matching a (m, n) weight matrix — the
        `tiled` engine's lookup when handed raw operands."""
        for lp in self.layers:
            if lp.ir.binary and lp.ir.m == m and lp.ir.n == n:
                return lp
        return None

    def instances(self, ir_name: str) -> tuple[LayerPlan, ...]:
        return tuple(lp for lp in self.layers if lp.ir.name == ir_name)


# ---------------------------------------------------------------------------
# Block enumeration + tile assignment
# ---------------------------------------------------------------------------


def _blocks_of(ir: LayerIR, spec: CrossbarSpec, policy: str) -> list[tuple[int, int, int, int]]:
    """(row_block, col_block, rows_used, cols_used) in policy order."""
    grid = TileGrid(rows=2 * ir.m, cols=ir.n, spec=spec)
    R, C = spec.rows, spec.cols

    def geom(rb: int, cb: int) -> tuple[int, int, int, int]:
        return (
            rb, cb,
            min(R, 2 * ir.m - rb * R),
            min(C, ir.n - cb * C),
        )

    if policy == "column-major":
        return [geom(rb, cb) for cb in range(grid.col_tiles) for rb in range(grid.row_tiles)]
    # tacitmap order (also the enumeration greedy starts from): row-major
    return [geom(rb, cb) for rb in range(grid.row_tiles) for cb in range(grid.col_tiles)]


def _instance_irs(model: ModelIR) -> Iterable[tuple[str, LayerIR]]:
    for ir in model.layers:
        if not ir.binary:
            continue
        for i in range(ir.count):
            yield (f"{ir.name}[{i}]" if ir.count > 1 else ir.name), ir


def allocate(
    source,
    spec: CrossbarSpec = EPCM_TILE,
    policy: str = "tacitmap",
    tile_budget: int | None = None,
    spare_tiles: int = 0,
    avoid_tiles=(),
) -> MappingPlan:
    """Compile a model (ModelConfig / NetworkDesc / ModelIR) into a
    :class:`MappingPlan` under one placement policy.

    ``tile_budget`` caps the physical tile pool; ``None`` provisions one
    tile per block (the spatial-architecture ideal every policy then
    trivially satisfies with steps_per_vector == 1).

    Fault tolerance: ``spare_tiles`` provisions that many extra
    physical tiles holding no data — the remap destinations
    :func:`remap_plan` draws from when tiles fail in the field.
    ``avoid_tiles`` names physical tile ids the allocator must skip
    entirely (a known fault map): data and spares are assigned to the
    lowest usable ids around the holes, so a plan compiled against a
    fault map never touches a bad tile.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown mapping policy {policy!r}; known: {', '.join(POLICIES)}")
    if tile_budget is not None and tile_budget < 1:
        raise ValueError(f"tile_budget must be >= 1, got {tile_budget}")
    if spare_tiles < 0:
        raise ValueError(f"spare_tiles must be >= 0, got {spare_tiles}")
    avoid = frozenset(int(t) for t in avoid_tiles)
    if any(t < 0 for t in avoid):
        raise ValueError(f"avoid_tiles must be >= 0: {sorted(avoid)}")
    model = to_ir(source)
    wavelengths = tuple(range(spec.wdm_k))

    # enumerate every (instance, block) in policy order
    pending: list[tuple[str, LayerIR, tuple[int, int, int, int]]] = []
    for inst_name, ir in _instance_irs(model):
        for blk in _blocks_of(ir, spec, policy):
            pending.append((inst_name, ir, blk))
    if not pending:
        raise ValueError(f"{model.name}: IR has no binary layers to place")

    n_tiles = len(pending) if tile_budget is None else min(tile_budget, len(pending))

    # the physical pool: lowest tile ids that are not avoided — first
    # ``n_tiles`` hold data, the next ``spare_tiles`` are the spares
    pool: list[int] = []
    t = 0
    while len(pool) < n_tiles + spare_tiles:
        if t not in avoid:
            pool.append(t)
        t += 1
    data_pool, spare_pool = pool[:n_tiles], pool[n_tiles:]

    # tile assignment
    assigned: list[tuple[str, LayerIR, tuple[int, int, int, int], int]] = []
    if policy == "greedy":
        # LPT: heaviest block first onto the least-loaded physical tile
        # (a (load, tile) heap keeps this O(B log T) — qwen-class plans
        # place ~10k blocks)
        heap = [(0, t) for t in data_pool]
        heapq.heapify(heap)
        order = sorted(
            range(len(pending)), key=lambda i: -(pending[i][2][2] * pending[i][2][3])
        )
        tiles_by_index: dict[int, int] = {}
        for i in order:
            load, t = heapq.heappop(heap)
            tiles_by_index[i] = t
            heapq.heappush(heap, (load + pending[i][2][2] * pending[i][2][3], t))
        for i, (inst, ir, blk) in enumerate(pending):
            assigned.append((inst, ir, blk, tiles_by_index[i]))
    else:
        # sequential striping in enumeration order (round-robin under a
        # budget — the deterministic layouts the paper figures draw)
        for i, (inst, ir, blk) in enumerate(pending):
            assigned.append((inst, ir, blk, data_pool[i % n_tiles]))

    # group back into per-instance LayerPlans, preserving block order
    by_instance: dict[str, list[BlockPlacement]] = {}
    ir_of: dict[str, LayerIR] = {}
    for inst, ir, (rb, cb, ru, cu), tile in assigned:
        by_instance.setdefault(inst, []).append(
            BlockPlacement(layer=inst, row_block=rb, col_block=cb, tile=tile,
                           rows_used=ru, cols_used=cu)
        )
        ir_of[inst] = ir

    layer_plans = tuple(
        LayerPlan(
            name=inst,
            ir=ir_of[inst],
            grid=TileGrid(rows=2 * ir_of[inst].m, cols=ir_of[inst].n, spec=spec),
            blocks=tuple(blocks),
            wavelengths=wavelengths,
        )
        for inst, blocks in by_instance.items()
    )
    return MappingPlan(
        model=model, spec=spec, policy=policy,
        tile_budget=tile_budget, layers=layer_plans,
        spares=tuple(spare_pool), avoid_tiles=tuple(sorted(avoid)),
    )


# ---------------------------------------------------------------------------
# Fault-aware remapping
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockMove:
    """One weight block relocated from a failed tile to a spare."""

    layer: str
    row_block: int
    col_block: int
    src: int
    dst: int
    cells: int


@dataclasses.dataclass(frozen=True)
class RemapDelta:
    """What a remap did and what it costs to reprogram.

    ``cost`` prices ONLY the moved blocks (tiles reprogram in parallel,
    rows within a destination tile serially — the same physics as
    ``costmodel.layer_programming_cost``), which is the whole point of
    incremental remapping: untouched tiles keep their cells.
    """

    moves: tuple[BlockMove, ...]
    cost: "object"  # costmodel.ProgrammingCost (lazy import below)


def remap_plan(
    plan: MappingPlan,
    failed_tiles,
    *,
    tile_ok=None,
) -> tuple[MappingPlan, RemapDelta]:
    """Re-place only the blocks resident on ``failed_tiles`` onto the
    plan's spare pool.

    ``tile_ok`` (optional predicate ``tile_id -> bool``) lets the caller
    BIST candidate spares before committing — the serving path passes
    ``FaultyEngine.tile_is_clean`` so a remap never lands on a spare
    that is itself faulty. Spares consumed (or found failed/unclean)
    leave the pool; failed tiles join ``avoid_tiles`` so a later
    recompile also skips them. Raises :class:`SpareTilesExhaustedError`
    when the usable spare pool can't cover the displaced blocks.
    """
    from repro_torch.core import costmodel

    failed = frozenset(int(t) for t in failed_tiles)
    params = costmodel.params_for_spec(plan.spec)
    if not failed:
        return plan, RemapDelta(
            moves=(), cost=costmodel.ProgrammingCost(cells=0, energy_pj=0.0, time_ns=0.0)
        )

    candidates = [
        t for t in plan.spares
        if t not in failed and (tile_ok is None or tile_ok(t))
    ]
    displaced = sum(
        1 for lp in plan.layers for b in lp.blocks if b.tile in failed
    )
    if displaced > len(candidates):
        raise SpareTilesExhaustedError(
            f"{plan.model.name}: {displaced} block(s) displaced from failed "
            f"tiles {sorted(failed)} but only {len(candidates)} clean spare "
            f"tile(s) usable (of {len(plan.spares)} provisioned)"
        )

    moves: list[BlockMove] = []
    next_spare = iter(candidates)
    used: set[int] = set()
    rows_per_dst: dict[int, int] = {}
    new_layers = []
    for lp in plan.layers:
        blocks = []
        for b in lp.blocks:
            if b.tile in failed:
                dst = next(next_spare)
                used.add(dst)
                moves.append(BlockMove(
                    layer=lp.name, row_block=b.row_block, col_block=b.col_block,
                    src=b.tile, dst=dst, cells=b.cells,
                ))
                rows_per_dst[dst] = rows_per_dst.get(dst, 0) + b.rows_used
                b = dataclasses.replace(b, tile=dst)
            blocks.append(b)
        new_layers.append(dataclasses.replace(lp, blocks=tuple(blocks)))

    new_plan = dataclasses.replace(
        plan,
        layers=tuple(new_layers),
        spares=tuple(t for t in plan.spares if t not in used and t not in failed),
        avoid_tiles=tuple(sorted(set(plan.avoid_tiles) | failed)),
    )

    # price the reprogramming: destination tiles write in parallel, rows
    # within one destination serially (mirrors layer_programming_cost)
    cells = sum(mv.cells for mv in moves)
    time_ns = (max(rows_per_dst.values()) * params.t_row_write_ns) if rows_per_dst else 0.0
    cost = costmodel.ProgrammingCost(
        cells=cells,
        energy_pj=cells * params.e_cell_write_pj,
        time_ns=time_ns,
    )
    return new_plan, RemapDelta(moves=tuple(moves), cost=cost)


def balance_ratio(plan: MappingPlan) -> float:
    """max tile load / mean tile load (1.0 = perfectly balanced) over the
    provisioned pool — the quantity the greedy policy minimizes."""
    loads = plan.tile_loads()
    pool = [loads.get(t, 0) for t in range(plan.n_tiles)]
    mean = sum(pool) / len(pool)
    return max(pool) / mean if mean else 1.0


def required_tiles(source, spec: CrossbarSpec = EPCM_TILE) -> int:
    """Blocks (= dedicated tiles) a model needs with no budget — handy
    for sizing ``tile_budget`` sweeps."""
    model = to_ir(source)
    total = 0
    for ir in model.layers:
        if not ir.binary:
            continue
        g = TileGrid(rows=2 * ir.m, cols=ir.n, spec=spec)
        total += g.n_tiles * ir.count
    return total

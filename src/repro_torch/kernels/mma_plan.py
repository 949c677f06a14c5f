"""Launch plans and variant choice of the tensor-core GEMM-like kernels:
bitlinear and the WDM MMM -- one Hopper tile loop (``csrc/sm90_mma.cuh``)
behind both -- and, at the end of this module, the Hamming matmul
(``csrc/xnor_matmul.cu``) and the fused BitLinear (``csrc/fused_decode.cu``),
one binary tensor-core tile loop (``csrc/sm90_b1.cuh``) behind both.

Variant ``sm90`` (TMA + wgmma + cluster split-K) takes every shape TMA
can describe: 16-byte-aligned bases for x, w, alpha and out, n % 8 == 0
(w's row stride) and m * itemsize(x) % 16 == 0 (x's row stride). Any
other shape takes variant ``wmma``. :func:`choose` picks before the
launch, from shapes and ``data_ptr()`` alone; a wrapper never retries
another variant, or the plain version, after a failed launch.

The plan is computed here, not in the kernel, so that the CPU tests can
check it: a 128-column n tile per CTA, a row tile of N rows (wgmma's N,
8..128; more rows take more row tiles), a split S of the contraction
over the S CTAs of a cluster (S <= 8, enough CTAs for the card's SMs,
each split at least one 64-feature k tile), and a ring depth sized for
two CTAs per SM where three stages fit, else one CTA with the deepest
ring that fits. :func:`smem_bytes` mirrors ``sm90mma::smem_bytes``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

BN = 128  # n columns per CTA
BK = 64  # features per stage
PITCH = BN + 4  # fp32 partial-tile row pitch
W_STAGE_BYTES = BN * BK * 2
ROW_TILES = (8, 16, 32, 64, 128)
MAX_SPLIT = 8
MAX_STAGES = 8
MAX_SMEM = 232448  # per block on sm_90
TWO_PER_SM_SMEM = (233472 - 2 * 1024) // 2  # 228 KB per SM, 1 KB reserved per block
H100_SMS = 132
VARIANTS = {"wmma": 0, "sm90": 1}  # the C entry points' variant numbers


@dataclasses.dataclass(frozen=True)
class Plan:
    variant: str
    row_tile: int = 0
    split: int = 1
    stages: int = 0
    grid: tuple[int, int, int] = (0, 0, 0)
    smem: int = 0

    @property
    def ctas(self) -> int:
        return math.prod(self.grid)

    @property
    def args(self) -> tuple[int, int, int, int]:
        """(variant, row tile, split, stages) as the C entry points take them."""
        return VARIANTS[self.variant], self.row_tile, self.split, self.stages

    def describe(self) -> str:
        if self.variant != "sm90":
            return f"variant {self.variant} (64 x 64 output tiles, {self.ctas} blocks)"
        return (f"variant sm90: n tile {BN}, row tile {self.row_tile}, split {self.split} "
                f"(cluster {self.split}x1x1), grid {self.grid}, {self.ctas} CTAs, "
                f"{self.stages} stages, {self.smem} B shared memory")


def smem_bytes(row_tile: int, x_size: int, sign: bool, stages: int) -> int:
    """Dynamic shared memory of one sm90 CTA: 1 KB of alignment slack, the
    stage ring (reused for the fp32 partial tile), the double buffer of ±1
    tiles (bitlinear on fp32 x; bf16 x is binarized in place) and the
    barriers."""
    stage = W_STAGE_BYTES + row_tile * BK * x_size
    ring = -(-max(stages * stage, row_tile * PITCH * 4) // 1024) * 1024
    return 1024 + ring + (2 * row_tile * BK * 2 if sign and x_size == 4 else 0) + 16 * stages


def sm90_plan(rows: int, m: int, n: int, x_size: int, sign: bool, sms: int = H100_SMS) -> Plan:
    row_tile = next((t for t in ROW_TILES if t >= rows), ROW_TILES[-1])
    tiles = -(-n // BN) * -(-rows // row_tile)
    kt = -(-m // BK)
    split = max(1, min(MAX_SPLIT, kt, -(-sms // tiles)))
    split = -(-kt // -(-kt // split))  # no split without a k tile
    fits = [s for s in range(2, MAX_STAGES + 1)
            if smem_bytes(row_tile, x_size, sign, s) <= TWO_PER_SM_SMEM]
    if not fits or fits[-1] < 3:
        fits = [s for s in range(2, MAX_STAGES + 1)
                if smem_bytes(row_tile, x_size, sign, s) <= MAX_SMEM]
    stages = fits[-1]
    return Plan("sm90", row_tile, split, stages,
                (split, -(-n // BN), -(-rows // row_tile)),
                smem_bytes(row_tile, x_size, sign, stages))


def wmma_plan(rows: int, n: int) -> Plan:
    return Plan("wmma", grid=(-(-n // 64), -(-rows // 64), 1))


def tma_ok(rows: int, m: int, n: int, x_size: int, ptrs: tuple[int, ...]) -> bool:
    """Whether TMA can describe the operands: 16-byte-aligned bases, n % 8
    == 0 and m * x_size % 16 == 0 (the row strides of w and x)."""
    return (rows > 0 and m > 0 and n % 8 == 0 and (m * x_size) % 16 == 0
            and all(p % 16 == 0 for p in ptrs))


def choose(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
           alpha: torch.Tensor | None = None) -> Plan:
    """The variant and plan for (rows, m) x @ (m, n) w into out, by shape
    and pointer alignment, before any launch."""
    rows, m = x.shape
    n = w.shape[1]
    ptrs = tuple(t.data_ptr() for t in (x, w, out, alpha) if t is not None)
    if tma_ok(rows, m, n, x.element_size(), ptrs):
        return sm90_plan(rows, m, n, x.element_size(), alpha is not None, _sm_count(x.device))
    return wmma_plan(rows, n)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# the binary tensor-core tile loop (csrc/sm90_b1.cuh) behind the Hamming
# matmul and the fused BitLinear: variant "b1" (TMA + mma.sync m16n8k256 on
# the binary tensor cores + cluster split-K) for operands TMA can describe,
# variant "popc" (the 32-bit popcount kernels) otherwise
# ---------------------------------------------------------------------------

HAM_BN = 128  # weight columns per consumer warpgroup (b1::kBN)
HAM_BKW = 8  # packed words per k stage (256 bits: one instruction)
HAM_PITCH = HAM_BN + 4  # int32 partial-tile row pitch of one warpgroup (b1::pitch(1))
HAM_ROW_TILES = (8, 16, 32, 64)
HAM_MAX_STAGES = 8
HAM_VARIANTS = ("popc", "b1")
W_BOX_STAGE = HAM_BN * HAM_BKW * 4  # a warpgroup's weight words per stage (b1::kWBytes)


def b1_smem_bytes(row_tile: int, wg: int, x_row: int, tile_row: int, stages: int) -> int:
    """Mirrors ``b1::smem_bytes``: 1 KB of alignment slack, the ring (per
    stage ``wg`` weight tiles, the activation box of ``x_row`` bytes a row
    and the packed tile of ``tile_row`` bytes a row built from it; reused
    for the int32 partial tile) and the barriers."""
    ring = max(stages * (wg * W_BOX_STAGE + row_tile * (x_row + tile_row)),
               row_tile * (wg * HAM_BN + HAM_PITCH - HAM_BN) * 4)
    return 1024 + -(-ring // 1024) * 1024 + 16 * stages


@dataclasses.dataclass(frozen=True)
class HammingPlan:
    variant: str
    row_tile: int = 0
    split: int = 1
    stages: int = 0
    grid: tuple[int, int, int] = (0, 0, 0)
    smem: int = 0

    @property
    def ctas(self) -> int:
        return math.prod(self.grid)

    @property
    def args(self) -> tuple[int, int, int]:
        """(row tile, split, stages) as ``hamming_matmul_b1`` takes them."""
        return self.row_tile, self.split, self.stages

    def describe(self) -> str:
        if self.variant != "b1":
            return f"variant {self.variant} (8 rows x 128 columns per block, {self.ctas} blocks)"
        return (f"variant b1: n tile {HAM_BN}, row tile {self.row_tile}, split {self.split} "
                f"(cluster {self.split}x1x1), grid {self.grid}, {self.ctas} CTAs, "
                f"{self.stages} stages of {HAM_BKW} words, {self.smem} B shared memory")


def hamming_smem_bytes(row_tile: int, stages: int) -> int:
    """Shared memory of one b1 Hamming CTA: one warpgroup, the packed
    words by TMA as the tile."""
    return b1_smem_bytes(row_tile, 1, HAM_BKW * 4, 0, stages)


def hamming_plan(rows: int, kw: int, n: int, sms: int = H100_SMS) -> HammingPlan:
    """A 128-column n tile and a row tile of 8..64 rows per CTA -- the
    smallest that holds the rows, halved while there are fewer tiles than
    ``sms`` (re-reading a tile's operands from L2 is cheaper than a
    split-K reduction through distributed shared memory) -- then a split
    S <= 8 of the kw words over a cluster for >= ``sms`` CTAs where the k
    stages allow (each split holds at least one), and a ring as deep as a
    split's stages (2..8)."""
    def tiles_of(t: int) -> int:
        return -(-n // HAM_BN) * -(-rows // t)

    row_tile = next((t for t in HAM_ROW_TILES if t >= rows), HAM_ROW_TILES[-1])
    while row_tile > HAM_ROW_TILES[0] and tiles_of(row_tile) < sms:
        row_tile //= 2
    tiles = tiles_of(row_tile)
    kt = -(-kw // HAM_BKW)
    split = max(1, min(MAX_SPLIT, kt, -(-sms // tiles)))
    split = -(-kt // -(-kt // split))  # no split without a k stage
    stages = min(HAM_MAX_STAGES, max(2, -(-kt // split)))
    return HammingPlan("b1", row_tile, split, stages,
                       (split, -(-n // HAM_BN), -(-rows // row_tile)),
                       hamming_smem_bytes(row_tile, stages))


def hamming_tma_ok(rows: int, kw: int, n: int, lda: int, ldw: int, ptrs: tuple[int, ...]) -> bool:
    """Whether TMA can describe the packed operands: row strides of a and
    w that are multiples of 4 words (16 bytes) and 16-byte-aligned bases."""
    return (rows > 0 and kw > 0 and n > 0 and lda % 4 == 0 and ldw % 4 == 0
            and all(p % 16 == 0 for p in ptrs))


def choose_hamming(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> HammingPlan:
    """The variant and plan for (rows, kw) words ``a`` against the (KW',
    N') word artifact ``w`` into (rows, n) ``out``, by strides and
    pointer alignment, before any launch."""
    rows, kw = a.shape
    n = out.shape[1]
    if hamming_tma_ok(rows, kw, n, a.stride(0), w.stride(0),
                      (a.data_ptr(), w.data_ptr(), out.data_ptr())):
        return hamming_plan(rows, kw, n, _sm_count(a.device))
    return HammingPlan("popc", grid=(-(-rows // 8), -(-n // 128), 1))


# ---------------------------------------------------------------------------
# the fused BitLinear (csrc/fused_decode.cu): variant "b1" binarizes and
# packs raw activations inside the b1 tile loop, variant "popc" is the
# 32-bit popcount kernel
# ---------------------------------------------------------------------------

FUSED_FEATURES = HAM_BKW * 32  # features per k stage (b1::kStageFeatures)
FUSED_WGS = (1, 2)  # consumer warpgroups per CTA: 128- or 256-column n tiles
FUSED_ROW_TILES = (8, 16, 32)
FUSED_VARIANTS = ("popc", "b1")


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    variant: str
    row_tile: int = 0
    wg: int = 1
    split: int = 1
    stages: int = 0
    grid: tuple[int, int, int] = (0, 0, 0)
    smem: int = 0

    @property
    def ctas(self) -> int:
        return math.prod(self.grid)

    @property
    def args(self) -> tuple[int, int, int, int]:
        """(row tile, warpgroups, split, stages) as ``fused_bnn_matmul_b1_*``
        take them."""
        return self.row_tile, self.wg, self.split, self.stages

    def describe(self) -> str:
        if self.variant != "b1":
            return f"variant {self.variant} (8 rows x 128 columns per block, {self.ctas} blocks)"
        return (f"variant b1: n tile {self.wg * HAM_BN} ({self.wg} consumer warpgroup"
                f"{'s' if self.wg > 1 else ''}), row tile {self.row_tile}, split {self.split} "
                f"(cluster {self.split}x1x1), grid {self.grid}, {self.ctas} CTAs, "
                f"{self.stages} stages of {FUSED_FEATURES} features, {self.smem} B shared memory")


def fused_smem_bytes(row_tile: int, wg: int, x_size: int, stages: int) -> int:
    """Shared memory of one fused b1 CTA: ``wg`` warpgroups, a box of
    256 features of x in its dtype and the 8-word tile packed from it."""
    return b1_smem_bytes(row_tile, wg, FUSED_FEATURES * x_size, HAM_BKW * 4, stages)


def fused_plan(rows: int, m: int, n: int, x_size: int, sms: int = H100_SMS,
               wg: int | None = None) -> FusedPlan:
    """As :func:`hamming_plan` over n tiles of ``wg`` * 128 columns -- a row
    tile of 8..32 rows (FUSED_ROW_TILES), the smallest that holds the
    rows, halved while there are fewer tiles than ``sms``; then a split
    S <= 8 of the k stages over a cluster, the fewest stages per split
    that give >= ``sms`` CTAs where the stages allow.

    The choices below were measured on an H100 (``tools/tc_probe.py
    --sections fused``; PERF.md). x is 16x (bf16) or 32x (fp32) the bytes
    of its packed words, and every n tile re-reads and re-packs it: past
    a decode tick's 8 rows two warpgroups (a 256-column n tile, half the
    packing per output) are taken, at 8 rows one. The row tile stops at
    32 rows, and a grid of more CTAs than SMs gets a 2-stage ring: a CTA
    packs, multiplies and stores in turn, and more CTAs per SM fill each
    other's gaps better than a deeper ring (a 64-row tile or a deeper
    ring holds fewer CTAs per SM and left a partial last wave at 1024
    rows). A grid the card holds at once gets a ring as deep as a split's
    stages (2..8) within 227 KB."""
    kt = -(-m // FUSED_FEATURES)
    if wg is None:
        wg = 2 if rows > FUSED_ROW_TILES[0] else 1
    n_tiles = -(-n // (wg * HAM_BN))
    row_tile = next((t for t in FUSED_ROW_TILES if t >= rows), FUSED_ROW_TILES[-1])
    while row_tile > FUSED_ROW_TILES[0] and n_tiles * -(-rows // row_tile) < sms:
        row_tile //= 2
    tiles = n_tiles * -(-rows // row_tile)
    # the fewest k stages per split that still give >= sms CTAs where the
    # stages allow; then no split without a k stage
    per_cta = -(-sms // tiles)
    kt_per = max(-(-kt // MAX_SPLIT), kt // per_cta if per_cta <= kt else 1)
    split = -(-kt // kt_per)
    fits = [s for s in range(2, min(HAM_MAX_STAGES, max(2, kt_per)) + 1)
            if fused_smem_bytes(row_tile, wg, x_size, s) <= MAX_SMEM]
    stages = 2 if split * tiles > sms else fits[-1]
    return FusedPlan("b1", row_tile, wg, split, stages, (split, n_tiles, -(-rows // row_tile)),
                     fused_smem_bytes(row_tile, wg, x_size, stages))


def fused_tma_ok(rows: int, m: int, n: int, ldx: int, x_size: int, ldw: int,
                 ptrs: tuple[int, ...]) -> bool:
    """Whether TMA can describe the operands: x's row stride a multiple of
    16 bytes, the weight row stride a multiple of 4 words and 16-byte
    aligned bases (alpha and beta are read element by element)."""
    return (rows > 0 and m > 0 and n > 0 and (ldx * x_size) % 16 == 0 and ldw % 4 == 0
            and all(p % 16 == 0 for p in ptrs))


def choose_fused(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, alpha: torch.Tensor,
                 beta: torch.Tensor, *, m: int | None = None) -> FusedPlan:
    """The variant and plan for (rows, >= m) activations ``x`` against
    the (KW', N') word artifact ``w`` into (rows, n) ``out`` with scales
    ``alpha`` (n,) and ``beta`` (rows,), by dtype, strides and pointer
    alignment, before any launch. ``m`` defaults to x's width."""
    del alpha, beta  # read element by element: any base will do
    rows = x.shape[0]
    m = x.shape[1] if m is None else int(m)
    n = out.shape[1]
    if fused_tma_ok(rows, m, n, x.stride(0), x.element_size(), w.stride(0),
                    (x.data_ptr(), w.data_ptr(), out.data_ptr())):
        return fused_plan(rows, m, n, x.element_size(), _sm_count(x.device))
    return FusedPlan("popc", grid=(-(-rows // 8), -(-n // 128), 1))

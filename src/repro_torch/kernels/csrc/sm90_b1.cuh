// The binary tensor-core tile loop for Hopper (sm_90a) behind two kernels
// of the port, each the "b1" variant of its entry point:
//   - xnor_matmul.cu: the packed Hamming matmul,
//       ham[b, c] = sum_{j < kw} popc(a[b, j] ^ w[j, c])            (int32)
//     with activations already packed (ops.pack_bits layout);
//   - fused_decode.cu: the fused BitLinear,
//       out[b, c] = float(m - 2 * ham[b, c]) * (alpha[c] * beta[b])   (fp32)
//     with raw bf16/fp32 activations that the kernel binarizes and packs.
// The tile loop is templated on two policies: the activation stage
// (PackedWords, RawRows<T>) and the epilogue (HammingOut, BitLinearOut).
// Launch-plan constants are mirrored by kernels/mma_plan.py.
//
//   - Instruction: mma.sync m16n8k256 .b1 with .and.popc. ptxas also takes
//     .xor.popc for sm_90a, but on an H100 it runs at 832 T bit-operations/s
//     against 5126 T for .and.popc (tools/tc_probe.py), so the loop uses
//     ham = popc(a) + popc(w) - 2 * popc(a & w), summed per split over the
//     words that split reads. Exact in int32; pad bits are 0 on both sides
//     and add 0 to every term.
//   - Roles swapped as in sm90_mma.cuh: weight columns are the
//     instruction's M (16), activation rows its N (8), so 8 decode rows
//     cost N = 8. A CTA owns WG consumer warpgroups of 128 columns each
//     (WG = 1, or 2 for the fused kernel's wide n tile, which halves how
//     often x is re-read and re-packed per output) sharing one activation
//     tile, and a row tile of 8..64 rows. One producer warp keeps 8-word (256-feature) k stages in flight
//     through a ring of full/empty mbarriers: 4 * WG 32-column x 8-word
//     weight boxes by TMA with a 128-byte swizzle, straight from the
//     (KW', N') word layout of the artifact (the tensor map's k extent is
//     kw, so a block-padded artifact's pad words are never read), and the
//     stage's activation box.
//   - Activation stage. PackedWords: the (rows x 8 words) box is the
//     tile the fragments read. RawRows<T>: the box is rows x 256 features
//     of x in its own dtype; the consumer threads binarize it into the
//     (rows x 8 words) tile, one byte (8 features, one 16-byte load of
//     bf16, two of fp32) per thread and task, bit i of word j = feature
//     32j + i, then meet at a named barrier before reading fragments. The
//     test is a comparison, v > -2^-126 (not the sign bit): -0.0 and
//     subnormals of either sign give 1 and NaN 0, as
//     ops.pack_bits(bnn.nonneg(x)) does -- x >= 0 with subnormals read as
//     zero, as XLA reads them. The threshold is a normal number, so the
//     bit is the same whether or not a comparison flushes subnormals.
//     bf16 pairs are compared by one bf16x2 instruction (__hgt2_mask),
//     fp32 values one by one. TMA zero-fills features past m, and 0.0
//     would be bit 1, which
//     popc(a) would count and popc(a & w) would not: features >= m are
//     masked by index when packing. The tile of stage s is rewritten only
//     after every consumer has passed the named barrier of a later stage,
//     so one barrier per stage suffices.
//   - Fragments from shared memory, conflict-free. The instruction's 8 k
//     words are mapped to the stage's word rows so that thread (g, t)
//     (g = lane / 4, t = lane % 4) holds k words t and t + 4 at rows 2t
//     and 2t + 1, and its M rows g and g + 8 of two instructions at
//     columns 4g .. 4g + 3: two 16-byte loads per 32-column box, whose
//     swizzled chunks g ^ row fall on 8 distinct chunks per quarter warp.
//     The activation side reads 8 bytes (words 2t, 2t + 1) of row g.
//     popc(w) of those words and popc(a) of the row's words are summed by
//     each thread as it reads them and completed over the quad by two xor
//     shuffles after the loop.
//   - Split-K over a thread-block cluster (S <= 8, planned in Python so
//     that the decode shapes reach >= 128 CTAs where K allows): each rank
//     keeps its int32 partial tile popc(a) + popc(w) - 2 popc(a & w) over
//     its own words in shared memory; after a cluster barrier every rank
//     sums a share of the tile over the ranks through distributed shared
//     memory (integer sums: any order is exact), applies the epilogue and
//     stores; a second barrier keeps every rank resident until read. No
//     atomics, no second launch, no memset. BitLinearOut multiplies
//     alpha * beta first, then by the exact integer m - 2 * ham, the
//     association of the plain version and of the reference.
//   - Edges. TMA zero-fills rows past `rows`, words past kw, features past
//     m and columns past n: a zero word adds 0 to every term (features are
//     masked, see above). A 32-column box wholly past n re-reads the
//     tile's first box (its results are never stored).

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace {
namespace b1 {

using namespace sm90ptx;

constexpr int kBN = 128;                        // weight columns per consumer warpgroup
constexpr int kBoxCols = 32;                    // columns per weight box (128 bytes)
constexpr int kBKW = 8;                         // words per k stage (one instruction)
constexpr int kStageFeatures = kBKW * 32;       // 256
constexpr int kWBytes = kBN * kBKW * 4;         // a warpgroup's stage of weights: 4 boxes
constexpr int kBoxBytes = kBoxCols * kBKW * 4;  // 1 KB
constexpr int kConsumerThreads = 128;           // one warpgroup
constexpr int kMaxSplit = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;
// the binarize threshold: bit 1 where x > -2^-126, the least normal
// magnitude negated (bnn.NEG_MIN_NORMAL)
constexpr float kNegMinNormal = -0x1p-126f;

// int32 partial-tile row pitch of a CTA with `wg` consumer warpgroups
__host__ __device__ constexpr int pitch(int wg) { return wg * kBN + 4; }

// dynamic shared memory: 1 KB of alignment slack, the ring (weight tiles
// of every stage, then activation boxes, then the packed tiles the
// consumers build from raw boxes; the partial tile reuses it after the
// main loop) and the barriers. x_row: bytes of one activation row of a
// stage's box; tile_row: bytes of one packed row built from it (0 when
// the box already holds the words)
__host__ __device__ constexpr int ring_bytes(int rows_tile, int wg, int x_row, int tile_row,
                                             int stages) {
  return round_up(stages * (wg * kWBytes + rows_tile * (x_row + tile_row)) >
                          rows_tile * pitch(wg) * 4
                      ? stages * (wg * kWBytes + rows_tile * (x_row + tile_row))
                      : rows_tile * pitch(wg) * 4,
                  1024);
}
__host__ __device__ constexpr int smem_bytes(int rows_tile, int wg, int x_row, int tile_row,
                                             int stages) {
  return 1024 + ring_bytes(rows_tile, wg, x_row, tile_row, stages) + 16 * stages;
}

__device__ __forceinline__ void mma_and(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// activation stage policies
// ---------------------------------------------------------------------------

// packed int32 words: the (rows x 8 words) box is the tile
struct PackedWords {
  static constexpr bool kPack = false;
  static constexpr int kXRow = kBKW * 4;
  static constexpr int kTileRow = 0;
  static constexpr int kWordsPerCoord = 1;  // the box's inner coordinate is a word index
};

// raw activations in T (bf16 or fp32): a (rows x 256 features) box,
// binarized and packed by the consumer threads
template <typename T>
struct RawRows {
  static constexpr bool kPack = true;
  static constexpr int kXRow = kStageFeatures * static_cast<int>(sizeof(T));
  static constexpr int kTileRow = kBKW * 4;
  static constexpr int kWordsPerCoord = 32;  // the inner coordinate is a feature index

  // bits of the 8 features at src (bit e: feature e > -2^-126)
  static __device__ __forceinline__ uint32_t bits8(const uint8_t* src) {
    uint32_t b = 0;
    if constexpr (sizeof(T) == 2) {
      // one bf16x2 comparison per feature pair (0xFFFF in each half whose
      // feature is > -2^-126), then bits 0, 2, 4, 6 from the low halves and 16,
      // 18, 20, 22 from the high ones, the latter shifted down to 1, 3, 5, 7
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      // -2^-126 is exact in bf16 (0x8080)
      const __nv_bfloat162 lo = __float2bfloat162_rn(kNegMinNormal);
      const uint32_t m0 = __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&v.x), lo);
      const uint32_t m1 = __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&v.y), lo);
      const uint32_t m2 = __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&v.z), lo);
      const uint32_t m3 = __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&v.w), lo);
      const uint32_t y = (m0 & 0x00010001u) | (m1 & 0x00040004u) | (m2 & 0x00100010u) |
                         (m3 & 0x00400040u);
      b = (y | (y >> 15)) & 0xFFu;
    } else {
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 16);
      const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) b |= static_cast<uint32_t>(f[i] > kNegMinNormal) << i;
    }
    return b;
  }

  // binarize the stage's box (features f0 .. f0 + 255 of N rows) into the
  // (N x 8 words) tile: task q = (row q / 32, byte q % 32), a warp's 32
  // tasks one row's 32 neighbouring 16-byte (bf16) chunks; features >= m
  // masked to 0
  template <int N, int kThreads>
  static __device__ __forceinline__ void pack(const uint8_t* box, uint8_t* tile, int tid, int f0,
                                              int m) {
    static_assert(N * 32 % kThreads == 0, "tasks per stage must split evenly");
#pragma unroll
    for (int it = 0; it < N * 32 / kThreads; ++it) {
      const int q = tid + it * kThreads;
      const int r = q >> 5, k = q & 31;
      uint32_t byte = bits8(box + r * kXRow + k * 8 * static_cast<int>(sizeof(T)));
      const int f = f0 + 8 * k;
      if (f + 8 > m) byte &= f >= m ? 0u : (1u << (m - f)) - 1u;
      tile[r * kTileRow + k] = static_cast<uint8_t>(byte);
    }
  }
};

// ---------------------------------------------------------------------------
// epilogue policies: the summed Hamming counts of 4 neighbouring columns
// ---------------------------------------------------------------------------

struct HammingOut {
  int32_t* out;
  __device__ __forceinline__ void store(int row, int col, int4 ham, int n) const {
    int32_t* o = out + static_cast<int64_t>(row) * n + col;
    if (n % 4 == 0) {
      *reinterpret_cast<int4*>(o) = ham;
    } else {
      const int vals[4] = {ham.x, ham.y, ham.z, ham.w};
      for (int e = 0; e < 4 && col + e < n; ++e) o[e] = vals[e];
    }
  }
};

// Eq. 1 and the BitLinear rescale: float(m - 2 ham) * (alpha * beta)
struct BitLinearOut {
  float* out;
  const float* alpha;
  const float* beta;
  int m;
  __device__ __forceinline__ void store(int row, int col, int4 ham, int n) const {
    const float b = beta[row];
    const int h[4] = {ham.x, ham.y, ham.z, ham.w};
    float* o = out + static_cast<int64_t>(row) * n + col;
    if (n % 4 == 0) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = static_cast<float>(m - 2 * h[e]) * (alpha[col + e] * b);
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < 4 && col + e < n; ++e)
        o[e] = static_cast<float>(m - 2 * h[e]) * (alpha[col + e] * b);
    }
  }
};

// ---------------------------------------------------------------------------
// the tile loop
// ---------------------------------------------------------------------------

// grid (S, ceil(n / (WG * kBN)), ceil(rows / N)), cluster (S, 1, 1),
// WG * 128 + 32 threads: warps 0 .. 4 WG - 1 consumers (warpgroup wg owns
// columns wg * 128 ..), the last warp the producer. The consumer warps of a
// warpgroup form a kWM x kWN grid over (columns, rows): each owns
// kBN / kWM columns (kXB boxes, 2 kXB instructions' M) and N / kWN rows
// (kNT instructions' N). m: the features of a raw activation row (the pack
// mask); unused by PackedWords.
template <int N, int WG, class Act, class Epi>
__global__ void __launch_bounds__(WG * kConsumerThreads + 32)
    tile_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap ta,
                const Epi epi, int rows, int n, int kw, int m, int kt_per, int stages) {
  namespace cg = cooperative_groups;
  constexpr int kConsumers = WG * kConsumerThreads;
  constexpr int kThreads = kConsumers + 32;
  constexpr int kCols = WG * kBN;
  constexpr int kPitch = pitch(WG);
  constexpr int kWM = N >= 64 ? 2 : 4;
  constexpr int kWN = 4 / kWM;
  constexpr int kXB = kBN / kWM / kBoxCols;  // weight boxes per warp
  constexpr int kNT = N / kWN / 8;           // 8-row groups per warp
  constexpr int kWStage = WG * kWBytes;      // the stage's weight tiles
  constexpr int kXBytes = N * Act::kXRow;    // the stage's activation box
  constexpr int kTBytes = N * Act::kTileRow; // the stage's packed tile (raw x)

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* wring = smem;                      // stage s at s * kWStage
  uint8_t* xring = smem + stages * kWStage;   // stage s at s * kXBytes
  uint8_t* tring = xring + stages * kXBytes;  // stage s at s * kTBytes
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + ring_bytes(N, WG, Act::kXRow, Act::kTileRow, stages));
  uint64_t* empty = full + stages;
  int32_t* part = reinterpret_cast<int32_t*>(smem);  // after the main loop

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int n0 = blockIdx.y * kCols, r0 = blockIdx.z * N;
  const int kt_total = (kw + kBKW - 1) / kBKW;
  const int kt0 = rank * kt_per;
  const int kt_n = min(kt_per, kt_total - kt0);  // >= 1 by the plan
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    if (lane == 0) {
      prefetch_tensormap(&tw);
      prefetch_tensormap(&ta);
      for (int i = 0; i < kt_n; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        const int k0 = (kt0 + i) * kBKW;
        mbar_expect_tx(&full[s], kWStage + kXBytes);
#pragma unroll
        for (int x = 0; x < kCols / kBoxCols; ++x) {
          const int c = n0 + x * kBoxCols < n ? n0 + x * kBoxCols : n0;
          tma_load(wring + s * kWStage + x * kBoxBytes, &tw, &full[s], c, k0);
        }
        tma_load(xring + s * kXBytes, &ta, &full[s], k0 * Act::kWordsPerCoord, r0);
      }
    }
    __syncwarp();
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int wg = warp / 4, wq = warp % 4;
    const int wm = wq % kWM, wn = wq / kWM;
    // acc: popc(a & w) summed by the instructions; colp / rowp: this
    // thread's share of popc(w) per column and popc(a) per row
    int acc[kXB][2][kNT][4] = {};
    int colp[kXB][4] = {};
    int rowp[kNT] = {};

    for (int i = 0; i < kt_n; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const uint8_t* wt = wring + s * kWStage + wg * kWBytes;
      const uint8_t* at = xring + s * kXBytes;
      if constexpr (Act::kPack) {
        uint8_t* tile = tring + s * kTBytes;
        Act::template pack<N, kConsumers>(at, tile, tid, (kt0 + i) * kStageFeatures, m);
        named_sync<kConsumers>();  // the stage's tile is complete
        at = tile;
      }
      uint2 bf[kNT];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int r = wn * (N / kWN) + nt * 8 + g;
        bf[nt] = *reinterpret_cast<const uint2*>(at + r * (kBKW * 4) + t * 8);
        rowp[nt] += __popc(bf[nt].x) + __popc(bf[nt].y);
      }
#pragma unroll
      for (int x = 0; x < kXB; ++x) {
        // word rows 2t and 2t + 1 of the box, columns 4g .. 4g + 3, at
        // 16-byte chunk g ^ row (the 128-byte swizzle)
        const uint8_t* box = wt + (wm * kXB + x) * kBoxBytes;
        const uint4 w0 = *reinterpret_cast<const uint4*>(box + (2 * t) * 128 + ((g ^ (2 * t)) << 4));
        const uint4 w1 =
            *reinterpret_cast<const uint4*>(box + (2 * t + 1) * 128 + ((g ^ (2 * t + 1)) << 4));
        colp[x][0] += __popc(w0.x) + __popc(w1.x);
        colp[x][1] += __popc(w0.y) + __popc(w1.y);
        colp[x][2] += __popc(w0.z) + __popc(w1.z);
        colp[x][3] += __popc(w0.w) + __popc(w1.w);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          mma_and(acc[x][0][nt], w0.x, w0.y, w1.x, w1.y, bf[nt].x, bf[nt].y);
          mma_and(acc[x][1][nt], w0.z, w0.w, w1.z, w1.w, bf[nt].x, bf[nt].y);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // complete the popcounts over the quad (k words 2t, 2t + 1 per stage)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      rowp[nt] += __shfl_xor_sync(0xffffffffu, rowp[nt], 1);
      rowp[nt] += __shfl_xor_sync(0xffffffffu, rowp[nt], 2);
    }
#pragma unroll
    for (int x = 0; x < kXB; ++x)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        colp[x][c] += __shfl_xor_sync(0xffffffffu, colp[x][c], 1);
        colp[x][c] += __shfl_xor_sync(0xffffffffu, colp[x][c], 2);
      }
    named_sync<kConsumers>();  // every consumer is done with the ring
    // instruction j of box x: M row g -> column 4g + 2j, g + 8 -> 4g + 2j + 1;
    // C element e: column 4g + 2j + e / 2, row 2t + e % 2 of the 8-row group
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int rbase = wn * (N / kWN) + nt * 8;
      const int pop0 = __shfl_sync(0xffffffffu, rowp[nt], (2 * t) * 4);
      const int pop1 = __shfl_sync(0xffffffffu, rowp[nt], (2 * t + 1) * 4);
#pragma unroll
      for (int x = 0; x < kXB; ++x)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = wg * kBN + (wm * kXB + x) * kBoxCols + 4 * g + 2 * j + (e >> 1);
            const int row = rbase + 2 * t + (e & 1);
            part[row * kPitch + col] =
                colp[x][2 * j + (e >> 1)] + ((e & 1) ? pop1 : pop0) - 2 * acc[x][j][nt][e];
          }
    }
  }

  cluster.sync();  // every partial tile of the cluster is written
  const int valid_rows = min(N, rows - r0);
  for (int q = rank * kThreads + tid; q < N * (kCols / 4); q += splits * kThreads) {
    const int r = q / (kCols / 4), c = (q % (kCols / 4)) * 4;
    if (r >= valid_rows || n0 + c >= n) continue;
    const int32_t* p = part + r * kPitch + c;
    int4 sum = *reinterpret_cast<const int4*>(cluster.map_shared_rank(p, 0));
    for (int s = 1; s < splits; ++s) {
      const int4 v = *reinterpret_cast<const int4*>(cluster.map_shared_rank(p, s));
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    epi.store(r0 + r, n0 + c, sum, n);
  }
  cluster.sync();  // every rank stays resident until its peers have read it
}

template <int N, int WG, class Act, class Epi>
int launch_n(const CUtensorMap* tw, const CUtensorMap* ta, const Epi& epi, int rows, int n, int kw,
             int m, int split, int stages, cudaStream_t stream) {
  static cudaError_t opt = cudaErrorNotReady;  // the shared-memory opt-in, once per instance
  if (opt != cudaSuccess)
    opt = cudaFuncSetAttribute(tile_kernel<N, WG, Act, Epi>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  const int kt_total = (kw + kBKW - 1) / kBKW;
  const int kt_per = (kt_total + split - 1) / split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (n + WG * kBN - 1) / (WG * kBN), (rows + N - 1) / N);
  cfg.blockDim = dim3(WG * kConsumerThreads + 32);
  cfg.dynamicSmemBytes = smem_bytes(N, WG, Act::kXRow, Act::kTileRow, stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, tile_kernel<N, WG, Act, Epi>, *tw, *ta, epi,
                                           rows, n, kw, m, kt_per, stages);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int WG, class Act, class Epi>
int dispatch_rows(int row_tile, const CUtensorMap* tw, const CUtensorMap* ta, const Epi& epi,
                  int rows, int n, int kw, int m, int split, int stages, cudaStream_t stream) {
  switch (row_tile) {
    case 8: return launch_n<8, WG, Act>(tw, ta, epi, rows, n, kw, m, split, stages, stream);
    case 16: return launch_n<16, WG, Act>(tw, ta, epi, rows, n, kw, m, split, stages, stream);
    case 32: return launch_n<32, WG, Act>(tw, ta, epi, rows, n, kw, m, split, stages, stream);
    case 64: return launch_n<64, WG, Act>(tw, ta, epi, rows, n, kw, m, split, stages, stream);
    default: return kErrPlan;
  }
}

inline bool split_ok(int kw, int split) {
  const int kt_total = (kw + kBKW - 1) / kBKW;
  const int kt_per = split > 0 ? (kt_total + split - 1) / split : 0;
  return split >= 1 && split <= kMaxSplit && (split - 1) * kt_per < kt_total;
}

// the (KW', ldw) weight words as a tensor map over (n, kw): 32-column x
// 8-word boxes, 128-byte swizzle
inline int encode_weights(CUtensorMap* tw, const void* w, long long ldw, int n, int kw) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(kw)};
  const cuuint64_t str[1] = {static_cast<cuuint64_t>(ldw) * 4};
  const cuuint32_t box[2] = {kBoxCols, kBKW};
  return encode(tw, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, w, dims, str, box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// The Hamming matmul. a: (rows, lda) words, w: (KW', ldw) words, out:
// (rows, n) int32. The plan (row tile, split, stages) comes from
// mma_plan.hamming_plan and is checked here against what the kernel takes.
inline int run_hamming(const void* a, long long lda, const void* w, long long ldw, void* out,
                       int rows, int n, int kw, int row_tile, int split, int stages,
                       cudaStream_t stream) {
  if (!(rows >= 1 && n >= 1 && kw >= 1 && lda >= kw && ldw >= n && lda % 4 == 0 &&
        ldw % 4 == 0 && split_ok(kw, split) && stages >= 2 && stages <= kMaxStages &&
        smem_bytes(row_tile, 1, PackedWords::kXRow, PackedWords::kTileRow, stages) <= kMaxSmem))
    return kErrPlan;
  CUtensorMap tw, ta;
  int rc = encode_weights(&tw, w, ldw, n, kw);
  if (rc != 0) return rc;
  const cuuint64_t adims[2] = {static_cast<cuuint64_t>(kw), static_cast<cuuint64_t>(rows)};
  const cuuint64_t astr[1] = {static_cast<cuuint64_t>(lda) * 4};
  const cuuint32_t abox[2] = {kBKW, static_cast<cuuint32_t>(row_tile)};
  rc = encode(&ta, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, a, adims, astr, abox,
              CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  const HammingOut epi{static_cast<int32_t*>(out)};
  return dispatch_rows<1, PackedWords>(row_tile, &tw, &ta, epi, rows, n, kw, 32 * kw, split,
                                       stages, stream);
}

// The fused BitLinear. x: (rows, ldx) T, w: (KW', ldw) words, alpha: (n,),
// beta: (rows,), out: (rows, n) fp32. The plan (row tile, warpgroups,
// split, stages) comes from mma_plan.fused_plan and is checked here.
template <typename T>
int run_fused(const void* x, long long ldx, const void* w, long long ldw, const void* alpha,
              const void* beta, void* out, int rows, int n, int m, int row_tile, int wg,
              int split, int stages, cudaStream_t stream) {
  using Act = RawRows<T>;
  const int kw = (m + 31) / 32;
  if (!(rows >= 1 && n >= 1 && m >= 1 && ldx >= m && (ldx * sizeof(T)) % 16 == 0 && ldw >= n &&
        ldw % 4 == 0 && (wg == 1 || wg == 2) && split_ok(kw, split) && stages >= 2 &&
        stages <= kMaxStages &&
        smem_bytes(row_tile, wg, Act::kXRow, Act::kTileRow, stages) <= kMaxSmem))
    return kErrPlan;
  CUtensorMap tw, ta;
  int rc = encode_weights(&tw, w, ldw, n, kw);
  if (rc != 0) return rc;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(m), static_cast<cuuint64_t>(rows)};
  const cuuint64_t xstr[1] = {static_cast<cuuint64_t>(ldx) * sizeof(T)};
  const cuuint32_t xbox[2] = {kStageFeatures, static_cast<cuuint32_t>(row_tile)};
  rc = encode(&ta,
              sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
              2, x, xdims, xstr, xbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  const BitLinearOut epi{static_cast<float*>(out), static_cast<const float*>(alpha),
                         static_cast<const float*>(beta), m};
  if (wg == 2)
    return dispatch_rows<2, Act>(row_tile, &tw, &ta, epi, rows, n, kw, m, split, stages, stream);
  return dispatch_rows<1, Act>(row_tile, &tw, &ta, epi, rows, n, kw, m, split, stages, stream);
}

}  // namespace b1
}  // namespace

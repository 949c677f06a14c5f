// One Hopper (sm_90a) tile loop for the two MMA kernels of the port:
// bitlinear.cu (binarize -> ±1 matmul -> per-column alpha) and wdm_mmm.cu
// (bf16 a @ w). Both are (rows, m) x (m, n) bf16 -> (rows, n) fp32, and
// both are entry points over the templates in this header.
//
// Variant "sm90" (TMA + wgmma + cluster split-K). The product is computed
// transposed, out^T = w^T . b^T, so that the weight's n fills wgmma's
// 64-row M side and the activation rows are wgmma's N (8..128): 8 rows
// cost N = 8 instead of a 64-row tile of which 56 rows are zero.
//   - A CTA owns a 128-column n tile (two m64 halves) and a row tile of
//     N rows. One producer warp keeps 64(k) x 128(n) bf16 weight tiles
//     (two 64 x 64 TMA boxes, 128-byte swizzle) and the matching
//     64(k) x N activation tile in flight through a ring of `stages`
//     stages with full/empty mbarriers. One consumer warpgroup issues
//     wgmma m64nNk16 for both halves: A is the weight tile read n-major
//     (transposed, which bf16 allows), B the activation tile read k-major
//     (x's own row-major layout), and releases a stage as soon as its own
//     products are done. Weight bytes are the whole bound at 8 and 128
//     rows, so the ring is sized for 2 CTAs per SM (3-6 stages, 48-96 KB
//     of weights per CTA); a plan needing one CTA per SM lets fewer
//     clusters be resident at once than the grid has.
//   - bitlinear binarizes in shared memory: a bf16 x tile lands by TMA in
//     wgmma's 128-byte-swizzled layout and the consumer warpgroup rewrites
//     it in place as ±1 (integer ops on bf16 pairs); an fp32 x tile lands
//     unswizzled and is rewritten into a double-buffered ±1 tile. Features
//     past m and rows past the tile become 0, then fence.proxy.async and a
//     warpgroup barrier precede the wgmma that reads them.
//   - Split-K over a thread-block cluster: the S CTAs of a cluster (S <= 8,
//     chosen per shape by the Python wrapper so that there are >= 128
//     CTAs) each stream ceil(KT / S) k tiles and keep their fp32 partial
//     tile in shared memory. After a cluster barrier every rank sums a
//     share of the tile's elements, reading the partials of ranks 0..S-1
//     in that order through distributed shared memory, applies alpha
//     (bitlinear) and stores; a second cluster barrier keeps every rank
//     resident until its peers have read it. No atomics: the sum of every
//     element is taken in the same order on every launch, so the result
//     is bit-identical from launch to launch.
//   - Ragged edges. TMA zero-fills weight rows past m, columns past n and
//     activation elements past m or rows. The MMM relies on that (0 * 0).
//     bitlinear masks features past m to 0 when it binarizes (TMA's 0
//     would binarize to +1); the zero weight rows would make that +1
//     harmless as well, but the mask is the guard relied on. A second m64
//     half past n re-reads the first half's columns: its products are
//     never stored, and every CTA runs the same instructions.
//   - TMA needs 16-byte-aligned bases and row strides: n % 8 == 0 for w,
//     m * sizeof(x) % 16 == 0 for x. Other shapes take the "wmma" variant.
//
// What holds it back (PERF.md, measured on an H100 SXM by
// tools/mma_probe.py): at 8 rows the launch, pipeline fill and the two
// cluster barriers (5.0-5.3 us with one k tile per CTA, against 3.7-4.0
// us for torch.matmul); at 128 rows also the split-K reduction's reads
// through distributed shared memory (3.4-4.3 us for the 64 KB partial
// tile) and the activation tile, re-read once per 128-column n tile: as
// many bytes through L2 as the weights.
//
// Variant "wmma" (any shape): one 4-warp block per 64 x 64 output tile,
// WMMA bf16 m16n16k16 with synchronous shared-memory staging of 32
// features at a time, masked at every ragged edge.
//
// Exactness. ±1 products summed in fp32 are integers below 2^24, exact in
// any order, split partial sums included: with ±1 operands both variants
// equal the plain versions bit for bit. Real-valued bf16 weights (MMM)
// differ from a plain fp32 product by summation order only.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace sm90mma {

using namespace sm90ptx;

// ---------------------------------------------------------------------------
// launch-plan constants (mirrored by repro_torch/kernels/mma_plan.py)
// ---------------------------------------------------------------------------

constexpr int kBN = 128;                        // n columns per CTA
constexpr int kHalf = 64;                       // n columns per wgmma (M = 64)
constexpr int kBK = 64;                         // k per stage (128 bytes of bf16)
constexpr int kWHalfBytes = kHalf * kBK * 2;    // one 64 x 64 bf16 weight box
constexpr int kWBytes = 2 * kWHalfBytes;        // the stage's weight tile
constexpr int kPitch = kBN + 4;                 // fp32 partial-tile row pitch
constexpr int kConsumerThreads = 128;           // one warpgroup
constexpr int kThreads = kConsumerThreads + 32; // + one producer warp
constexpr int kMaxSplit = 8;
constexpr int kMaxSmem = 232448;                // per block, sm_90

// dynamic shared memory of one CTA: 1 KB of alignment slack, the stage
// ring (the fp32 partial tile reuses it after the main loop), the
// binarized B double buffer (bitlinear on fp32 x; bf16 x is binarized in
// place) and the barriers
__host__ __device__ constexpr bool sign_buffer(bool sign, int x_size) { return sign && x_size == 4; }
__host__ __device__ constexpr int stage_bytes(int rows_tile, int x_size) {
  return kWBytes + rows_tile * kBK * x_size;
}
__host__ __device__ constexpr int ring_bytes(int rows_tile, int x_size, int stages) {
  return round_up(stages * stage_bytes(rows_tile, x_size) > rows_tile * kPitch * 4
                      ? stages * stage_bytes(rows_tile, x_size)
                      : rows_tile * kPitch * 4,
                  1024);
}
__host__ __device__ constexpr int smem_bytes(int rows_tile, int x_size, bool sign, int stages) {
  return 1024 + ring_bytes(rows_tile, x_size, stages) +
         (sign_buffer(sign, x_size) ? 2 * rows_tile * kBK * 2 : 0) + 16 * stages;
}

__device__ __forceinline__ void consumer_sync() { named_sync<kConsumerThreads>(); }

// wgmma m64nNk16, bf16 in, fp32 accumulate (D += A.B), A transposed
// (n-major weight tile), B k-major (activation rows)
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// ---------------------------------------------------------------------------
// variant "sm90"
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// sign of two bf16 at once, as ±1 bf16: -1 where the sign bit is set on a
// nonzero value or the value is NaN, else +1 (so -0.0 -> +1). No lane
// carries into the other: |x| + 0x7F and |x| + 0x7FFF stay below 2^16.
__device__ __forceinline__ uint32_t sign_bf16x2(uint32_t b) {
  const uint32_t mag = b & 0x7FFF7FFFu;
  const uint32_t nan = (mag + 0x007F007Fu) & 0x80008000u;      // |x| > inf
  const uint32_t nonzero = (mag + 0x7FFF7FFFu) & 0x80008000u;  // |x| > 0
  return 0x3F803F80u | nan | (b & nonzero);
}

// Rewrite one activation stage as ±1 bf16 in wgmma's 128-byte-swizzled
// k-major layout: row r at r * 128 bytes, its 16-byte chunk c (features
// 8c..8c+7) at chunk c ^ (r % 8). sign(x) = +1 where x >= 0 as read
// (-0.0 -> +1, NaN -> -1); 0 past m and past rows (masks only on an edge
// tile). bf16 x arrives in that layout and is rewritten in place (raw ==
// dst); fp32 x arrives unswizzled (N x kBK, row-major) and goes to dst.
template <typename XT, int N>
__device__ __forceinline__ void binarize_stage(const uint8_t* raw, uint8_t* dst, int k0, int m,
                                               int valid_rows, int tid) {
  constexpr int kChunks = N * 8;  // 16-byte chunks of the ±1 tile
  const bool edge = k0 + kBK > m || valid_rows < N;
#pragma unroll
  for (int j = 0; j < (kChunks + kConsumerThreads - 1) / kConsumerThreads; ++j) {
    const int q = tid + j * kConsumerThreads;
    if (kChunks % kConsumerThreads != 0 && q >= kChunks) break;
    const int r = q >> 3, c = q & 7;
    const int swz = r * 128 + ((c ^ (r & 7)) << 4);
    uint32_t w[4];
    if constexpr (sizeof(XT) == 2) {
      const uint4 u = *reinterpret_cast<const uint4*>(raw + swz);
      w[0] = sign_bf16x2(u.x); w[1] = sign_bf16x2(u.y);
      w[2] = sign_bf16x2(u.z); w[3] = sign_bf16x2(u.w);
    } else {
      float v[8];
      load8(reinterpret_cast<const XT*>(raw) + r * kBK + c * 8, v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = (v[2 * i] >= 0.f ? 0x3F80u : 0xBF80u) |
               ((v[2 * i + 1] >= 0.f ? 0x3F80u : 0xBF80u) << 16);
    }
    if (edge) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (k0 + c * 8 + e >= m || r >= valid_rows) w[e >> 1] &= (e & 1) ? 0x0000FFFFu : 0xFFFF0000u;
    }
    *reinterpret_cast<uint4*>(dst + swz) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// grid (S, ceil(n / kBN), ceil(rows / N)), cluster (S, 1, 1), kThreads
// threads: warps 0-3 the consumer warpgroup, warp 4 the producer.
template <typename XT, bool kSign, int N>
__global__ void __launch_bounds__(kThreads, 2)
    sm90_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                const float* __restrict__ alpha, float* __restrict__ out, int rows, int m, int n,
                int kt_per, int stages) {
  namespace cg = cooperative_groups;
  constexpr int kXBytes = N * kBK * static_cast<int>(sizeof(XT));
  constexpr int kStage = kWBytes + kXBytes;
  constexpr int kR = N / 2;  // accumulators per thread per m64 half
  constexpr bool kBuffer = sign_buffer(kSign, sizeof(XT));

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const int ring = ring_bytes(N, sizeof(XT), stages);
  uint8_t* bconv = smem + ring;  // fp32 bitlinear's ±1 B tiles, 2 x N x 128 bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(bconv + (kBuffer ? 2 * N * kBK * 2 : 0));
  uint64_t* empty = full + stages;
  float* part = reinterpret_cast<float*>(smem);  // after the main loop

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int n0 = blockIdx.y * kBN, r0 = blockIdx.z * N;
  const int kt_total = (m + kBK - 1) / kBK;
  const int kt0 = rank * kt_per;
  const int kt_n = min(kt_per, kt_total - kt0);  // >= 1 by the plan
  // the second m64 half re-reads the first where it lies past n: its
  // products are never stored, and every CTA runs the same instructions
  const int n1 = n0 + kHalf < n ? n0 + kHalf : n0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      prefetch_tensormap(&tw);
      prefetch_tensormap(&tx);
      for (int i = 0; i < kt_n; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        uint8_t* st = smem + s * kStage;
        const int k0 = (kt0 + i) * kBK;
        mbar_expect_tx(&full[s], kStage);
        tma_load(st, &tw, &full[s], n0, k0);
        tma_load(st + kWHalfBytes, &tw, &full[s], n1, k0);
        tma_load(st + kWBytes, &tx, &full[s], k0, r0);
      }
    }
    __syncwarp();
  } else {
    // consumer warpgroup
    float acc0[kR], acc1[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) acc0[j] = acc1[j] = 0.f;
    // a stage is released as soon as its own products are done; bitlinear
    // then binarizes the next one (the ring keeps stages - 1 loading)
    auto b_tile = [&](int i) -> uint8_t* {
      uint8_t* x_stage = smem + (i % stages) * kStage + kWBytes;
      return kBuffer ? bconv + (i & 1) * (N * kBK * 2) : x_stage;
    };
    auto binarize = [&](int i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      binarize_stage<XT, N>(smem + s * kStage + kWBytes, b_tile(i), (kt0 + i) * kBK, m,
                            rows - r0, tid);
      fence_proxy_async();
    };
    if constexpr (kSign) {
      binarize(0);
      consumer_sync();
    }
    for (int i = 0; i < kt_n; ++i) {
      const int s = i % stages;
      if constexpr (!kSign) mbar_wait(&full[s], (i / stages) & 1);
      const uint32_t a_addr = saddr(smem + s * kStage);
      const uint32_t b_addr = saddr(b_tile(i));
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: 16 k rows of 128 bytes = 2 swizzle atoms (SBO 1024 along k);
        // B: 16 k = 32 bytes into each 128-byte row (SBO 1024 per 8 rows)
        const uint64_t db = smem_desc(b_addr + kk * 32, 16, 1024);
        Wgmma<N>::mma(acc0, smem_desc(a_addr + kk * 2048, kWHalfBytes, 1024), db);
        Wgmma<N>::mma(acc1, smem_desc(a_addr + kWHalfBytes + kk * 2048, kWHalfBytes, 1024), db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      if (lane == 0) mbar_arrive(&empty[s]);
      if constexpr (kSign) {
        if (i + 1 < kt_n) {
          binarize(i + 1);
          consumer_sync();
        }
      }
    }
    fence_proxy_async();
    consumer_sync();  // every wgmma and rewrite of the ring is done
    // accumulator j of thread (warp, lane): out column n0 + 64h + warp*16 +
    // lane/4 + 8*((j/2)%2) for half h, row r0 + (j/4)*8 + (lane%4)*2 + j%2
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int col = warp * 16 + (lane >> 2) + 8 * ((j >> 1) & 1);
      const int row = (j >> 2) * 8 + (lane & 3) * 2 + (j & 1);
      part[row * kPitch + col] = acc0[j];
      part[row * kPitch + kHalf + col] = acc1[j];
    }
  }

  cluster.sync();  // every partial tile of the cluster is written
  // each rank sums a share of the tile's float4s, over ranks 0..S-1 in
  // that order (the same order for every element and every launch); a
  // thread issues an item's S loads before it adds
  const int valid_rows = min(N, rows - r0);
  for (int q = rank * kThreads + tid; q < N * (kBN / 4); q += splits * kThreads) {
    const int r = q / (kBN / 4), c = (q % (kBN / 4)) * 4;
    if (r >= valid_rows || n0 + c >= n) continue;  // n % 8 == 0: whole float4s
    float* p = part + r * kPitch + c;
    float4 v[kMaxSplit];
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      if (s < splits) v[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(p, s));
    float4 sum = v[0];
#pragma unroll
    for (int s = 1; s < kMaxSplit; ++s) {
      if (s < splits) {
        sum.x += v[s].x; sum.y += v[s].y; sum.z += v[s].z; sum.w += v[s].w;
      }
    }
    if (alpha != nullptr) {
      const float4 a = *reinterpret_cast<const float4*>(alpha + n0 + c);
      sum.x *= a.x; sum.y *= a.y; sum.z *= a.z; sum.w *= a.w;
    }
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(r0 + r) * n + n0 + c) = sum;
  }
  cluster.sync();  // every rank stays resident until its peers have read it
}

// a row-major (outer, inner) matrix, boxes of (box_outer, box_inner);
// out-of-bounds elements read as 0
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, int elem_size, const void* base,
                     int outer, int inner, int box_inner, int box_outer, CUtensorMapSwizzle swz) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * elem_size};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  return encode(map, dtype, 2, base, dims, strides, box, swz);
}

// dynamic shared memory above 48 KB: opt in once per process and kernel
template <typename XT, bool kSign, int N>
cudaError_t opt_in() {
  static cudaError_t state = cudaErrorNotReady;
  if (state != cudaSuccess)
    state = cudaFuncSetAttribute(sm90_kernel<XT, kSign, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return state;
}

template <typename XT, bool kSign, int N>
int launch_sm90_n(const CUtensorMap* tw, const CUtensorMap* tx, const float* alpha, float* out,
                  int rows, int m, int n, int split, int stages, cudaStream_t stream,
                  int* max_clusters) {
  const cudaError_t opt = opt_in<XT, kSign, N>();
  if (opt != cudaSuccess) return static_cast<int>(opt);
  const int kt_total = (m + kBK - 1) / kBK;
  const int kt_per = (kt_total + split - 1) / split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (n + kBN - 1) / kBN, (rows + N - 1) / N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(N, sizeof(XT), kSign, stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)  // how many such clusters the card holds at once
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(max_clusters, sm90_kernel<XT, kSign, N>, &cfg));
  const cudaError_t e = cudaLaunchKernelEx(&cfg, sm90_kernel<XT, kSign, N>, *tw, *tx, alpha, out,
                                           rows, m, n, kt_per, stages);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, bool kSign>
int dispatch_rows(int row_tile, const CUtensorMap* tw, const CUtensorMap* tx, const float* alpha,
                  float* out, int rows, int m, int n, int split, int stages, cudaStream_t stream,
                  int* max_clusters) {
  switch (row_tile) {
#define SM90MMA_CASE(N)                                                                      \
  case N:                                                                                    \
    return launch_sm90_n<XT, kSign, N>(tw, tx, alpha, out, rows, m, n, split, stages, stream, \
                                       max_clusters);
    SM90MMA_CASE(8)
    SM90MMA_CASE(16)
    SM90MMA_CASE(32)
    SM90MMA_CASE(64)
    SM90MMA_CASE(128)
#undef SM90MMA_CASE
    default:
      return kErrPlan;
  }
}

template <typename XT, bool kSign>
bool plan_ok(int rows, int m, int n, int row_tile, int split, int stages) {
  const int kt_total = (m + kBK - 1) / kBK;
  const int kt_per = split > 0 ? (kt_total + split - 1) / split : 0;
  const int x_size = sizeof(XT);
  return rows >= 1 && m >= 1 && n >= 1 && n % 8 == 0 && (m * x_size) % 16 == 0 && split >= 1 &&
         split <= kMaxSplit && (split - 1) * kt_per < kt_total && stages >= 2 && stages <= 8 &&
         smem_bytes(row_tile, x_size, kSign, stages) <= kMaxSmem;
}

// the occupancy query behind a plan: clusters of `split` CTAs that fit on
// the card at once
template <typename XT, bool kSign>
int max_active_clusters(int row_tile, int split, int stages, int* clusters) {
  const int m = kBK * split;  // one k tile per split
  if (!plan_ok<XT, kSign>(1, m, 8, row_tile, split, stages)) return kErrPlan;
  return dispatch_rows<XT, kSign>(row_tile, nullptr, nullptr, nullptr, nullptr, 1, m, 8, split,
                                  stages, nullptr, clusters);
}

// x: (rows, m) XT; w: (m, n) bf16; alpha: (n,) fp32 or null; out: (rows, n)
// fp32. The plan (row tile, split, stages) comes from the Python wrapper
// (mma_plan.py) and is checked here against what the kernel takes.
template <typename XT, bool kSign>
int run_sm90(const void* x, const void* w, const float* alpha, float* out, int rows, int m, int n,
             int row_tile, int split, int stages, cudaStream_t stream) {
  if (!plan_ok<XT, kSign>(rows, m, n, row_tile, split, stages)) return kErrPlan;
  const int x_size = sizeof(XT);
  CUtensorMap tw, tx;
  int rc = encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, m, n, kHalf, kBK,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  // a bf16 x tile lands in wgmma's B layout (bitlinear binarizes it in
  // place); fp32 x lands unswizzled and is rewritten into the ±1 buffer
  rc = encode_2d(&tx,
                 x_size == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 x_size, x, rows, m, kBK, row_tile,
                 x_size == 4 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  return dispatch_rows<XT, kSign>(row_tile, &tw, &tx, alpha, out, rows, m, n, split, stages,
                                  stream, nullptr);
}

// ---------------------------------------------------------------------------
// variant "wmma": any shape
// ---------------------------------------------------------------------------

namespace wmma_v {

using namespace nvcuda;

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;
constexpr int kAPitch = kBK + 8;  // bf16; keeps 32-byte fragment alignment
constexpr int kBPitch = kBN + 8;
constexpr int kCPitch = kBN + 4;  // fp32

// one block of 4 warps per 64 x 64 output tile, each warp a 32 x 32
// quarter as 2 x 2 fragments; 32 features staged per step, 0 past every
// ragged edge (masked, not padded in device memory)
template <typename XT, bool kSign>
__global__ void __launch_bounds__(kThreads) kernel(const XT* __restrict__ x,
                                                   const __nv_bfloat16* __restrict__ w,
                                                   const float* __restrict__ alpha,
                                                   float* __restrict__ out, int rows, int m, int n) {
  __shared__ __align__(32) __nv_bfloat16 As[kBM * kAPitch];
  __shared__ __align__(32) __nv_bfloat16 Bs[kBK * kBPitch];
  __shared__ __align__(32) float Cs[kBM * kCPitch];
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < m; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int row = row0 + r, col = k0 + c;
      __nv_bfloat16 v = zero;  // masked features contribute 0
      if (row < rows && col < m) {
        const XT xv = x[static_cast<int64_t>(row) * m + col];
        if constexpr (kSign)
          v = __float2bfloat16(to_f32(xv) >= 0.f ? 1.f : -1.f);
        else
          v = xv;
      }
      As[r * kAPitch + c] = v;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int krow = k0 + r, col = col0 + c;
      Bs[r * kBPitch + c] = (krow < m && col < n) ? w[static_cast<int64_t>(krow) * n + col] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wr + 16 * i) * kAPitch + kk, kAPitch);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kBPitch + wc + 16 * j, kBPitch);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr + 16 * i) * kCPitch + wc + 16 * j, acc[i][j], kCPitch,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int row = row0 + r, col = col0 + c;
    if (row < rows && col < n) {
      const float v = Cs[r * kCPitch + c];
      out[static_cast<int64_t>(row) * n + col] = alpha != nullptr ? v * alpha[col] : v;
    }
  }
}

}  // namespace wmma_v

template <typename XT, bool kSign>
int run_wmma(const void* x, const void* w, const float* alpha, float* out, int rows, int m, int n,
             cudaStream_t stream) {
  const dim3 grid((n + wmma_v::kBN - 1) / wmma_v::kBN, (rows + wmma_v::kBM - 1) / wmma_v::kBM);
  wmma_v::kernel<XT, kSign><<<grid, wmma_v::kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const __nv_bfloat16*>(w), alpha, out, rows, m, n);
  return static_cast<int>(cudaGetLastError());
}

// variant numbers of the C entry points (mma_plan.VARIANTS)
constexpr int kVariantWmma = 0;
constexpr int kVariantSm90 = 1;

template <typename XT, bool kSign>
int run(int variant, const void* x, const void* w, const void* alpha, void* out, int rows, int m,
        int n, int row_tile, int split, int stages, void* stream) {
  const float* a = static_cast<const float*>(alpha);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kVariantSm90)
    return run_sm90<XT, kSign>(x, w, a, o, rows, m, n, row_tile, split, stages, st);
  if (variant == kVariantWmma) return run_wmma<XT, kSign>(x, w, a, o, rows, m, n, st);
  return kErrPlan;
}

}  // namespace sm90mma

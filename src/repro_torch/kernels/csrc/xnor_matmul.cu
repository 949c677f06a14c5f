// Packed Hamming matmul for Hopper (sm_90a): two variants behind the C
// entry points, chosen by the Python wrapper before the launch
// (kernels/mma_plan.py: choose_hamming).
//
// Replaces the Pallas TPU kernel src/repro/kernels/xnor_matmul.py
// (_hamming_kernel / hamming_matmul_packed).
//
//   ham[b, c] = sum_{j < kw} popc(a[b, j] ^ w[j, c])      (int32)
//
// The wrapper applies Eq. 1 (dot = m - 2 * ham). Activations arrive
// already packed (ops.pack_bits layout, zero pad bits); `ldw` lets
// block-padded weight artifacts pass without a copy.
//
// Variant "b1" (row strides of a and w multiples of 4 words, bases
// 16-byte aligned): the binary tensor cores.
//   - Instruction: mma.sync m16n8k256 .b1 with .and.popc. ptxas also takes
//     .xor.popc for sm_90a, but on an H100 it runs at 832 T bit-operations/s
//     against 5126 T for .and.popc (tools/tc_probe.py), so the kernel
//     uses ham = popc(a) + popc(w) - 2 * popc(a & w), summed per split over
//     the words that split reads. Exact in int32; pad bits are 0 on both
//     sides and add 0 to every term.
//   - Roles swapped as in sm90_mma.cuh: weight columns are the
//     instruction's M (16), activation rows its N (8), so 8 decode rows
//     cost N = 8. A CTA owns 128 columns and a row tile of 8..64 rows. One
//     producer warp keeps 8-word (256-bit) k stages in flight through a
//     ring of full/empty mbarriers: four 32-column x 8-word weight boxes
//     by TMA with a 128-byte swizzle, straight from the (KW', N') word
//     layout of the artifact, and the 8-word x rows activation box.
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
//     keeps its int32 partial tile in shared memory; after a cluster
//     barrier every rank sums a share of the tile over the ranks through
//     distributed shared memory (integer sums: any order is exact) and
//     stores it; a second barrier keeps every rank resident until read. No
//     atomics, no second launch, no memset.
//   - Edges. TMA zero-fills rows past `rows`, words past kw and columns
//     past n: a zero word adds 0 to every term. A 32-column box wholly past
//     n re-reads the tile's first box (its results are never stored).
//   What bounds it: the weight words at decode (1.4 MB at w1/w3) and,
//   at the lockstep prefill's 1024 rows, the int32 output (23 MB at w1/w3);
//   the bit-operations (5126 T/s) come after both.
//
// Variant "popc" (any strides): the first port of the kernel, unchanged.
// One block owns 8 activation rows and 128 output columns, one thread per
// column; per stage of 128 words the block copies its rows' words into
// shared memory, then every thread streams its column's weight words (a
// warp reads 32 neighbouring columns of one word row) and accumulates
// 32-bit popcounts in int32 registers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace {

constexpr int kRows = 8;        // activation rows per block
constexpr int kCols = 128;      // output columns per block (= threads)
constexpr int kWordTile = 128;  // packed words per shared-memory stage

__global__ void __launch_bounds__(kCols) hamming_kernel(
    const int32_t* __restrict__ a, int64_t lda, const int32_t* __restrict__ w,
    int64_t ldw, int32_t* __restrict__ out, int rows, int n, int kw) {
  __shared__ uint32_t as[kRows][kWordTile];
  const int row0 = blockIdx.x * kRows;
  const int col = blockIdx.y * kCols + threadIdx.x;

  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;

  for (int k0 = 0; k0 < kw; k0 += kWordTile) {
    const int nk = min(kWordTile, kw - k0);
    for (int p = threadIdx.x; p < kRows * nk; p += kCols) {
      const int r = p / nk;
      const int j = p - r * nk;
      const int row = row0 + r;
      as[r][j] = row < rows ? (uint32_t)a[(int64_t)row * lda + k0 + j] : 0u;
    }
    __syncthreads();
    if (col < n) {
      const int32_t* wcol = w + (int64_t)k0 * ldw + col;
#pragma unroll 4
      for (int j = 0; j < nk; ++j) {
        const uint32_t ww = (uint32_t)wcol[(int64_t)j * ldw];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += __popc(as[r][j] ^ ww);
      }
    }
    __syncthreads();
  }

  if (col < n) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row < rows) out[(int64_t)row * n + col] = acc[r];
    }
  }
}


// ---------------------------------------------------------------------------
// variant "b1" (launch-plan constants mirrored by kernels/mma_plan.py)
// ---------------------------------------------------------------------------

namespace b1 {

using namespace sm90ptx;

constexpr int kBN = 128;                        // weight columns per CTA
constexpr int kBoxCols = 32;                    // columns per weight box (128 bytes)
constexpr int kBKW = 8;                         // words per k stage (one instruction)
constexpr int kWBytes = kBN * kBKW * 4;         // the stage's weight tile: 4 boxes
constexpr int kBoxBytes = kBoxCols * kBKW * 4;  // 1 KB
constexpr int kPitch = kBN + 4;                 // int32 partial-tile row pitch
constexpr int kConsumerThreads = 128;
constexpr int kThreads = kConsumerThreads + 32;
constexpr int kMaxSplit = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;

// dynamic shared memory: 1 KB of alignment slack, the ring (weight tiles
// of every stage, then activation tiles; the partial tile reuses it after
// the main loop) and the barriers
__host__ __device__ constexpr int ring_bytes(int rows_tile, int stages) {
  return round_up(stages * (kWBytes + rows_tile * kBKW * 4) > rows_tile * kPitch * 4
                      ? stages * (kWBytes + rows_tile * kBKW * 4)
                      : rows_tile * kPitch * 4,
                  1024);
}
__host__ __device__ constexpr int smem_bytes(int rows_tile, int stages) {
  return 1024 + ring_bytes(rows_tile, stages) + 16 * stages;
}

__device__ __forceinline__ void mma_and(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid (S, ceil(n / kBN), ceil(rows / N)), cluster (S, 1, 1), kThreads
// threads: warps 0-3 consumers, warp 4 the producer. Consumer warps form a
// kWM x kWN grid over (columns, rows): each owns kBN / kWM columns (kXB
// boxes, 2 kXB instructions' M) and N / kWN rows (kNT instructions' N).
template <int N>
__global__ void __launch_bounds__(kThreads)
    b1_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap ta,
              int32_t* __restrict__ out, int rows, int n, int kw, int kt_per, int stages) {
  namespace cg = cooperative_groups;
  constexpr int kWM = N >= 64 ? 2 : 4;
  constexpr int kWN = 4 / kWM;
  constexpr int kXB = kBN / kWM / kBoxCols;  // weight boxes per warp
  constexpr int kNT = N / kWN / 8;           // 8-row groups per warp
  constexpr int kABytes = N * kBKW * 4;      // the stage's activation tile

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* wring = smem;                     // stage s at s * kWBytes
  uint8_t* aring = smem + stages * kWBytes;  // stage s at s * kABytes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring_bytes(N, stages));
  uint64_t* empty = full + stages;
  int32_t* part = reinterpret_cast<int32_t*>(smem);  // after the main loop

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int n0 = blockIdx.y * kBN, r0 = blockIdx.z * N;
  const int kt_total = (kw + kBKW - 1) / kBKW;
  const int kt0 = rank * kt_per;
  const int kt_n = min(kt_per, kt_total - kt0);  // >= 1 by the plan
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {
    if (lane == 0) {
      prefetch_tensormap(&tw);
      prefetch_tensormap(&ta);
      for (int i = 0; i < kt_n; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        const int k0 = (kt0 + i) * kBKW;
        mbar_expect_tx(&full[s], kWBytes + kABytes);
#pragma unroll
        for (int x = 0; x < kBN / kBoxCols; ++x) {
          const int c = n0 + x * kBoxCols < n ? n0 + x * kBoxCols : n0;
          tma_load(wring + s * kWBytes + x * kBoxBytes, &tw, &full[s], c, k0);
        }
        tma_load(aring + s * kABytes, &ta, &full[s], k0, r0);
      }
    }
    __syncwarp();
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp % kWM, wn = warp / kWM;
    // acc: popc(a & w) summed by the instructions; colp / rowp: this
    // thread's share of popc(w) per column and popc(a) per row
    int acc[kXB][2][kNT][4] = {};
    int colp[kXB][4] = {};
    int rowp[kNT] = {};

    for (int i = 0; i < kt_n; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const uint8_t* wt = wring + s * kWBytes;
      const uint8_t* at = aring + s * kABytes;
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
    named_sync<kConsumerThreads>();  // every consumer is done with the ring
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
            const int col = (wm * kXB + x) * kBoxCols + 4 * g + 2 * j + (e >> 1);
            const int row = rbase + 2 * t + (e & 1);
            part[row * kPitch + col] =
                colp[x][2 * j + (e >> 1)] + ((e & 1) ? pop1 : pop0) - 2 * acc[x][j][nt][e];
          }
    }
  }

  cluster.sync();  // every partial tile of the cluster is written
  const int valid_rows = min(N, rows - r0);
  for (int q = rank * kThreads + tid; q < N * (kBN / 4); q += splits * kThreads) {
    const int r = q / (kBN / 4), c = (q % (kBN / 4)) * 4;
    if (r >= valid_rows || n0 + c >= n) continue;
    const int32_t* p = part + r * kPitch + c;
    int4 sum = *reinterpret_cast<const int4*>(cluster.map_shared_rank(p, 0));
    for (int s = 1; s < splits; ++s) {
      const int4 v = *reinterpret_cast<const int4*>(cluster.map_shared_rank(p, s));
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    int32_t* o = out + static_cast<int64_t>(r0 + r) * n + n0 + c;
    if (n % 4 == 0) {
      *reinterpret_cast<int4*>(o) = sum;
    } else {
      const int vals[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int e = 0; e < 4 && n0 + c + e < n; ++e) o[e] = vals[e];
    }
  }
  cluster.sync();  // every rank stays resident until its peers have read it
}

template <int N>
cudaError_t opt_in() {
  static cudaError_t state = cudaErrorNotReady;
  if (state != cudaSuccess)
    state = cudaFuncSetAttribute(b1_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
  return state;
}

template <int N>
int launch_n(const CUtensorMap* tw, const CUtensorMap* ta, int32_t* out, int rows, int n, int kw,
             int split, int stages, cudaStream_t stream) {
  const cudaError_t opt = opt_in<N>();
  if (opt != cudaSuccess) return static_cast<int>(opt);
  const int kt_total = (kw + kBKW - 1) / kBKW;
  const int kt_per = (kt_total + split - 1) / split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (n + kBN - 1) / kBN, (rows + N - 1) / N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(N, stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, b1_kernel<N>, *tw, *ta, out, rows, n, kw, kt_per, stages);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

inline bool plan_ok(long long lda, long long ldw, int rows, int n, int kw, int row_tile, int split,
                    int stages) {
  const int kt_total = (kw + kBKW - 1) / kBKW;
  const int kt_per = split > 0 ? (kt_total + split - 1) / split : 0;
  return rows >= 1 && n >= 1 && kw >= 1 && lda >= kw && ldw >= n && lda % 4 == 0 &&
         ldw % 4 == 0 && split >= 1 && split <= kMaxSplit && (split - 1) * kt_per < kt_total &&
         stages >= 2 && stages <= kMaxStages && smem_bytes(row_tile, stages) <= kMaxSmem;
}

// a: (rows, lda) words, w: (KW', ldw) words, out: (rows, n) int32. The
// plan (row tile, split, stages) comes from mma_plan.hamming_plan and is
// checked here against what the kernel takes.
inline int run(const void* a, long long lda, const void* w, long long ldw, void* out, int rows,
               int n, int kw, int row_tile, int split, int stages, cudaStream_t stream) {
  if (!plan_ok(lda, ldw, rows, n, kw, row_tile, split, stages)) return kErrPlan;
  CUtensorMap tw, ta;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(kw)};
  const cuuint64_t wstr[1] = {static_cast<cuuint64_t>(ldw) * 4};
  const cuuint32_t wbox[2] = {kBoxCols, kBKW};
  int rc = encode(&tw, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, w, wdims, wstr, wbox,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const cuuint64_t adims[2] = {static_cast<cuuint64_t>(kw), static_cast<cuuint64_t>(rows)};
  const cuuint64_t astr[1] = {static_cast<cuuint64_t>(lda) * 4};
  const cuuint32_t abox[2] = {kBKW, static_cast<cuuint32_t>(row_tile)};
  rc = encode(&ta, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, a, adims, astr, abox,
              CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  int32_t* o = static_cast<int32_t*>(out);
  switch (row_tile) {
    case 8: return launch_n<8>(&tw, &ta, o, rows, n, kw, split, stages, stream);
    case 16: return launch_n<16>(&tw, &ta, o, rows, n, kw, split, stages, stream);
    case 32: return launch_n<32>(&tw, &ta, o, rows, n, kw, split, stages, stream);
    case 64: return launch_n<64>(&tw, &ta, o, rows, n, kw, split, stages, stream);
    default: return kErrPlan;
  }
}

}  // namespace b1
}  // namespace

extern "C" int hamming_matmul(const void* a, long long lda, const void* w,
                              long long ldw, void* out, int rows, int n,
                              int kw, void* stream) {
  const dim3 grid((rows + kRows - 1) / kRows, (n + kCols - 1) / kCols);
  hamming_kernel<<<grid, kCols, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, lda, (const int32_t*)w, ldw, (int32_t*)out, rows, n,
      kw);
  return (int)cudaGetLastError();
}

// variant "b1": row strides of a and w multiples of 4 words, bases 16-byte
// aligned (checked by the wrapper), plan from mma_plan.hamming_plan
extern "C" int hamming_matmul_b1(const void* a, long long lda, const void* w, long long ldw,
                                 void* out, int rows, int n, int kw, int row_tile, int split,
                                 int stages, void* stream) {
  return b1::run(a, lda, w, ldw, out, rows, n, kw, row_tile, split, stages,
                 (cudaStream_t)stream);
}

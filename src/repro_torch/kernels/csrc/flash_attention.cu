// Flash attention forward for Hopper (sm_90a): two variants behind the C
// entry points, chosen by the Python wrapper before the launch
// (kernels/flash_attention.py: choose_variant).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel / flash_attention): softmax attention with the online
// softmax state (m, l, acc) in fp32 registers, never in device memory.
//
//   q (B, H, Sq, D), k/v (B, KV, Skv, D), KV | H  ->  o (B, H, Sq, D)
//
// Both variants keep the reference's per-tile update with the same
// constants: s = (q . k) * (float)(1 / sqrt((double)D)), NEG_INF = -1e30
// where masked, p = exp(s - m') and 0 where s <= NEG_INF / 2, and
// o = acc / max(l, 1e-30).
//
// Bit-exact grafts. A row's arithmetic must not depend on Sq or on the
// query tile that holds it, or a prefix-grafted continuation would not
// equal the full prefill. So key tiles start at key 0 with a fixed
// size, every row runs the same instruction sequence, a tile is skipped
// only when it lies wholly above the diagonal of every row of the query
// tile, and a tile wholly above one row's diagonal adds exactly 0 (p ==
// 0) with a correction of exactly 1 (m unchanged). Ragged keys and
// padded query rows are masked by absolute position: out-of-range keys
// read as 0 and score NEG_INF, rows past Sq are never stored. There is
// no split over keys: it would change a row's summation.
//
// Variant "sm90" (bf16 q/k/v, D = 64 or 128; any strides TMA can
// describe). What bounds it on an H100: the q/k/v/o bytes at the serving
// shapes (tinyllama-1.1b's prefill: 9.4 MB, 2.8 us at 3.35 TB/s), with
// QK^T and P.V close behind once P.V runs as three products (below). What
// holds it back (PERF.md, tools/tc_probe.py): each key tile is a chain of
// dependent steps inside one warpgroup (QK^T, softmax, P.V), and only two
// CTAs fit on an SM.
//   - Work item: (64 query rows, head, batch), one consumer warpgroup
//     (wgmma M = 64) and one producer warp. The grid is persistent (as
//     many CTAs as fit on the card); a CTA walks its items heaviest first,
//     and the producer's rings of Q, K and V tiles (full/empty mbarriers)
//     run on across items. TMA reads the (B, H, S, D) views through their
//     strides (the transpose(1, 2) views of the model's (B, S, H, D)
//     activations, no copy), 64 x 64 boxes with a 128-byte swizzle; it
//     zero-fills rows past Sq and keys past Skv.
//   - At D = 64 the previous tile's P.V runs on the tensor cores while the
//     CUDA cores do this tile's softmax (overlap()). No wgmma sits on a
//     path that only some tiles take: ptxas would serialize every wgmma
//     of the kernel.
//   - S = Q.K^T: wgmma m64n64k16 from shared memory, both operands
//     K-major (d contiguous), fp32 accumulators. A product of two bf16 is
//     exact in fp32, so against the plain version (q, k cast to fp32)
//     only the summation order differs.
//   - Online softmax on the accumulator fragments: a thread holds 16
//     scores of each of two rows; the row max and sum run over the
//     thread's values in a fixed order, then over the row's quad of
//     threads by the same two xor shuffles for every row.
//   - P.V on the tensor cores without rounding p: p = hi + mid + lo
//     exactly, hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid)
//     (each difference is exact in fp32, and bf16 has fp32's exponent
//     range). Three wgmma m64nDk16 per 16 keys, A (hi, mid, lo) from
//     registers -- the score accumulator's layout is wgmma's A fragment
//     layout -- and B the V tile read MN-major (transposed), into one
//     fp32 accumulator. Every product stays exact, so kernel and plain
//     version (p kept in fp32) still differ by summation order only.
//     Cost: four products instead of two.
//   - A wgmma output row depends only on its own A row, so a row's bits
//     do not depend on the rows that share its tile.
//
// Variant "fma" (fp32, or strides / bases TMA cannot describe): the first
// port of the kernel, unchanged. One block per (32 query rows, head, batch), 4 warps of 8 rows;
// 32-key tiles staged in shared memory in fp32 by scalar loads; the q.k
// dot, row max / sum (warp shuffles) and P.V (p from lane j by shuffle)
// on the fp32 FMA pipes, two __syncthreads per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile (= lanes)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRowsPerWarp == 8, "the score loop reads two float4 of rows");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// xor butterfly: every lane ends with the same bits (IEEE addition is
// commutative), and the tree is the same for every row
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  return (D * (kBQ + 4) + D * (kBK + 1) + kBK * D) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) flash_kernel(
    const T* __restrict__ q, int64_t qsb, int64_t qsh, int64_t qss,
    const T* __restrict__ k, int64_t ksb, int64_t ksh, int64_t kss,
    const T* __restrict__ v, int64_t vsb, int64_t vsh, int64_t vss,
    T* __restrict__ o, int H, int group, int Sq, int Skv, int causal, int diag,
    float scale) {
  constexpr int kQPitch = kBQ + 4;  // Qs[d][row]: 16-byte aligned rows
  constexpr int kKPitch = kBK + 1;  // Kt[d][key]: conflict-free stores
  constexpr int kCols = D / 32;     // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Kt = Qs + D * kQPitch;
  float* Vs = Kt + D * kKPitch;

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBQ;
  const int r0 = warp * kRowsPerWarp;  // this warp's rows in the block
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;

  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qs[d * kQPitch + r] = row < Sq ? to_f32(qb[(int64_t)row * qss + d]) : 0.f;
  }

  // keys any row of this tile can see (all of them when non-causal)
  int n_keys = Skv;
  if (causal) n_keys = min(Skv, min(q0 + kBQ, Sq) - 1 + diag + 1);
  const int n_tiles = n_keys > 0 ? (n_keys + kBK - 1) / kBK : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is consumed (and Qs staged)
    for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const bool ok = k0 + j < Skv;
      Kt[d * kKPitch + j] = ok ? to_f32(kb[(int64_t)(k0 + j) * kss + d]) : 0.f;
      Vs[j * D + d] = ok ? to_f32(vb[(int64_t)(k0 + j) * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = Kt[d * kKPitch + lane];
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[d * kQPitch + r0]);
      const float4 qc = *reinterpret_cast<const float4*>(&Qs[d * kQPitch + r0 + 4]);
      s[0] = fmaf(qa.x, kd, s[0]);
      s[1] = fmaf(qa.y, kd, s[1]);
      s[2] = fmaf(qa.z, kd, s[2]);
      s[3] = fmaf(qa.w, kd, s[3]);
      s[4] = fmaf(qc.x, kd, s[4]);
      s[5] = fmaf(qc.y, kd, s[5]);
      s[6] = fmaf(qc.z, kd, s[6]);
      s[7] = fmaf(qc.w, kd, s[7]);
    }

    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool visible = key < Skv && (!causal || key <= q0 + r0 + r + diag);
      const float sr = visible ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = sr <= kNegInf * 0.5f ? 0.f : expf(sr - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
      m[r] = m_new;
      s[r] = p;  // kept for the P.V product
    }

    for (int j = 0; j < kBK; ++j) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vj[c] = Vs[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + r0 + r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + (((int64_t)b * H + h) * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(&orow[lane + 32 * c], acc[r][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, long long qsb, long long qsh, long long qss, const void* k,
           long long ksb, long long ksh, long long kss, const void* v, long long vsb,
           long long vsh, long long vss, void* o, int B, int H, int KV, int Sq, int Skv,
           int causal, int diag, void* stream) {
  const int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  // the reference's scale: 1 / sqrt(D) in double, rounded to fp32
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, D><<<grid, kWarps * 32, bytes, (cudaStream_t)stream>>>(
      (const T*)q, qsb, qsh, qss, (const T*)k, ksb, ksh, kss, (const T*)v, vsb, vsh,
      vss, (T*)o, H, H / KV, Sq, Skv, causal, diag, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, long long qsb, long long qsh, long long qss, const void* k,
             long long ksb, long long ksh, long long kss, const void* v, long long vsb,
             long long vsh, long long vss, void* o, int B, int H, int KV, int Sq,
             int Skv, int D, int causal, int diag, void* stream) {
  if (D == 64)
    return launch<T, 64>(q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, B, H,
                         KV, Sq, Skv, causal, diag, stream);
  if (D == 128)
    return launch<T, 128>(q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, B, H,
                          KV, Sq, Skv, causal, diag, stream);
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// variant "sm90"
// ---------------------------------------------------------------------------

namespace fa90 {

using namespace sm90ptx;

constexpr int kBM = 64;                          // query rows per CTA (wgmma M)
constexpr int kBKeys = 64;                       // keys per tile (KEY_TILE)
constexpr int kBox = 64;                         // d per TMA box (128 bytes of bf16)
constexpr int kBoxBytes = kBM * kBox * 2;        // one 64 x 64 bf16 box
constexpr int kConsumerThreads = 128;            // one warpgroup
constexpr int kThreads = kConsumerThreads + 32;  // + one producer warp
constexpr float kNegInf = -1e30f;
static_assert(kBM == kBKeys, "Q, K and V boxes share one shape");

// Whether P_{t-1}.V_{t-1} runs on the tensor cores during the softmax of
// tile t. At D = 128 the accumulators of both products in flight exceed
// what ptxas keeps in 204 registers (it then serializes every wgmma; with
// 255 it does not, but runs slower: tools/tc_probe.py), so that head dim
// runs them one after the other.
template <int D>
__host__ __device__ constexpr bool overlap() { return D == 64; }

// Rings: two Q tiles (the next work item's loads while this one runs), K
// tiles released as soon as their QK^T is done, V tiles after their P.V,
// which runs one tile behind where overlap(): 2 Q, 2 K and 3 (else 2) V
// stages, 57 KB (D = 64) or 97 KB (D = 128) per CTA, two CTAs per SM.
constexpr int kQStages = 2;
constexpr int kKStages = 2;
template <int D>
__host__ __device__ constexpr int vstages() { return overlap<D>() ? 3 : 2; }
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + (D / kBox) * kBoxBytes * (kQStages + kKStages + vstages<D>()) +
         16 * (kQStages + kKStages + vstages<D>());
}

template <int N>
struct WgmmaSS;
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<64> {
  // D += A.B, A (Q) and B (K) K-major in shared memory
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  // D += A.B, A (P) from registers, B (V) MN-major in shared memory
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  // D += A.B, A (P) from registers, B (V) MN-major in shared memory
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Work item i: query tile, batch, head, heaviest first (the last query
// tiles see the most keys under a causal mask), the heads of one KV group
// next to each other.
__device__ __forceinline__ void item_of(int i, int H, int B, int QT, int& qt, int& b, int& h) {
  h = i % H;
  b = (i / H) % B;
  qt = QT - 1 - i / (H * B);
}

// Scale and mask one tile of scores by absolute position, then the online
// softmax update of the thread's two rows: p in sc, corr returned, m and l
// updated. The row max and sum run over the thread's 16 values in order,
// then over the quad by the same two xor shuffles for every row. kMask is
// false for a tile whose keys every row of the query tile sees: there the
// mask would select every score, so the result is the same bits.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m_r)[2], float (&l_r)[2],
                                             float (&corr)[2], const int (&pos)[2], int k0,
                                             int lane, int Skv, int causal, float scale) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = (j >> 1) & 1;
    if constexpr (kMask) {
      const int key = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      const bool visible = key < Skv && (!causal || key <= pos[i]);
      sc[j] = visible ? sc[j] * scale : kNegInf;
    } else {
      sc[j] *= scale;
    }
    mx[i] = fmaxf(mx[i], sc[j]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    const float m_new = fmaxf(m_r[i], mx[i]);
    corr[i] = expf(m_r[i] - m_new);
    m_r[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = (j >> 1) & 1;
    sc[j] = sc[j] <= kNegInf * 0.5f ? 0.f : expf(sc[j] - m_r[i]);
    sum[i] += sc[j];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
    sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
    l_r[i] = l_r[i] * corr[i] + sum[i];
  }
}

// p as three bf16 terms in wgmma's A fragment layout: register r of k-step
// kk packs accumulators 8 kk + 2 r and 8 kk + 2 r + 1 (the lower one in the
// low half). hi and mid round pairs to bf16; lo = p - hi - mid is a bf16
// value already, so its top 16 bits are taken as they are.
__device__ __forceinline__ void split_p(const float (&sc)[32], uint32_t (&ph)[16],
                                        uint32_t (&pm)[16], uint32_t (&pl)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float p0 = sc[2 * r], p1 = sc[2 * r + 1];
    ph[r] = pack_bf16(p0, p1);
    const float r0 = p0 - __uint_as_float(ph[r] << 16);
    const float r1 = p1 - __uint_as_float(ph[r] & 0xFFFF0000u);
    pm[r] = pack_bf16(r0, r1);
    const float l0 = r0 - __uint_as_float(pm[r] << 16);
    const float l1 = r1 - __uint_as_float(pm[r] & 0xFFFF0000u);
    pl[r] = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
  }
}

// S = Q.K^T: 16 d = 32 bytes into each 128-byte row of d box kk / 4, 8 rows
// per 1024-byte swizzle atom
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    WgmmaSS<kBKeys>::mma(sc, smem_desc(q_addr + off, 16, 1024), smem_desc(k_addr + off, 16, 1024));
  }
}

// O += (hi + mid + lo).V: 16 keys = 16 rows of 128 bytes per k-step, the
// second d box kBoxBytes further (the descriptor's leading byte offset)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&ph)[16],
                                         const uint32_t (&pm)[16], const uint32_t (&pl)[16],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBKeys / 16; ++kk) {
    const uint64_t dv = smem_desc(v_addr + kk * 2048, kBoxBytes, 1024);
    WgmmaRS<D>::mma(acc, ph + 4 * kk, dv);
    WgmmaRS<D>::mma(acc, pm + 4 * kk, dv);
    WgmmaRS<D>::mma(acc, pl + 4 * kk, dv);
  }
}

// Persistent: gridDim.x CTAs (two per SM) walk the work items i =
// blockIdx.x, blockIdx.x + gridDim.x, ...; kThreads threads: warps 0-3 the
// consumer warpgroup, warp 4 the producer. The K/V rings run on across
// items, so the next item's first tiles load while this one computes.
//
// Per key tile j the consumer issues S_j = Q.K_j^T and, where overlap(),
// behind it the previous tile's P_{j-1}.V_{j-1}: the softmax of S_j runs on
// the CUDA cores while P.V runs on the tensor cores; then O *= corr_j and
// p_j is split for the next product. Each element of O sees the same
// operations in the same order as the reference's acc = acc * corr + p.v.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int B,
                      int H, int group, int Sq, int Skv, int causal, int diag, float scale) {
  constexpr int kHalves = D / kBox;
  constexpr int kTileBytes = kHalves * kBoxBytes;  // one Q, K or V tile
  constexpr int kO = D / 2;                        // output accumulators per thread
  constexpr bool kOverlap = overlap<D>();
  constexpr int kVStages = vstages<D>();

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                           // Q stage s at qs + s * kTileBytes
  uint8_t* ks = qs + kQStages * kTileBytes;     // K stage s at ks + s * kTileBytes
  uint8_t* vs = ks + kKStages * kTileBytes;     // V stage s at vs + s * kTileBytes
  uint64_t* kfull = reinterpret_cast<uint64_t*>(vs + kVStages * kTileBytes);
  uint64_t* kempty = kfull + kKStages;
  uint64_t* vfull = kempty + kKStages;
  uint64_t* vempty = vfull + kVStages;
  uint64_t* qfull = vempty + kVStages;
  uint64_t* qempty = qfull + kQStages;

  const int QT = (Sq + kBM - 1) / kBM;
  const int items = QT * B * H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // keys any row of query tile qt can see (all of them when non-causal)
  auto tiles_of = [&](int qt) {
    int n_keys = Skv;
    if (causal) n_keys = min(Skv, min(qt * kBM + kBM, Sq) - 1 + diag + 1);
    return n_keys > 0 ? (n_keys + kBKeys - 1) / kBKeys : 0;
  };

  if (tid == 0) {
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], kConsumerThreads / 32);  // one arrival per consumer warp
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], kConsumerThreads / 32);
    }
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {
    // producer: one thread loads each item's Q tile and keeps both rings full
    if (lane == 0) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      int kc = 0, vc = 0, qc = 0;  // K, V and Q tiles loaded so far
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int qt, b, h;
        item_of(it, H, B, QT, qt, b, h);
        const int n_tiles = tiles_of(qt);
        if (n_tiles == 0) continue;
        const int kvh = h / group;
        const int sq = qc % kQStages;
        if (qc >= kQStages) mbar_wait(&qempty[sq], ((qc / kQStages) & 1) ^ 1);
        mbar_expect_tx(&qfull[sq], kTileBytes);
#pragma unroll
        for (int x = 0; x < kHalves; ++x)
          tma_load_4d(qs + sq * kTileBytes + x * kBoxBytes, &tq, &qfull[sq], x * kBox, qt * kBM,
                      h, b);
        ++qc;
        for (int t = 0; t < n_tiles; ++t, ++kc, ++vc) {
          const int sk = kc % kKStages, sv = vc % kVStages;
          if (kc >= kKStages) mbar_wait(&kempty[sk], ((kc / kKStages) & 1) ^ 1);
          mbar_expect_tx(&kfull[sk], kTileBytes);
#pragma unroll
          for (int x = 0; x < kHalves; ++x)
            tma_load_4d(ks + sk * kTileBytes + x * kBoxBytes, &tk, &kfull[sk], x * kBox,
                        t * kBKeys, kvh, b);
          if (vc >= kVStages) mbar_wait(&vempty[sv], ((vc / kVStages) & 1) ^ 1);
          mbar_expect_tx(&vfull[sv], kTileBytes);
#pragma unroll
          for (int x = 0; x < kHalves; ++x)
            tma_load_4d(vs + sv * kTileBytes + x * kBoxBytes, &tv, &vfull[sv], x * kBox,
                        t * kBKeys, kvh, b);
        }
      }
    }
    __syncwarp();
    return;
  }

  // consumer warpgroup. Accumulator j of a thread of m64nN: row
  // warp * 16 + lane / 4 + 8 * ((j / 2) % 2), column 8 * (j / 4) +
  // 2 * (lane % 4) + j % 2.
  int kc = 0, vc = 0, qc = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int qt, b, h;
    item_of(it, H, B, QT, qt, b, h);
    const int n_tiles = tiles_of(qt);
    const int q0 = qt * kBM;
    float acc[kO];
#pragma unroll
    for (int j = 0; j < kO; ++j) acc[j] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f}, corr[2];
    int pos[2];  // absolute positions of the thread's two rows
#pragma unroll
    for (int i = 0; i < 2; ++i) pos[i] = q0 + warp * 16 + lane / 4 + 8 * i + diag;
    if (n_tiles > 0) {
      const int sq = qc % kQStages;
      mbar_wait(&qfull[sq], (qc / kQStages) & 1);
      ++qc;
      const uint32_t q_addr = saddr(qs + sq * kTileBytes);
      float sc[32];
      uint32_t ph[16], pm[16], pl[16];
      // the first key tile that some row of this query tile does not see
      // whole (a causal diagonal or the end of the keys): from there on
      // the scores are masked
      const int unmasked = causal ? max(0, min(Skv, q0 + diag + 1)) / kBKeys : Skv / kBKeys;
      // the steps of one key tile; no wgmma sits on a path that only some
      // tiles take (ptxas would serialize every wgmma of the kernel)
      auto wait_k = [&]() {
        const int sk = kc % kKStages;
        mbar_wait(&kfull[sk], (kc / kKStages) & 1);
        return sk;
      };
      auto wait_v = [&]() {
        const int sv = vc % kVStages;
        mbar_wait(&vfull[sv], (vc / kVStages) & 1);
        return sv;
      };
      auto start_qk = [&](int sk) {  // zero S and issue S = Q.K^T
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        fence_regs(sc);
        fence_regs(acc);
        wgmma_fence();
        issue_qk<D>(sc, q_addr, saddr(ks + sk * kTileBytes));
        wgmma_commit();
      };
      auto qk_done = [&](int sk, int t) {  // after the wait for S: free K (and Q)
        fence_regs(sc);
        if (lane == 0) mbar_arrive(&kempty[sk]);
        ++kc;
        if (t == n_tiles - 1 && lane == 0) mbar_arrive(&qempty[sq]);
      };
      auto softmax = [&](int t) {
        if (t < unmasked)
          softmax_tile<false>(sc, m_r, l_r, corr, pos, t * kBKeys, lane, Skv, causal, scale);
        else
          softmax_tile<true>(sc, m_r, l_r, corr, pos, t * kBKeys, lane, Skv, causal, scale);
      };
      auto pv_done = [&](int sv) {  // after the wait for P.V: free V
        fence_regs(acc);
        fence_regs(ph);
        fence_regs(pm);
        fence_regs(pl);
        if (lane == 0) mbar_arrive(&vempty[sv]);
        ++vc;
      };
      auto rescale_split = [&]() {
#pragma unroll
        for (int j = 0; j < kO; ++j) acc[j] *= corr[(j >> 1) & 1];
        split_p(sc, ph, pm, pl);
      };
      auto pv_now = [&]() {  // this tile's P.V, waited for
        const int sv = wait_v();
        fence_regs(acc);
        wgmma_fence();
        issue_pv<D>(acc, ph, pm, pl, saddr(vs + sv * kTileBytes));
        wgmma_commit();
        wgmma_wait<0>();
        pv_done(sv);
      };
      if constexpr (kOverlap) {
        {
          const int sk = wait_k();
          start_qk(sk);
          wgmma_wait<0>();
          qk_done(sk, 0);
          softmax(0);
          rescale_split();
        }
        for (int t = 1; t < n_tiles; ++t) {
          const int sk = wait_k();
          const int sv = wait_v();  // the previous tile's V
          start_qk(sk);
          issue_pv<D>(acc, ph, pm, pl, saddr(vs + sv * kTileBytes));
          wgmma_commit();
          wgmma_wait<1>();  // S_t (committed first) is done; P_{t-1}.V_{t-1} runs on
          qk_done(sk, t);
          softmax(t);
          wgmma_wait<0>();
          pv_done(sv);
          rescale_split();
        }
        pv_now();
      } else {
        for (int t = 0; t < n_tiles; ++t) {
          const int sk = wait_k();
          start_qk(sk);
          wgmma_wait<0>();
          qk_done(sk, t);
          softmax(t);
          rescale_split();
          pv_now();
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + warp * 16 + lane / 4 + 8 * i;
      if (row >= Sq) continue;
      const float denom = fmaxf(l_r[i], 1e-30f);
      __nv_bfloat16* orow = o + (((int64_t)b * H + h) * Sq + row) * D + 2 * (lane & 3);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float x0 = acc[4 * c + 2 * i] / denom, x1 = acc[4 * c + 2 * i + 1] / denom;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// dynamic shared memory above 48 KB: opt in once per process and kernel
template <int D>
cudaError_t opt_in() {
  static cudaError_t state = cudaErrorNotReady;
  if (state != cudaSuccess)
    state = cudaFuncSetAttribute(flash_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_bytes<D>());
  return state;
}

// CTAs the card holds at once (occupancy x SMs), once per process and
// head dim; a CUDA error is returned negated
template <int D>
int resident_ctas() {
  static int slots = 0;
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_sm90_kernel<D>, kThreads,
                                                        smem_bytes<D>());
    if (e != cudaSuccess) return -(int)e;
    slots = per_sm * sms;
  }
  return slots;
}

// a (B, N, S, D) bf16 view with element strides sb, sn, ss (d contiguous)
inline int encode_bnsd(CUtensorMap* map, const void* base, int B, int N, int S, int D,
                       long long sb, long long sn, long long ss) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sn * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kBox, kBM, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
int launch(const void* q, long long qsb, long long qsh, long long qss, const void* k,
           long long ksb, long long ksh, long long kss, const void* v, long long vsb,
           long long vsh, long long vss, void* o, int B, int H, int KV, int Sq, int Skv,
           int causal, int diag, void* stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode_bnsd(&tq, q, B, H, Sq, D, qsb, qsh, qss);
  if (rc == 0) rc = encode_bnsd(&tk, k, B, KV, Skv, D, ksb, ksh, kss);
  if (rc == 0) rc = encode_bnsd(&tv, v, B, KV, Skv, D, vsb, vsh, vss);
  if (rc != 0) return rc;
  const cudaError_t opt = opt_in<D>();
  if (opt != cudaSuccess) return (int)opt;
  const int slots = resident_ctas<D>();
  if (slots <= 0) return slots == 0 ? kErrPlan : -slots;
  const float scale = (float)(1.0 / sqrt((double)D));
  const long long items = (long long)((Sq + kBM - 1) / kBM) * B * H;
  const int grid = (int)(items < slots ? items : slots);
  flash_sm90_kernel<D><<<grid, kThreads, smem_bytes<D>(), (cudaStream_t)stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, B, H, H / KV, Sq, Skv, causal, diag, scale);
  return (int)cudaGetLastError();
}

}  // namespace fa90
}  // namespace

extern "C" int flash_attention_f32(const void* q, long long qsb, long long qsh,
                                   long long qss, const void* k, long long ksb,
                                   long long ksh, long long kss, const void* v,
                                   long long vsb, long long vsh, long long vss, void* o,
                                   int B, int H, int KV, int Sq, int Skv, int D,
                                   int causal, int diag, void* stream) {
  return dispatch<float>(q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, B, H,
                         KV, Sq, Skv, D, causal, diag, stream);
}

extern "C" int flash_attention_bf16(const void* q, long long qsb, long long qsh,
                                    long long qss, const void* k, long long ksb,
                                    long long ksh, long long kss, const void* v,
                                    long long vsb, long long vsh, long long vss, void* o,
                                    int B, int H, int KV, int Sq, int Skv, int D,
                                    int causal, int diag, void* stream) {
  return dispatch<__nv_bfloat16>(q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o,
                                 B, H, KV, Sq, Skv, D, causal, diag, stream);
}

// variant "sm90": bf16, D = 64 or 128, strides and bases TMA can describe
// (checked by the wrapper; a map TMA refuses returns kErrTensorMap)
extern "C" int flash_attention_sm90(const void* q, long long qsb, long long qsh,
                                    long long qss, const void* k, long long ksb,
                                    long long ksh, long long kss, const void* v,
                                    long long vsb, long long vsh, long long vss, void* o,
                                    int B, int H, int KV, int Sq, int Skv, int D,
                                    int causal, int diag, void* stream) {
  if (D == 64)
    return fa90::launch<64>(q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, B, H, KV,
                            Sq, Skv, causal, diag, stream);
  if (D == 128)
    return fa90::launch<128>(q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, B, H, KV,
                             Sq, Skv, causal, diag, stream);
  return sm90ptx::kErrPlan;
}

// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel / flash_attention): softmax attention with the online
// softmax state (m, l, acc) in fp32 registers, never in device memory.
//
//   q (B, H, Sq, D), k/v (B, KV, Skv, D), KV | H  ->  o (B, H, Sq, D)
//
// Layout. One block per (query tile of kBQ rows, head, batch); 4 warps,
// each owning kRowsPerWarp query rows. The TPU kernel's sequential key
// grid axis becomes the loop over key tiles inside the block: each tile
// of kBK keys (one per lane) and its values are staged in shared memory
// in fp32, K transposed so that lane j reads key j without bank
// conflicts. GQA reads key/value head h / (H / KV) directly (no repeat).
// Per tile a lane computes the scores of its key against the warp's
// rows (the rows' q values are broadcast reads), the warp reduces the
// row max and sum with xor shuffles, and each lane accumulates D / 32
// output columns of P.V, taking p_j from lane j by shuffle.
//
// Bit-exact grafts. A row's arithmetic must not depend on Sq or on the
// query tile that holds it, or a prefix-grafted continuation would not
// equal the full prefill. So key tiles start at key 0 with a fixed
// size, every row runs the same instruction sequence (the q.k dot in d
// order, the shuffle trees by lane, the P.V sum in key order), and a
// tile wholly above a row's diagonal adds exactly 0 (p == 0) with a
// correction of exactly 1 (m unchanged). Ragged keys and padded query
// rows are masked here: out-of-range keys read as 0 and score NEG_INF,
// rows past Sq compute on zeros and are never stored.
//
// What bounds it. At the serving shapes q/k/v/o are a few MB, while
// QK^T and P.V are 4 * Sq * Skv * D operations per head (halved by
// causality): the operation rate bounds it. This first version runs
// them on the fp32 FMA pipes (two shared-memory reads per 8 FMAs in the
// score loop) instead of the tensor cores, and skips only key tiles
// wholly above the whole query tile's diagonal; wgmma comes later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

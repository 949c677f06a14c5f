// Fused BitLinear for Hopper (sm_90a): binarize + pack + XNOR + popcount
// + Eq. 1 affine correction + alpha*beta rescale, one launch. Two variants
// behind the C entry points, chosen by the Python wrapper before the
// launch (kernels/mma_plan.py: choose_fused).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_decode.py
// (_fused_kernel / fused_bnn_matmul_kernel).
//
//   out[b, c] = (m - 2 * sum_j popc(pack(x[b] >= 0)_j ^ w[j, c])) * (alpha[c] * beta[b])
//
// Variant "b1" (x's row stride a multiple of 16 bytes, the weight row
// stride a multiple of 4 words, bases 16-byte aligned): the binary
// tensor-core tile loop of sm90_b1.cuh with its RawRows activation stage
// -- each k stage's rows x 256 features of x arrive by TMA in x's own
// dtype beside the weight boxes, and the consumer threads binarize them by
// comparison (v >= 0: -0.0 -> 1, NaN -> 0), mask features >= m by index
// and pack them into the word tile the b1 fragments read -- and its
// BitLinearOut epilogue: float(m - 2 ham) * (alpha[c] * beta[b]), alpha *
// beta first as the reference does, after the rank-ordered cluster
// split-K. The plan (mma_plan.fused_plan) picks one consumer warpgroup
// (a 128-column n tile) for a decode tick's 8 rows and two (256 columns)
// past it: x is 16x the bytes of its packed words and every n tile
// re-reads and re-packs it, so the wide tile halves the packing per
// output; at the lockstep prefill's 1024 rows 32-row tiles and a 2-stage
// ring keep several CTAs per SM.
//   What bounds it: the bytes (weight words and bf16 x at decode, the
//   fp32 output at 1024 rows); the bit-operations (5126 T/s on the binary
//   tensor cores) come after them at every shape of the main path. What
//   holds it back (tools/tc_probe.py --sections fused, PERF.md): at decode
//   the ~5 us of launch, pipeline fill and cluster barriers; at 1024 rows
//   the packing, the tensor-core work and the epilogue in turn in each
//   CTA, none of them alone.
//
// Variant "popc" (any strides): the first port of the kernel, unchanged.
// One block owns kRows activation rows and kCols output columns; each of
// its kCols threads owns one column. Per stage of kWordTile packed words
// the block first binarizes and packs its rows into shared memory: a warp
// step reads 32 consecutive features of one row, lane i holding feature
// 32j+i, and __ballot_sync turns the 32 sign tests into word j -- exactly
// the ops.pack_bits layout (bit i of word j is feature 32j+i). Lanes at or
// beyond m vote 0, which is what the reference's -1.0 feature pad does.
// Then every thread streams its column's weight words (a warp reads 32
// neighbouring columns of one word row: coalesced) and accumulates
// __popc(xw ^ ww) for each of its rows in int32 registers on the 32-bit
// popcount pipe. The epilogue applies Eq. 1 and the BitLinear rescale with
// alpha*beta multiplied first, as the reference does. Ragged rows and
// columns are masked in the kernel, and `ldw` lets block-padded
// ("prepad") weight artifacts pass without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_b1.cuh"

namespace {

constexpr int kRows = 8;        // activation rows per block
constexpr int kCols = 128;      // output columns per block (= threads)
constexpr int kWarps = kCols / 32;
constexpr int kWordTile = 128;  // packed words per shared-memory stage
constexpr int kUnroll = 8;      // (row, word) pairs a warp loads before voting

__device__ __forceinline__ bool nonneg(float v) { return v >= 0.0f; }
__device__ __forceinline__ bool nonneg(__nv_bfloat16 v) {
  return __bfloat162float(v) >= 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kCols) fused_bnn_kernel(
    const T* __restrict__ x, int64_t ldx, const int32_t* __restrict__ w,
    int64_t ldw, const float* __restrict__ alpha,
    const float* __restrict__ beta, float* __restrict__ out, int rows, int n,
    int m) {
  __shared__ uint32_t xs[kRows][kWordTile];
  const int row0 = blockIdx.x * kRows;
  const int col = blockIdx.y * kCols + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kw = (m + 31) / 32;

  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;

  for (int k0 = 0; k0 < kw; k0 += kWordTile) {
    const int nk = min(kWordTile, kw - k0);
    const int pairs = kRows * nk;
    // binarize + pack this stage's words; p is warp-uniform, so every
    // lane of the warp reaches each ballot
    for (int p0 = warp * kUnroll; p0 < pairs; p0 += kWarps * kUnroll) {
      bool bit[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u;
        const int r = p / nk;
        const int j = p - r * nk;
        const int row = row0 + r;
        const int feat = (k0 + j) * 32 + lane;
        bit[u] = p < pairs && row < rows && feat < m &&
                 nonneg(x[(int64_t)row * ldx + feat]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t word = __ballot_sync(0xffffffffu, bit[u]);
        const int p = p0 + u;
        if (lane == 0 && p < pairs) xs[p / nk][p % nk] = word;
      }
    }
    __syncthreads();
    if (col < n) {
      const int32_t* wcol = w + (int64_t)k0 * ldw + col;
#pragma unroll 4
      for (int j = 0; j < nk; ++j) {
        const uint32_t ww = (uint32_t)wcol[(int64_t)j * ldw];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += __popc(xs[r][j] ^ ww);
      }
    }
    __syncthreads();
  }

  if (col < n) {
    const float a = alpha[col];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row < rows) {
        // m - 2*ham is an exact integer in fp32 (m < 2^24); alpha*beta first
        out[(int64_t)row * n + col] = (float)(m - 2 * acc[r]) * (a * beta[row]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, long long ldx, const void* w, long long ldw,
           const void* alpha, const void* beta, void* out, int rows, int n,
           int m, void* stream) {
  const dim3 grid((rows + kRows - 1) / kRows, (n + kCols - 1) / kCols);
  fused_bnn_kernel<T><<<grid, kCols, 0, (cudaStream_t)stream>>>(
      (const T*)x, ldx, (const int32_t*)w, ldw, (const float*)alpha,
      (const float*)beta, (float*)out, rows, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_bnn_matmul_bf16(const void* x, long long ldx,
                                     const void* w, long long ldw,
                                     const void* alpha, const void* beta,
                                     void* out, int rows, int n, int m,
                                     void* stream) {
  return launch<__nv_bfloat16>(x, ldx, w, ldw, alpha, beta, out, rows, n, m,
                               stream);
}

extern "C" int fused_bnn_matmul_f32(const void* x, long long ldx,
                                    const void* w, long long ldw,
                                    const void* alpha, const void* beta,
                                    void* out, int rows, int n, int m,
                                    void* stream) {
  return launch<float>(x, ldx, w, ldw, alpha, beta, out, rows, n, m, stream);
}

// variant "b1": x's row stride a multiple of 16 bytes, the weight row
// stride a multiple of 4 words, bases 16-byte aligned (checked by the
// wrapper), plan from mma_plan.fused_plan
extern "C" int fused_bnn_matmul_b1_bf16(const void* x, long long ldx, const void* w,
                                        long long ldw, const void* alpha, const void* beta,
                                        void* out, int rows, int n, int m, int row_tile, int wg,
                                        int split, int stages, void* stream) {
  return b1::run_fused<__nv_bfloat16>(x, ldx, w, ldw, alpha, beta, out, rows, n, m, row_tile, wg,
                                      split, stages, (cudaStream_t)stream);
}

extern "C" int fused_bnn_matmul_b1_f32(const void* x, long long ldx, const void* w,
                                       long long ldw, const void* alpha, const void* beta,
                                       void* out, int rows, int n, int m, int row_tile, int wg,
                                       int split, int stages, void* stream) {
  return b1::run_fused<float>(x, ldx, w, ldw, alpha, beta, out, rows, n, m, row_tile, wg, split,
                              stages, (cudaStream_t)stream);
}

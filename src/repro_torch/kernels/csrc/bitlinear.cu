// Fused BitLinear (binarize -> ±1 matmul -> per-column rescale) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitlinear.py
// (_bitlinear_kernel / bitlinear):
//
//   out[r, c] = (sum_k sign(x[r, k]) * w[k, c]) * alpha[c]      (fp32)
//
// with sign(x) = +1 where x >= 0 as read (so -0.0 -> +1, NaN -> -1) and
// w in bf16 (±1 on the serving path). There is no activation scale.
//
// Layout. One block of 4 warps owns a 64 x 64 output tile; each warp a
// 32 x 32 quarter as 2 x 2 WMMA fragments (bf16 m16n16k16, fp32
// accumulators). Per step of 32 contraction features the block stages
// the binarized activations and the weights in shared memory as bf16,
// writing 0 past the ragged edge of m, rows or n (masked, not padded in
// device memory), then issues two MMA steps per fragment. After the last
// step the accumulators go through shared memory and each output is
// multiplied by its column's alpha once, as the TPU kernel does.
//
// Exactness. ±1 x ±1 products summed in fp32 are integers below 2^24,
// so any summation order gives the same sum: with ±1 weights the kernel
// equals its plain version and the JAX kernel bit for bit.
//
// What bounds it. 2 * rows * m * n operations against the weight bytes:
// at 8 rows the weights (memory) bound it, at 128 rows the tensor cores
// nearly do. This first version uses WMMA with synchronous staging
// (no TMA, no wgmma, no pipelining), so it runs well below either bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;
constexpr int kAPitch = kBK + 8;  // bf16; keeps 32-byte fragment alignment
constexpr int kBPitch = kBN + 8;
constexpr int kCPitch = kBN + 4;  // fp32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) bitlinear_kernel(
    const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ alpha, float* __restrict__ out, int rows, int m, int n) {
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
      float s = 0.f;  // masked features contribute 0
      if (row < rows && col < m) s = to_f32(x[(int64_t)row * m + col]) >= 0.f ? 1.f : -1.f;
      As[r * kAPitch + c] = __float2bfloat16(s);
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int krow = k0 + r, col = col0 + c;
      Bs[r * kBPitch + c] = (krow < m && col < n) ? w[(int64_t)krow * n + col] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr + 16 * i) * kAPitch + kk, kAPitch);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kBPitch + wc + 16 * j, kBPitch);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr + 16 * i) * kCPitch + wc + 16 * j, acc[i][j],
                              kCPitch, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int row = row0 + r, col = col0 + c;
    if (row < rows && col < n) out[(int64_t)row * n + col] = Cs[r * kCPitch + c] * alpha[col];
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* alpha, void* out, int rows, int m,
           int n, void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  bitlinear_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const __nv_bfloat16*)w, (const float*)alpha, (float*)out, rows, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bitlinear_f32(const void* x, const void* w, const void* alpha, void* out,
                             int rows, int m, int n, void* stream) {
  return launch<float>(x, w, alpha, out, rows, m, n, stream);
}

extern "C" int bitlinear_bf16(const void* x, const void* w, const void* alpha, void* out,
                              int rows, int m, int n, void* stream) {
  return launch<__nv_bfloat16>(x, w, alpha, out, rows, m, n, stream);
}

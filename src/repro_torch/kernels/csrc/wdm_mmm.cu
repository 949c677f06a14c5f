// WDM MMM (EinsteinBarrier's K-wavelength step) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wdm_mmm.py
// (_mmm_kernel / mmm):
//
//   out[r, c] = sum_k a[r, k] * w[k, c]      (bf16 in, fp32 out)
//
// over the (G * K, m) rows of the wavelength groups: the K wavelengths
// of a group are rows that share one pass over the weights.
//
// Layout. One block of 4 warps owns a 64 x 64 output tile; each warp a
// 32 x 32 quarter as 2 x 2 WMMA fragments (bf16 m16n16k16, fp32
// accumulators), over contraction steps of 32 staged in shared memory.
// Past the ragged edge of rows, m or n the staged values are 0 (masked,
// not padded in device memory). The accumulators leave through shared
// memory so the ragged output edge is stored element by element.
//
// Exactness. For ±1 operands the fp32 sums are integers below 2^24 and
// exact in any order, so the kernel equals its plain version bit for
// bit; for real-valued bf16 weights the sums differ from the plain
// version's by summation order only.
//
// What bounds it. 2 * rows * m * n operations against the weight bytes:
// memory at 8 rows, nearly the tensor cores at 128. This first version
// stages synchronously (no TMA, no wgmma, no pipelining) and runs well
// below either bound.

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

__global__ void __launch_bounds__(kThreads) mmm_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
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
      As[r * kAPitch + c] = (row < rows && col < m) ? a[(int64_t)row * m + col] : zero;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int krow = k0 + r, col = col0 + c;
      Bs[r * kBPitch + c] = (krow < m && col < n) ? w[(int64_t)krow * n + col] : zero;
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
      wmma::store_matrix_sync(Cs + (wr + 16 * i) * kCPitch + wc + 16 * j, acc[i][j],
                              kCPitch, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int row = row0 + r, col = col0 + c;
    if (row < rows && col < n) out[(int64_t)row * n + col] = Cs[r * kCPitch + c];
  }
}

}  // namespace

extern "C" int wdm_mmm(const void* a, const void* w, void* out, int rows, int m, int n,
                       void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  mmm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)w, (float*)out, rows, m, n);
  return (int)cudaGetLastError();
}

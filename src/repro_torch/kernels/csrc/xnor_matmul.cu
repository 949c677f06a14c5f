// Packed XNOR+popcount Hamming matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/xnor_matmul.py
// (_hamming_kernel / hamming_matmul_packed).
//
//   ham[b, c] = sum_{j < kw} popc(a[b, j] ^ w[j, c])      (int32)
//
// The wrapper applies Eq. 1 (dot = m - 2 * ham). Activations arrive
// already packed (ops.pack_bits layout, zero pad bits).
//
// Layout. One block owns kRows activation rows and kCols output columns;
// each of its kCols threads owns one column. Per stage of kWordTile words
// the block copies its rows' activation words into shared memory (a
// broadcast read in the inner loop), then every thread streams its
// column's weight words -- a warp reads 32 neighbouring columns of one
// word row, so the reads coalesce -- and accumulates popcounts for each
// of its rows in int32 registers.
//
// What bounds it. With few rows (decode) the weight words dominate the
// bytes and each is read once per row tile: memory bound. With many rows
// every word feeds kRows popcounts per block and the popcount rate
// bounds it. Ragged rows and columns are masked here; `ldw` lets
// block-padded weight artifacts pass without a copy.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Fused BitLinear (binarize -> ±1 matmul -> per-column rescale) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitlinear.py
// (_bitlinear_kernel / bitlinear):
//
//   out[r, c] = (sum_k sign(x[r, k]) * w[k, c]) * alpha[c]      (fp32)
//
// with sign(x) = +1 where x >= 0 as read (so -0.0 -> +1, NaN -> -1), x in
// fp32 or bf16, w in bf16 (±1 on the serving path), alpha applied once
// after the whole sum. There is no activation scale.
//
// What bounds it on an H100: the weight bytes (m * n * 2) at 8 and at 128
// rows for the tinyllama-1.1b shapes. The design is the shared Hopper tile
// loop of sm90_mma.cuh (TMA weight ring, wgmma with the rows as N, binarize
// in shared memory, deterministic cluster split-K); shapes TMA cannot
// describe take its WMMA variant. The launch plan is computed by the
// Python wrapper (mma_plan.py) and passed in.

#include "sm90_mma.cuh"

extern "C" int bitlinear_f32(const void* x, const void* w, const void* alpha, void* out, int rows,
                             int m, int n, int variant, int row_tile, int split, int stages,
                             void* stream) {
  return sm90mma::run<float, true>(variant, x, w, alpha, out, rows, m, n, row_tile, split, stages,
                                   stream);
}

extern "C" int bitlinear_bf16(const void* x, const void* w, const void* alpha, void* out, int rows,
                              int m, int n, int variant, int row_tile, int split, int stages,
                              void* stream) {
  return sm90mma::run<__nv_bfloat16, true>(variant, x, w, alpha, out, rows, m, n, row_tile, split,
                                           stages, stream);
}

// clusters of a plan's `split` CTAs that the card holds at once (x bf16
// when x_bf16 != 0, else fp32)
extern "C" int bitlinear_max_active_clusters(int x_bf16, int row_tile, int split, int stages,
                                             int* clusters) {
  return x_bf16 ? sm90mma::max_active_clusters<__nv_bfloat16, true>(row_tile, split, stages,
                                                                     clusters)
                : sm90mma::max_active_clusters<float, true>(row_tile, split, stages, clusters);
}

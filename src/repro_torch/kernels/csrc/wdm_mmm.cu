// WDM MMM (EinsteinBarrier's K-wavelength step) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wdm_mmm.py
// (_mmm_kernel / mmm):
//
//   out[r, c] = sum_k a[r, k] * w[k, c]      (bf16 in, fp32 out)
//
// over the (G * K, m) rows of the wavelength groups: the K wavelengths of
// a group are rows that share one pass over the weights.
//
// What bounds it on an H100: the weight bytes (m * n * 2) at 8 and at 128
// rows for the tinyllama-1.1b shapes. The design is the shared Hopper tile
// loop of sm90_mma.cuh (TMA ring for weights and activations, wgmma with
// the rows as N, deterministic cluster split-K: the sum of a real-valued
// product is the same bits on every launch); shapes TMA cannot describe
// take its WMMA variant. The launch plan is computed by the Python wrapper
// (mma_plan.py) and passed in.

#include "sm90_mma.cuh"

extern "C" int wdm_mmm(const void* a, const void* w, void* out, int rows, int m, int n,
                       int variant, int row_tile, int split, int stages, void* stream) {
  return sm90mma::run<__nv_bfloat16, false>(variant, a, w, nullptr, out, rows, m, n, row_tile,
                                            split, stages, stream);
}

// clusters of a plan's `split` CTAs that the card holds at once
extern "C" int wdm_mmm_max_active_clusters(int row_tile, int split, int stages, int* clusters) {
  return sm90mma::max_active_clusters<__nv_bfloat16, false>(row_tile, split, stages, clusters);
}

// Exact per-row weighted median and k-th smallest kernels for Hopper (sm_90a).
//
// Replace two TPU kernels of infercnvpy_tpu/ops/pallas_select.py:
//   * _wmedian_kernel (API row_median_weighted): the median of each row's
//     values repeated by one int32 weight per column, np.median(np.repeat(row,
//     w)); a zero weight masks its column;
//   * row_kth_smallest's inner kernel: the exact k-th smallest (0-based).
// Both run the select routine of select.cuh (a 4-pass radix select over
// order-preserving keys), the weighted form adding weights to the histogram
// bins where the median adds ones.
//
// What bounds them on an H100: as for row_median.cu, bytes: each row is read
// from device memory once (width * 4 bytes, 8 KB at 1,991 columns; the
// weights come from the cache) and one float is written.  Keys and weights
// stay in registers across the passes, so a block waits only for the 10
// block-wide synchronisations of the select.  One block per row.

#include "select.cuh"

namespace infercnv {

__global__ void __launch_bounds__(1024) row_median_weighted_kernel(const float* __restrict__ x,
                                                                   const int* __restrict__ wts,
                                                                   float* __restrict__ out, int width, int total) {
  __shared__ __align__(16) int hist[kSelectScratch];
  const float* row = x + static_cast<long long>(blockIdx.x) * width;
  const float med = block_weighted_median<true>(row, wts, width, total, hist);
  if (threadIdx.x == 0) out[blockIdx.x] = med;
}

__global__ void __launch_bounds__(1024) row_kth_smallest_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                                int width, int k) {
  __shared__ __align__(16) int hist[kSelectScratch];
  const float* row = x + static_cast<long long>(blockIdx.x) * width;
  const float v = block_kth_smallest(row, width, k, hist);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

}  // namespace infercnv

extern "C" {

// total = sum of wts (>= 1), every weight >= 0; threads a multiple of 32 in
// [32, 1024]; the wrapper checks all three.
int row_median_weighted_launch(const void* x, const void* wts, void* out, int rows, int width, int total,
                               int threads, void* stream) {
  infercnv::row_median_weighted_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(wts), static_cast<float*>(out), width, total);
  return static_cast<int>(cudaGetLastError());
}

// 0 <= k < width; the wrapper checks it.
int row_kth_smallest_launch(const void* x, void* out, int rows, int width, int k, int threads, void* stream) {
  infercnv::row_kth_smallest_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), width, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

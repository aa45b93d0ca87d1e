// Exact per-row weighted median and k-th smallest kernels for Hopper (sm_90a).
//
// Replace two TPU kernels of infercnvpy_tpu/ops/pallas_select.py:
//   * _wmedian_kernel (API row_median_weighted): the median of each row's
//     values repeated by one int32 weight per column, np.median(np.repeat(row,
//     w)); a zero weight masks its column;
//   * row_kth_smallest's inner kernel: the exact k-th smallest (0-based).
// Both run the select routine of select.cuh (bisection over order-preserving
// integer keys), the weighted form with weight sums where the median counts
// ones.
//
// What bounds them on an H100: as for row_median.cu, each row is read from
// device memory once (width * 4 bytes) and then re-read from the L1 cache by
// every bisection pass (about 20-30, seeded with the row's smallest and
// largest key), so the block-wide count per pass sets the time.  One block per
// row keeps the row (8 KB at 1991 columns) and the weights in L1 across passes.

#include "select.cuh"

namespace infercnv {

__global__ void __launch_bounds__(kThreads) row_median_weighted_kernel(const float* __restrict__ x,
                                                                       const int* __restrict__ wts,
                                                                       float* __restrict__ out, int width,
                                                                       int total) {
  __shared__ int ired[kWarps];
  const float* row = x + static_cast<long long>(blockIdx.x) * width;
  const float med = block_weighted_median<true>(row, wts, width, total, ired);
  if (threadIdx.x == 0) out[blockIdx.x] = med;
}

__global__ void __launch_bounds__(kThreads) row_kth_smallest_kernel(const float* __restrict__ x,
                                                                    float* __restrict__ out, int width, int k) {
  __shared__ int ired[kWarps];
  const float* row = x + static_cast<long long>(blockIdx.x) * width;
  const int key = block_select_key<false>(row, nullptr, width, k, ired);
  if (threadIdx.x == 0) out[blockIdx.x] = key_to_float(key);
}

}  // namespace infercnv

extern "C" {

// total = sum of wts (>= 1), every weight >= 0; the wrapper checks both.
int row_median_weighted_launch(const void* x, const void* wts, void* out, int rows, int width, int total,
                               void* stream) {
  infercnv::row_median_weighted_kernel<<<rows, infercnv::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(wts), static_cast<float*>(out), width, total);
  return static_cast<int>(cudaGetLastError());
}

// 0 <= k < width; the wrapper checks it.
int row_kth_smallest_launch(const void* x, void* out, int rows, int width, int k, void* stream) {
  infercnv::row_kth_smallest_kernel<<<rows, infercnv::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), width, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Exact per-row weighted median and k-th smallest kernels for Hopper (sm_90a).
//
// Replace two TPU kernels of infercnvpy_tpu/ops/pallas_select.py:
//   * _wmedian_kernel (API row_median_weighted): the median of each row's
//     values repeated by one int32 weight per column, np.median(np.repeat(row,
//     w)); a zero weight masks its column;
//   * row_kth_smallest's inner kernel: the exact k-th smallest (0-based).
// Both run a 4-pass radix select over order-preserving keys, the weighted
// form adding weights to the histogram bins where the others add ones.  Each
// has two variants, chosen by the row's width in ops/select.py (as the median
// of row_median.cu has): one warp a row (warp_select.cuh) up to kWarpMaxWidth
// values, row_median_weighted_warp_kernel with its weights in a table in
// shared memory, 16-bit or 32-bit (one instantiation each, and one per
// parity of the weight total); one block a row (select.cuh) above.
//
// What bounds them on an H100: as for row_median.cu, bytes: each row is read
// from device memory once (width * 4 bytes, 8 KB at 1,991 columns; the
// weights once a block) and one float is written.  warp_select.cuh says what
// the warp variants do about it; in the block kernels keys and weights stay
// in registers across the passes, and a block waits on the 10 block-wide
// synchronisations of the select.

#include "warp_select.cuh"

namespace infercnv {

__global__ void __launch_bounds__(1024) row_median_weighted_kernel(const float* __restrict__ x,
                                                                   const int* __restrict__ wts,
                                                                   float* __restrict__ out, int width, int total) {
  __shared__ __align__(16) int hist[kSelectScratch];
  const float* row = x + static_cast<long long>(blockIdx.x) * width;
  const float med = block_weighted_median<true>(row, wts, width, total, hist);
  if (threadIdx.x == 0) out[blockIdx.x] = med;
}

// kTwo: an even weight total (the mean of the two middle ranks); W: the
// weight table's entries, uint16_t where the total fits 16 bits, else int
template <bool kTwo, typename W>
__global__ void __launch_bounds__(kWarpThreads, kWBlocksPerSm)
    row_median_weighted_warp_kernel(const float* __restrict__ x, const int* __restrict__ wts, float* __restrict__ out,
                                    int rows, int width, int total) {
  warp_weighted_median_rows<kWarpMaxKeys, kTwo, W>(x, wts, out, rows, width, total);
}

__global__ void __launch_bounds__(kWarpThreads, kWarpBlocksPerSm)
    row_kth_smallest_warp_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int width, int k) {
  warp_select_rows<kWarpMaxKeys, false>(x, out, rows, width, k);
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

// 1 <= width <= 2,048; total = sum of wts (>= 1), every weight >= 0 (the
// wrapper checks them).  A total up to 65,535 bounds every weight by it.
int row_median_weighted_warp_launch(const void* x, const void* wts, void* out, int rows, int width, int total,
                                    void* stream) {
  using namespace infercnv;
  if (width < 1 || width > kWarpMaxWidth || total < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool two = (total & 1) == 0, wide = total > 0xFFFF;
  auto kernel = two ? (wide ? &row_median_weighted_warp_kernel<true, int>
                            : &row_median_weighted_warp_kernel<true, uint16_t>)
                    : (wide ? &row_median_weighted_warp_kernel<false, int>
                            : &row_median_weighted_warp_kernel<false, uint16_t>);
  const int smem = kWarpsPerBlock * kWWarpSmem + kWarpMaxWidth * (wide ? 4 : 2);  // the warps', the weight table
  return launch_warp_grid(kernel, rows, smem, static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                          static_cast<const int*>(wts), static_cast<float*>(out), rows, width, total);
}

// 0 <= k < width <= 2,048 (the wrapper checks them).
int row_kth_smallest_warp_launch(const void* x, void* out, int rows, int width, int k, void* stream) {
  using namespace infercnv;
  if (width < 1 || width > kWarpMaxWidth || k < 0 || k >= width) return static_cast<int>(cudaErrorInvalidValue);
  return launch_warp_rows(&row_kth_smallest_warp_kernel, rows, static_cast<cudaStream_t>(stream),
                          static_cast<const float*>(x), static_cast<float*>(out), rows, width, k);
}

// 0 <= k < width; the wrapper checks it.
int row_kth_smallest_launch(const void* x, void* out, int rows, int width, int k, int threads, void* stream) {
  infercnv::row_kth_smallest_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), width, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

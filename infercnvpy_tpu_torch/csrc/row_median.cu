// Exact per-row median kernels for Hopper (sm_90a).
//
// Replace the TPU kernel infercnvpy_tpu/ops/pallas_select.py::_median_kernel
// (launched by _row_median_impl, API row_median): the exact per-row median
// with np.median semantics, a 4-pass radix select over order-preserving keys
// of the float bit patterns.  Two variants, chosen by the row's width in
// ops/select.py::row_median_cuda:
//   * row_median_warp_kernel, rows of up to kWarpMaxWidth (2,048) values: one
//     warp a row, the row staged by a bulk copy and its keys in registers,
//     persistent blocks (warp_select.cuh), one instantiation per width parity;
//   * row_median_kernel, wider rows: one block a row on the block select that
//     the fused window kernel also runs (select.cuh).
//
// What bounds them on an H100: bytes.  Each row is read from device memory
// once (width * 4 bytes, 7 KB at 1,793 windows) and one float is written.
// warp_select.cuh says what the warp variant does so that the select's
// synchronisation does not set the pace; the block variant keeps the keys of
// its first 8 * 256 values in registers and reads the rest again each pass.

#include "warp_select.cuh"

namespace infercnv {

// kEven: the mean of the two middle ranks, else the middle rank
template <bool kEven>
__global__ void __launch_bounds__(kWarpThreads, kWarpBlocksPerSm)
    row_median_warp_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int width) {
  warp_select_rows<kWarpMaxKeys, kEven>(x, out, rows, width, (width - 1) / 2);
}

__global__ void __launch_bounds__(1024) row_median_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                          int width) {
  __shared__ __align__(16) int hist[kSelectScratch];
  const float* row = x + static_cast<long long>(blockIdx.x) * width;
  const float med = block_median(row, width, hist);
  if (threadIdx.x == 0) out[blockIdx.x] = med;
}

}  // namespace infercnv

extern "C" {

// 1 <= width <= 2,048 (the wrapper checks it).
int row_median_warp_launch(const void* x, void* out, int rows, int width, void* stream) {
  using namespace infercnv;
  if (width < 1 || width > kWarpMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = (width & 1) == 0 ? &row_median_warp_kernel<true> : &row_median_warp_kernel<false>;
  return launch_warp_rows(kernel, rows, static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                          static_cast<float*>(out), rows, width);
}

// threads: a multiple of 32 in [32, 1024]; the wrapper checks it.
int row_median_launch(const void* x, void* out, int rows, int width, int threads, void* stream) {
  infercnv::row_median_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), width);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

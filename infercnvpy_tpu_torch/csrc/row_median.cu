// Exact per-row median kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel infercnvpy_tpu/ops/pallas_select.py::_median_kernel
// (launched by _row_median_impl, API row_median): the exact per-row median
// with np.median semantics.  It runs the same select routine as the fused
// window kernel (select.cuh: a 4-pass radix select over order-preserving keys
// of the float bit patterns), with a launch of its own.
//
// What bounds it on an H100: bytes.  Each row is read from device memory
// once (width * 4 bytes, 7 KB at 1,793 windows) and one float is written;
// the keys then stay in registers, so the 10 block-wide synchronisations of
// the select, not memory, are what a block waits for, and several blocks on
// an SM hide them behind each other's loads.  One block per row.

#include "select.cuh"

namespace infercnv {

__global__ void __launch_bounds__(1024) row_median_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                          int width) {
  __shared__ __align__(16) int hist[kSelectScratch];
  const float* row = x + static_cast<long long>(blockIdx.x) * width;
  const float med = block_median(row, width, hist);
  if (threadIdx.x == 0) out[blockIdx.x] = med;
}

}  // namespace infercnv

// threads: a multiple of 32 in [32, 1024]; the wrapper checks it.
extern "C" int row_median_launch(const void* x, void* out, int rows, int width, int threads, void* stream) {
  infercnv::row_median_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), width);
  return static_cast<int>(cudaGetLastError());
}

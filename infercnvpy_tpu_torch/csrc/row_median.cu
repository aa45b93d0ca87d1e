// Exact per-row median kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel infercnvpy_tpu/ops/pallas_select.py::_median_kernel
// (launched by _row_median_impl, API row_median): the exact per-row median
// with np.median semantics, by bisection over order-preserving integer keys
// of the float bit patterns.  It runs the same select routine as the fused
// window kernel (select.cuh), with a launch of its own.
//
// What bounds it on an H100: each row is read from device memory once
// (width * 4 bytes) and then re-read from the L1 cache by every bisection
// pass (about 20-30 passes, seeded with the row's min and max key), so the
// block-wide count per pass, not device memory, sets the time.  One block per
// row keeps the row (7 KB at 1793 windows) in L1 across passes.

#include "select.cuh"

namespace infercnv {

__global__ void __launch_bounds__(kThreads) row_median_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                              int width) {
  __shared__ int ired[kWarps];
  const float* row = x + static_cast<long long>(blockIdx.x) * width;
  const float med = block_median(row, width, ired);
  if (threadIdx.x == 0) out[blockIdx.x] = med;
}

}  // namespace infercnv

extern "C" int row_median_launch(const void* x, void* out, int rows, int width, void* stream) {
  infercnv::row_median_kernel<<<rows, infercnv::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), width);
  return static_cast<int>(cudaGetLastError());
}

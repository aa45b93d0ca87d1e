// Fused centre / clip / pyramid window / exact median kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel infercnvpy_tpu/ops/pallas_fused.py::_make_kernel
// (launched by _fused_impl, API fused_center_smooth_median).  It computes
// what that kernel computes, per cell row:
//   1. bounded-logFC centring  x - clip(x, rmin, rmax)  (or x - ref for a
//      single reference), then clip to +-lfc_clip;
//   2. for every output window, in final chromosome order: a regular window
//      at conv position c sums  w[r] * xc[t*Q + c + u]  over the taps
//      r = u*step + t < window of the phase-major packed region, with the
//      unnormalised integer pyramid weights w[r] = min(r+1, window-r), and is
//      scaled once by 1/pyramid_sum; a small-chromosome window is the mean of
//      its contiguous tail columns;
//   3. the exact row median over the n_windows windows (select.cuh);
//   4. the median-centred windows, and their row sum and sum of squares.
//
// What bounds it on an H100: each row reads packed_width * 4 bytes from
// device memory once (80 KB at 20k genes) and writes n_windows * 4 (7 KB),
// so device memory is not the limit; the window arithmetic is: every window
// reads `window` taps (100 by default) through the L1 cache and recentres
// each, i.e. about `window / step` loads and centrings per input element.
// The design keeps the row's windows in shared memory (n_windows * 4 bytes),
// so the median's ~20-30 bisection passes and the final pass never touch
// device memory, and neighbouring threads take neighbouring windows, so each
// tap's loads are coalesced.  Staging the centred row in shared memory (or
// TMA tiles) and a radix-histogram select are the next steps for speed.
//
// Layout: one block of kThreads threads per cell row.  Writing in final order
// makes the TPU kernel's validity mask and its two output layouts
// unnecessary.

#include "select.cuh"

namespace infercnv {

__global__ void __launch_bounds__(kThreads) fused_window_kernel(
    const float* __restrict__ x,          // (rows, width) phase-major packed
    const float* __restrict__ ref2,       // (2, width): rmin, rmax
    const int* __restrict__ gmap,         // (n_windows,) raw column: conv position or P + small index
    const int* __restrict__ small_off,    // (n_small + 1,) absolute tail column offsets
    float* __restrict__ out,              // (rows, n_windows)
    float* __restrict__ stats,            // (rows, 3): row sum, row sum of squares, median
    int width, int n_windows, int P, int Q, int step, int window, int single_ref, float lfc_clip,
    float inv_sum) {
  extern __shared__ float win[];  // n_windows
  __shared__ int ired[kWarps];
  __shared__ float fred[kWarps];

  const long long row = blockIdx.x;
  const float* __restrict__ xr = x + row * width;
  const float* __restrict__ rmin = ref2;
  const float* __restrict__ rmax = ref2 + width;

  auto centred = [&](int col) -> float {
    const float v = __ldg(xr + col);
    const float lo = __ldg(rmin + col);
    float d;
    if (single_ref) {
      d = v - lo;
    } else {
      d = v - fminf(fmaxf(v, lo), __ldg(rmax + col));
    }
    return fminf(fmaxf(d, -lfc_clip), lfc_clip);
  };

  for (int k = threadIdx.x; k < n_windows; k += kThreads) {
    const int g = __ldg(gmap + k);
    float v;
    if (g < P) {
      float acc = 0.0f;
      int u = 0;
      for (int r0 = 0; r0 < window; r0 += step, ++u) {
        const int t_end = min(step, window - r0);
        for (int t = 0; t < t_end; ++t) {
          const int r = r0 + t;
          acc += static_cast<float>(min(r + 1, window - r)) * centred(t * Q + g + u);
        }
      }
      v = acc * inv_sum;
    } else {
      const int j = g - P;
      const int a = __ldg(small_off + j);
      const int b = __ldg(small_off + j + 1);
      float acc = 0.0f;
      for (int c = a; c < b; ++c) acc += centred(c);
      v = acc / static_cast<float>(b - a);
    }
    win[k] = v;
  }
  __syncthreads();

  const float med = block_median(win, n_windows, ired);

  float rs = 0.0f, rsq = 0.0f;
  float* __restrict__ orow = out + row * n_windows;
  for (int k = threadIdx.x; k < n_windows; k += kThreads) {
    const float d = win[k] - med;
    orow[k] = d;
    rs += d;
    rsq += d * d;
  }
  rs = block_reduce(rs, SumOp(), fred);
  rsq = block_reduce(rsq, SumOp(), fred);
  if (threadIdx.x == 0) {
    stats[row * 3 + 0] = rs;
    stats[row * 3 + 1] = rsq;
    stats[row * 3 + 2] = med;
  }
}

}  // namespace infercnv

extern "C" {

// Largest dynamic shared memory (bytes) a fused_window block may ask for on
// the current device, or a negative CUDA error code.
int fused_window_max_smem() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, infercnv::fused_window_kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

int fused_window_launch(const void* x, const void* ref2, const void* gmap, const void* small_off, void* out,
                        void* stats, int rows, int width, int n_windows, int P, int Q, int step, int window,
                        int single_ref, float lfc_clip, float inv_sum, void* stream) {
  const size_t smem = static_cast<size_t>(n_windows) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(infercnv::fused_window_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  infercnv::fused_window_kernel<<<rows, infercnv::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ref2), static_cast<const int*>(gmap),
      static_cast<const int*>(small_off), static_cast<float*>(out), static_cast<float*>(stats), width, n_windows, P,
      Q, step, window, single_ref, lfc_clip, inv_sum);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"

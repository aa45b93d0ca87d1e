// Per-gene back-projection kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel infercnvpy_tpu/ops/pallas_gene.py::_make_gene_kernel
// (launched by _gene_project_impl, API gene_project).  Per cell row of the
// median-centred, not yet gated window matrix it computes:
//   1. the mean of every coverage group: genes covered by the same (first,
//      last) window range have one value, the mean of windows lo..hi, summed
//      directly in window order (at most ceil(window / step) terms);
//   2. the exact median of the gene values, i.e. the weighted median of the
//      group means with each group counted once per gene (select.cuh);
//   3. the group means minus that median, zeroed where |value| < the row's
//      noise-gate threshold when `gate`;
//   4. the expansion to gene columns: out[row, c] = u[gidx[c]] for every
//      covered gene c, in the plan's covered_sorted order.
//
// What bounds it on an H100: the output.  A row reads n_windows * 4 bytes
// (7 KB at the bench shape) and writes n_covered * 4 (80 KB), so at 15,000
// rows the kernel writes 1.19 GB, 0.36 ms at the published 3.35 TB/s.  The
// select (about 30 block-wide passes over the n_groups means) runs in shared
// memory.  The design keeps the row's windows and group means in shared
// memory, so device memory sees one read of the row and one write of its gene
// columns, and neighbouring threads store neighbouring columns, so the stores
// coalesce.  The TPU kernel's prefix sum and banded gathers are not needed:
// shared memory gathers at any index.
//
// Layout: one block of kThreads threads per cell row.

#include "select.cuh"

namespace infercnv {

__global__ void __launch_bounds__(kThreads) gene_project_kernel(
    const float* __restrict__ x,         // (rows, n_windows) median-centred windows, before the gate
    const float* __restrict__ thr,       // (rows,) gate threshold, read when gate != 0
    const int* __restrict__ g_lo,        // (n_groups,) first covering window of each group
    const int* __restrict__ g_hi,        // (n_groups,) last covering window of each group
    const int* __restrict__ g_counts,    // (n_groups,) genes per group (>= 1)
    const int* __restrict__ gidx,        // (n_covered,) group of each output column
    float* __restrict__ out,             // (rows, n_covered)
    int n_windows, int n_groups, int n_covered, int gate) {
  extern __shared__ float smem[];
  float* win = smem;              // n_windows
  float* u = smem + n_windows;    // n_groups
  __shared__ int ired[kWarps];

  const long long row = blockIdx.x;
  const float* __restrict__ xr = x + row * n_windows;
  for (int k = threadIdx.x; k < n_windows; k += kThreads) win[k] = __ldg(xr + k);
  __syncthreads();

  for (int g = threadIdx.x; g < n_groups; g += kThreads) {
    const int lo = __ldg(g_lo + g);
    const int hi = __ldg(g_hi + g);
    float s = 0.0f;
    for (int j = lo; j <= hi; ++j) s += win[j];
    u[g] = s / static_cast<float>(hi - lo + 1);
  }
  __syncthreads();

  const float med = block_weighted_median<true>(u, g_counts, n_groups, n_covered, ired);
  const float t = gate ? __ldg(thr + row) : 0.0f;
  __syncthreads();  // every thread is done reading u
  for (int g = threadIdx.x; g < n_groups; g += kThreads) {
    const float d = u[g] - med;
    u[g] = (gate && fabsf(d) < t) ? 0.0f : d;
  }
  __syncthreads();

  float* __restrict__ orow = out + row * n_covered;
  for (int c = threadIdx.x; c < n_covered; c += kThreads) orow[c] = u[__ldg(gidx + c)];
}

}  // namespace infercnv

extern "C" {

// Largest dynamic shared memory (bytes) a gene_project block may ask for on
// the current device, or a negative CUDA error code.
int gene_project_max_smem() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, infercnv::gene_project_kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

int gene_project_launch(const void* x, const void* thr, const void* g_lo, const void* g_hi, const void* g_counts,
                        const void* gidx, void* out, int rows, int n_windows, int n_groups, int n_covered, int gate,
                        void* stream) {
  const size_t smem = static_cast<size_t>(n_windows + n_groups) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(infercnv::gene_project_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  infercnv::gene_project_kernel<<<rows, infercnv::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(thr), static_cast<const int*>(g_lo),
      static_cast<const int*>(g_hi), static_cast<const int*>(g_counts), static_cast<const int*>(gidx),
      static_cast<float*>(out), n_windows, n_groups, n_covered, gate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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
// What bounds it on an H100: bytes, nearly all of them the output.  A row
// reads n_windows * 4 bytes (7 KB at 1,793 windows) and writes n_covered * 4
// (80 KB at 19,910 genes): 1.42 GB at 16,384 rows, 0.43 ms at 3.35 TB/s.
// With a bisection select the kernel spent most of its time in the select's
// ~60 block-wide synchronisations, not in its stores; the radix select of
// select.cuh needs 10, so the expansion is what is left, and the design makes
// it a stream of 16-byte stores: a thread writes four neighbouring gene
// columns at a time (one 4-byte read of their groups, four reads of shared
// memory, one float4 store), neighbouring threads neighbouring vectors.  The
// groups of neighbouring columns rise by small steps (by 0 or 1 in a table
// that ops/gene.py builds), so the four groups of a vector are packed into
// one int: the first group and three 4-bit steps.  That is 20 KB a row at
// 19,910 genes instead of 80 KB of plain indices, small enough to stay in
// the L1 cache beside the blocks' shared memory.  A row starts at
// row * n_covered floats, which is 16-byte aligned only for some rows (every
// other one at 19,910), so the row's head is peeled to the next 16-byte
// address and the packed table exists in four copies, copy h for a head of h
// columns.  A table whose steps do not fit 4 bits has no packed copies and
// is expanded column by column.  Windows and group means live in shared
// memory; device memory sees one read of the row and one write of its gene
// columns.  The group means are direct sums in window order, so the ungated
// result is bit-identical to the plain version.  The TPU kernel's prefix sum and banded gathers are not
// needed: shared memory gathers at any index.
//
// Layout: persistent blocks, as many as fit the card at once, each walking
// over rows.  Stores and loads share the SM's path to memory, and a block
// that waited for its 7 KB of windows behind other blocks' 80 KB of stores
// left the card's arithmetic and its memory taking turns.  So a block asks
// for its next row's windows (cp.async into the second of two buffers) before
// it starts this row's select and stores; when it comes back to them they are
// in shared memory, and no phase but the stores waits for device memory.

#include <cuda_pipeline.h>

#include "select.cuh"

namespace infercnv {

// Start the asynchronous copy of one row of windows into shared memory.
__device__ __forceinline__ void prefetch_row(float* dst, const float* __restrict__ src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) __pipeline_memcpy_async(dst + k, src + k, sizeof(float));
  __pipeline_commit();
}

__global__ void __launch_bounds__(1024) gene_project_kernel(
    const float* __restrict__ x,         // (rows, n_windows) median-centred windows, before the gate
    const float* __restrict__ thr,       // (rows,) gate threshold, read when gate != 0
    const int* __restrict__ g_lo,        // (n_groups,) first covering window of each group
    const int* __restrict__ g_hi,        // (n_groups,) last covering window of each group
    const int* __restrict__ g_counts,    // (n_groups,) genes per group (>= 1)
    const int* __restrict__ gidx,        // (n_covered,) group of each output column
    const int* __restrict__ packed4,     // (4, packed_stride) or null: copy h, entry i: the groups of columns
                                         // h + 4i .. h + 4i + 3 as (first << 12) | step1 | step2 << 4 | step3 << 8
    float* __restrict__ out,             // (rows, n_covered)
    int rows, int n_windows, int n_groups, int n_covered, int packed_stride, int gate) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) int hist[kSelectScratch];
  float* win2 = smem;                  // two buffers of n_windows
  float* u = smem + 2 * n_windows;     // n_groups

  const int tid = threadIdx.x, threads = blockDim.x;
  long long row = blockIdx.x;
  prefetch_row(win2, x + row * n_windows, n_windows);
  for (int it = 0; row < rows; row += gridDim.x, ++it) {
    const float* win = win2 + (it & 1) * n_windows;
    __pipeline_wait_prior(0);
    __syncthreads();  // this row's windows have arrived; the previous row's reads of u are done

    for (int g = tid; g < n_groups; g += threads) {
      const int lo = __ldg(g_lo + g);
      const int hi = __ldg(g_hi + g);
      float s = 0.0f;
      for (int j = lo; j <= hi; ++j) s += win[j];
      u[g] = s / static_cast<float>(hi - lo + 1);
    }
    __syncthreads();
    // the next row's windows travel while this row's select runs and its gene
    // columns are stored: the request is ahead of the stores in the memory queue
    const long long next = row + gridDim.x;
    if (next < rows) prefetch_row(win2 + ((it + 1) & 1) * n_windows, x + next * n_windows, n_windows);

    const float med = block_weighted_median<true>(u, g_counts, n_groups, n_covered, hist);
    const float t = gate ? __ldg(thr + row) : 0.0f;
    __syncthreads();  // every thread is done reading u
    for (int g = tid; g < n_groups; g += threads) {
      const float d = u[g] - med;
      u[g] = (gate && fabsf(d) < t) ? 0.0f : d;
    }
    __syncthreads();

    float* __restrict__ orow = out + row * n_covered;
    // head: the columns before the row's first 16-byte aligned address
    int head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(orow) & 15)) & 15) >> 2);
    const bool vec = packed4 != nullptr && (reinterpret_cast<uintptr_t>(orow) & 3) == 0;
    head = vec ? (head < n_covered ? head : n_covered) : 0;
    const int n4 = vec ? (n_covered - head) >> 2 : 0;  // without packed copies every column is a scalar store
    if (tid < head) orow[tid] = u[__ldg(gidx + tid)];
    const int* __restrict__ pk = packed4 + static_cast<long long>(head & 3) * packed_stride;
    float4* __restrict__ o4 = reinterpret_cast<float4*>(orow + head);
#pragma unroll 4
    for (int i = tid; i < n4; i += threads) {
      const int e = __ldg(pk + i);
      const int g0 = e >> 12;
      const int g1 = g0 + (e & 15);
      const int g2 = g1 + ((e >> 4) & 15);
      const int g3 = g2 + ((e >> 8) & 15);
      float4 v;
      v.x = u[g0];
      v.y = u[g1];
      v.z = u[g2];
      v.w = u[g3];
      __stcs(o4 + i, v);  // written once, read by no one here
    }
    for (int c = head + (n4 << 2) + tid; c < n_covered; c += threads) orow[c] = u[__ldg(gidx + c)];
  }
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

// packed4: the four packed copies of the group table (ops/gene.py::packed_gidx),
// each packed_stride ints long, or null.  max_smem is what
// gene_project_max_smem returned.  threads: a multiple of 32 in [32, 1024].
int gene_project_launch(const void* x, const void* thr, const void* g_lo, const void* g_hi, const void* g_counts,
                        const void* gidx, const void* packed4, void* out, int rows, int n_windows, int n_groups,
                        int n_covered, int packed_stride, int gate, int max_smem, int threads, void* stream) {
  const size_t smem = static_cast<size_t>(2 * n_windows + n_groups) * sizeof(float);
  // the largest size any launch may ask for, so that no later launch is refused
  cudaError_t e = cudaFuncSetAttribute(infercnv::gene_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       max_smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, infercnv::gene_project_kernel, threads, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(rows < resident ? rows : resident);
  infercnv::gene_project_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(thr), static_cast<const int*>(g_lo),
      static_cast<const int*>(g_hi), static_cast<const int*>(g_counts), static_cast<const int*>(gidx),
      static_cast<const int*>(packed4), static_cast<float*>(out), rows, n_windows, n_groups, n_covered,
      packed_stride, gate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

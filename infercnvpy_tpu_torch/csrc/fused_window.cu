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
// What bounds it on an H100: bytes.  A row reads packed_width * 4 bytes from
// device memory (80 KB at 20,480 columns) and writes n_windows * 4 (7 KB):
// 1.46 GB at 16,384 rows, 0.44 ms at 3.35 TB/s.  The window arithmetic
// (100 multiply-adds a window, 5.9e9 FLOP at that shape) is a fifth of that
// on the CUDA cores, but only if every input element is loaded and centred
// once and the taps do not go back to the L1 cache one by one.  The design:
//   * stage: the block reads x, rmin and rmax once, coalesced, 16 bytes a
//     thread where the addresses allow (else 4), centres and clips each
//     element once and keeps the centred row in shared memory, the
//     small-chromosome tail behind the phase planes;
//   * windows out of shared memory with register tiling: a task is an
//     aligned group of 4 neighbouring conv positions; per phase plane its
//     thread reads 16-byte vectors (no bank conflicts) and each value feeds
//     up to 4 windows.  For the default window 100 / step 10 the loops unroll
//     and the pyramid weights are immediates; other values take the weights
//     from a table in shared memory;
//   * the windows stay in shared memory for the radix select and the last
//     pass, which writes them median-centred;
//   * overlap: a row and its scratch take ~98 KB at the default shape, so
//     two blocks of 512 threads share an SM and one block's loads run under
//     the other's arithmetic and select.
// A packed row too wide for shared memory goes through in column tiles: a
// tile stages, per phase plane, its conv positions plus a halo (the taps
// that reach past them and the 16-byte look-ahead), and the tail with the
// first tile if it fits (else the small-chromosome means read device
// memory); ops/fused.py::stage_plan sizes the tiles so that two blocks still
// share an SM.  The summation order per window is fixed (phase, then tap),
// so a rerun gives identical bits.
//
// Measured on an H100 and left out: staging the raw row by cp.async and
// centring it in place, persistent blocks walking over rows, narrower tiles
// with 3 to 8 smaller blocks an SM, and 2 to 4 rows a block sharing one read
// of the reference rows were each no faster or slower than this.
//
// Layout: one block per cell row.  Writing in final order makes the TPU
// kernel's validity mask and its two output layouts unnecessary.
// ops/fused.py builds the task table and the stage plan (window_tasks,
// stage_plan) and repeats this file's indexing in numpy
// (staged_windows_emulated) for the CPU tests.

#include "select.cuh"

namespace infercnv {

constexpr int kGroup = 4;  // conv positions per task

struct FusedArgs {
  const float* x;        // (rows, width) phase-major packed
  const float* ref2;     // (2, width): rmin, rmax
  const int4* tasks;     // (n_tasks,): regular {k_first, a4, j0 | j1 << 8, 0} sorted by a4, then the
                         // n_small small-chromosome tasks {k, col_a, -1, col_b}
  const int* tile_ptr;   // (n_tiles + 1,): tile i's regular tasks are tasks[tile_ptr[i] .. tile_ptr[i + 1])
  const float* wtab;     // (window,) pyramid weights, read by the generic instantiation
  float* out;            // (rows, n_windows)
  float* stats;          // (rows, 3): row sum, row sum of squares, median
  int n_tasks, n_small, width, n_windows, packed_len, Q, step, window, single_ref;
  int n_tiles, tile_conv, plane_stride, row_stage, tail_off;
  float lfc_clip, inv_sum;
};

__device__ __forceinline__ float centre1(float v, float lo, float hi, int single_ref, float clip) {
  const float d = single_ref ? v - lo : v - fminf(fmaxf(v, lo), hi);
  return fminf(fmaxf(d, -clip), clip);
}

__device__ __forceinline__ float4 centre4(float4 v, float4 lo, float4 hi, int single_ref, float clip) {
  float4 o;
  o.x = centre1(v.x, lo.x, hi.x, single_ref, clip);
  o.y = centre1(v.y, lo.y, hi.y, single_ref, clip);
  o.z = centre1(v.z, lo.z, hi.z, single_ref, clip);
  o.w = centre1(v.w, lo.w, hi.w, single_ref, clip);
  return o;
}

// Centre global columns [col, col + len) of the row into dst[0, len).
__device__ __forceinline__ void stage_segment(const FusedArgs& a, const float* __restrict__ xr, int col, int len,
                                              float* dst, bool vec_ok) {
  const int tid = threadIdx.x, threads = blockDim.x;
  const float* __restrict__ rmin = a.ref2;
  const float* __restrict__ rmax = a.ref2 + a.width;
  if (vec_ok && (col & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = len >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xr + col);
    const float4* lo4 = reinterpret_cast<const float4*>(rmin + col);
    const float4* hi4 = reinterpret_cast<const float4*>(rmax + col);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int i = tid; i < n4; i += threads) {
      const float4 v = __ldcs(x4 + i);  // read once: do not keep it in the caches
      d4[i] = centre4(v, __ldg(lo4 + i), __ldg(hi4 + i), a.single_ref, a.lfc_clip);
    }
    for (int i = (n4 << 2) + tid; i < len; i += threads) {
      dst[i] = centre1(__ldcs(xr + col + i), __ldg(rmin + col + i), __ldg(rmax + col + i), a.single_ref, a.lfc_clip);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < len; i += threads) {
      dst[i] = centre1(__ldcs(xr + col + i), __ldg(rmin + col + i), __ldg(rmax + col + i), a.single_ref, a.lfc_clip);
    }
  }
}

// One tile's stage.  A single tile whose planes lie Q apart is the packed
// row as it is (the tail behind the planes): one contiguous segment.  Else
// the tile's columns of every phase plane and, with the first tile, the
// small-chromosome tail.
__device__ __forceinline__ void stage_tile(const FusedArgs& a, const float* __restrict__ xr, int tile, float* stage,
                                           bool vec_ok) {
  if (a.n_tiles == 1 && a.plane_stride == a.Q && (a.tail_off == a.packed_len || a.tail_off < 0)) {
    stage_segment(a, xr, 0, a.tail_off >= 0 ? a.width : a.packed_len, stage, vec_ok);
    return;
  }
  const int c0 = tile * a.tile_conv;
  const int len = min(a.plane_stride, a.Q - c0);
  for (int t = 0; t < a.step; ++t) stage_segment(a, xr, t * a.Q + c0, len, stage + t * a.plane_stride, vec_ok);
  if (tile == 0 && a.tail_off >= 0) {
    stage_segment(a, xr, a.packed_len, a.width - a.packed_len, stage + a.tail_off, vec_ok);
  }
}

// The kGroup windows at conv positions a4 .. a4 + 3, unscaled.  `p0` points
// to plane 0's staged value of conv position a4 (16-byte aligned); plane t
// lies t * plane_stride floats further.
template <int kStep, int kWindow>
__device__ __forceinline__ void window_group(const float* p0, int plane_stride, int step_rt, int window_rt,
                                             const float* wtab, float acc[kGroup]) {
  const int step = kStep ? kStep : step_rt;
  const int window = kWindow ? kWindow : window_rt;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int t = 0; t < step; ++t) {
    const int nu = (window - t + step - 1) / step;  // taps u with u * step + t < window
    const float4* p = reinterpret_cast<const float4*>(p0 + t * plane_stride);
    float4 cur = p[0];
#pragma unroll
    for (int u0 = 0; u0 < nu; u0 += 4) {
      const float4 nxt = p[(u0 >> 2) + 1];
      const float v[7] = {cur.x, cur.y, cur.z, cur.w, nxt.x, nxt.y, nxt.z};
#pragma unroll
      for (int uu = 0; uu < 4; ++uu) {
        const int u = u0 + uu;
        if (u < nu) {
          const int r = u * step + t;
          float wgt;
          if constexpr (kWindow != 0) {
            wgt = static_cast<float>(r + 1 < kWindow - r ? r + 1 : kWindow - r);
          } else {
            wgt = wtab[r];
          }
#pragma unroll
          for (int j = 0; j < kGroup; ++j) acc[j] = fmaf(wgt, v[uu + j], acc[j]);
        }
      }
      cur = nxt;
    }
  }
}

template <int kStep, int kWindow>
__global__ void __launch_bounds__(512, 2) fused_window_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) int hist[kSelectScratch];
  __shared__ float fred[kMaxWarps];
  float* stage = smem;                // row_stage
  float* win = stage + a.row_stage;   // n_windows
  float* wtab = win + a.n_windows;    // window (generic instantiation only)

  const int tid = threadIdx.x, threads = blockDim.x;
  const long long row = blockIdx.x;
  const float* __restrict__ xr = a.x + row * a.width;
  // the row and both reference rows start on 16 bytes
  const bool vec_ok = ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(a.ref2)) & 15) == 0 &&
                      (a.width & 3) == 0;

  if constexpr (kWindow == 0) {
    for (int i = tid; i < a.window; i += threads) wtab[i] = __ldg(a.wtab + i);
  }

  for (int tile = 0; tile < a.n_tiles; ++tile) {
    const int c0 = tile * a.tile_conv;
    stage_tile(a, xr, tile, stage, vec_ok);
    __syncthreads();

    const int t0 = __ldg(a.tile_ptr + tile);
    const int t1 = __ldg(a.tile_ptr + tile + 1);
    for (int i = t0 + tid; i < t1; i += threads) {
      const int4 task = __ldg(a.tasks + i);
      float acc[kGroup];
      window_group<kStep, kWindow>(stage + (task.y - c0), a.plane_stride, a.step, a.window, wtab, acc);
      const int j0 = task.z & 0xFF, j1 = task.z >> 8;
      float* w = win + task.x - j0;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j >= j0 && j < j1) w[j] = acc[j] * a.inv_sum;
      }
    }
    if (tile == 0) {
      for (int i = a.n_tasks - a.n_small + tid; i < a.n_tasks; i += threads) {
        const int4 task = __ldg(a.tasks + i);
        float acc = 0.0f;
        if (a.tail_off >= 0) {
          const float* tail = stage + a.tail_off - a.packed_len;
          for (int c = task.y; c < task.w; ++c) acc += tail[c];
        } else {
          for (int c = task.y; c < task.w; ++c) {
            acc += centre1(__ldg(xr + c), __ldg(a.ref2 + c), __ldg(a.ref2 + a.width + c), a.single_ref, a.lfc_clip);
          }
        }
        win[task.x] = acc / static_cast<float>(task.w - task.y);
      }
    }
    __syncthreads();  // the stage is free for the next tile; the last tile's windows are complete
  }

  const float med = block_median(win, a.n_windows, hist);
  float rs = 0.0f, rsq = 0.0f;
  float* __restrict__ orow = a.out + row * a.n_windows;
  for (int k = tid; k < a.n_windows; k += threads) {
    const float d = win[k] - med;
    orow[k] = d;
    rs += d;
    rsq += d * d;
  }
  rs = block_sum(rs, fred);
  rsq = block_sum(rsq, fred);
  if (tid == 0) {
    a.stats[row * 3 + 0] = rs;
    a.stats[row * 3 + 1] = rsq;
    a.stats[row * 3 + 2] = med;
  }
}

template <int kStep, int kWindow>
cudaError_t launch_fused(const FusedArgs& a, int blocks, int threads, size_t smem, int max_dynamic,
                         cudaStream_t stream) {
  // the largest size any launch may ask for, so that no later launch is refused
  cudaError_t e = cudaFuncSetAttribute(fused_window_kernel<kStep, kWindow>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, max_dynamic);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(fused_window_kernel<kStep, kWindow>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return e;
  fused_window_kernel<kStep, kWindow><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace infercnv

extern "C" {

// Dynamic shared memory (bytes) a fused_window block may ask for on the
// current device so that `blocks_per_sm` blocks fit an SM together
// (blocks_per_sm = 1: the most a block can have), or a negative CUDA error
// code.
int fused_window_smem_budget(int blocks_per_sm) {
  int dev = 0, optin = 0, per_sm = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  cudaFuncAttributes fixed, generic;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fixed, infercnv::fused_window_kernel<10, 100>);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&generic, infercnv::fused_window_kernel<0, 0>);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int fixed_bytes = static_cast<int>(fixed.sharedSizeBytes > generic.sharedSizeBytes ? fixed.sharedSizeBytes
                                                                                         : generic.sharedSizeBytes);
  const int most = optin - fixed_bytes;
  if (blocks_per_sm <= 1) return most;
  const int share = per_sm / blocks_per_sm - reserved - fixed_bytes;
  return share < most ? share : most;
}

// tasks, tile_ptr, wtab and the tiling come from ops/fused.py (window_tasks,
// stage_plan); smem_bytes is the dynamic shared memory of that plan and
// max_smem what fused_window_smem_budget(1) returned.  threads: a multiple of
// 32 in [32, 512].
int fused_window_launch(const void* x, const void* ref2, const void* tasks, const void* tile_ptr, const void* wtab,
                        void* out, void* stats, int rows, int width, int n_windows, int n_tasks, int n_small,
                        int packed_len, int Q, int step, int window, int single_ref, int n_tiles, int tile_conv,
                        int plane_stride, int row_stage, int tail_off, int smem_bytes, int max_smem, int threads,
                        float lfc_clip, float inv_sum, void* stream) {
  infercnv::FusedArgs a;
  a.x = static_cast<const float*>(x);
  a.ref2 = static_cast<const float*>(ref2);
  a.tasks = static_cast<const int4*>(tasks);
  a.tile_ptr = static_cast<const int*>(tile_ptr);
  a.wtab = static_cast<const float*>(wtab);
  a.out = static_cast<float*>(out);
  a.stats = static_cast<float*>(stats);
  a.n_tasks = n_tasks;
  a.n_small = n_small;
  a.width = width;
  a.n_windows = n_windows;
  a.packed_len = packed_len;
  a.Q = Q;
  a.step = step;
  a.window = window;
  a.single_ref = single_ref;
  a.n_tiles = n_tiles;
  a.tile_conv = tile_conv;
  a.plane_stride = plane_stride;
  a.row_stage = row_stage;
  a.tail_off = tail_off;
  a.lfc_clip = lfc_clip;
  a.inv_sum = inv_sum;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (step == 10 && window == 100) {
    e = infercnv::launch_fused<10, 100>(a, rows, threads, smem_bytes, max_smem, s);
  } else {
    e = infercnv::launch_fused<0, 0>(a, rows, threads, smem_bytes, max_smem, s);
  }
  return static_cast<int>(e);
}

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"

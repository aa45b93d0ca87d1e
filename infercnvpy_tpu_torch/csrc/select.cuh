// Block-wide reductions and the exact rank select shared by the kernels.
//
// Counterpart of the TPU select routine in
// infercnvpy_tpu/ops/pallas_fused.py::_select_kth_multi (with and without its
// `weights` argument) and of the standalone kernels in
// infercnvpy_tpu/ops/pallas_select.py (_median_kernel, _wmedian_kernel,
// row_kth_smallest): an exact rank-k selection by bisection over
// order-preserving integer keys of the float bit patterns, seeded with the
// smallest and largest key that takes part.  The search converges to a key
// that occurs among those values, so the result is an element bit for bit.
//
// Weighted form: value i counts wts[i] times (the median of
// np.repeat(vals, wts)); a zero weight drops the value from the ranks and from
// the min/max seed.  The unweighted form counts each value once.  An even
// total averages the two middle elements (np.median).
//
// All reductions run in a fixed order (warp butterfly, then the per-warp
// partials combined in warp order), so a rerun gives identical bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace infercnv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int float_key(float x) {
  int i = __float_as_int(x);
  return i ^ (0x7FFFFFFF & (i >> 31));
}

__device__ __forceinline__ float key_to_float(int k) {
  return __int_as_float(k ^ (0x7FFFFFFF & (k >> 31)));
}

struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct MinOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Reduce one value per thread over the block; every thread gets the result.
// `red` is shared scratch of kWarps entries of T.  Must be reached by all
// threads of the block (it synchronises).
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // earlier readers of `red` are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, red[w]);
  return r;
}

// Multiplicity of value i: wts[i] when weighted, else 1.
template <bool kWeighted>
__device__ __forceinline__ int weight_at(const int* wts, int i) {
  if constexpr (kWeighted) {
    return wts[i];
  } else {
    return 1;
  }
}

// Key of the element of rank k (0-based) among vals[0, n), each counted
// weight_at(i) times; k must be below the total weight.  `vals` and `wts` may
// point to shared or global memory; every thread of the block must call it
// and every thread gets the result.  `ired` is shared int scratch of kWarps.
template <bool kWeighted>
__device__ int block_select_key(const float* vals, const int* wts, int n, int k, int* ired) {
  int lo = INT32_MAX, hi = INT32_MIN;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (weight_at<kWeighted>(wts, i) > 0) {
      const int key = float_key(vals[i]);
      lo = key < lo ? key : lo;
      hi = key > hi ? key : hi;
    }
  }
  lo = block_reduce(lo, MinOp(), ired);
  hi = block_reduce(hi, MaxOp(), ired);
  // smallest key m with weight(key <= m) >= k + 1 is the rank-k key; lo and
  // hi are block-uniform, so the loop is too
  while (lo < hi) {
    const int mid = (lo & hi) + ((lo ^ hi) >> 1);  // overflow-safe signed midpoint
    int c = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (float_key(vals[i]) <= mid) c += weight_at<kWeighted>(wts, i);
    }
    c = block_reduce(c, SumOp(), ired);
    if (c >= k + 1) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Median of vals[0, n) with each value counted weight_at(i) times, where
// `total` is the weight sum (>= 1): np.median(np.repeat(vals, wts)).
template <bool kWeighted>
__device__ float block_weighted_median(const float* vals, const int* wts, int n, int total, int* ired) {
  const int k_hi = total / 2;
  const int kh = block_select_key<kWeighted>(vals, wts, n, k_hi, ired);
  const float v_hi = key_to_float(kh);
  if (total & 1) return v_hi;
  // lower middle: kh itself when it also occupies rank k_hi - 1 (less than
  // k_hi weight lies strictly below it), else the largest key below it
  int cnt_lt = 0, max_lt = INT32_MIN;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int w = weight_at<kWeighted>(wts, i);
    const int key = float_key(vals[i]);
    if (w > 0 && key < kh) {
      cnt_lt += w;
      max_lt = key > max_lt ? key : max_lt;
    }
  }
  cnt_lt = block_reduce(cnt_lt, SumOp(), ired);
  max_lt = block_reduce(max_lt, MaxOp(), ired);
  const int kl = cnt_lt < k_hi ? kh : max_lt;
  return (key_to_float(kl) + v_hi) / 2.0f;
}

// Exact median of vals[0, n) (n >= 1), np.median semantics.
__device__ inline float block_median(const float* vals, int n, int* ired) {
  return block_weighted_median<false>(vals, nullptr, n, n, ired);
}

}  // namespace infercnv

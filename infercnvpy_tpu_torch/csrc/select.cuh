// Block-wide reductions and the exact rank select shared by the kernels.
//
// Counterpart of the TPU select routine in
// infercnvpy_tpu/ops/pallas_fused.py::_select_kth_multi (with and without its
// `weights` argument) and of the standalone kernels in
// infercnvpy_tpu/ops/pallas_select.py (_median_kernel, _wmedian_kernel,
// row_kth_smallest): an exact rank-k selection over order-preserving integer
// keys of the float bit patterns.  The result is a key that occurs among the
// values, so it is an element of the row bit for bit.
//
// What bounds a select on an H100: a row is a few KB (7 KB at 1,793 values),
// so the bytes are nothing; the time is the number of block-wide synchronised
// steps.  A bisection over the key range needs 20-30 of them, each with a
// reduction.  This routine is a most-significant-digit radix select instead:
// 4 passes of 8 bits.  A pass adds each value that still matches the prefix
// found so far to a 256-bin histogram in shared memory (integer atomicAdd of
// its weight, so the counts are the same on every run), synchronises, and
// then the first warp scans the bins (two 16-byte reads a lane and a shuffle
// scan) to find the digit that holds the rank and hands it to the block
// through shared memory: 10 block-wide synchronisations in all, whatever the
// key range.  (Every warp scanning for itself saves the second
// synchronisation of a pass but was slower: with 8-16 warps the scans were
// most of the select's instructions.)  The keys and weights of
// the first kItems * blockDim.x values stay in registers between the passes;
// a longer row reads the rest from `vals` again.
//
// Two ranks are found together (`rank_lo <= rank_hi`): the two middle
// elements of an even total share histograms while their prefixes agree and
// get one each from the pass after the one in which they part.  An odd total
// and the k-th smallest pass the same rank twice.
//
// Weighted form: value i counts wts[i] times (the median of
// np.repeat(vals, wts)); a zero weight drops the value.  The unweighted form
// counts each value once.  An even total averages the two middle elements
// (np.median).
//
// The sum reductions run in a fixed order (warp butterfly, then the per-warp
// partials combined in warp order), so a rerun gives identical bits.
//
// ops/select.py::radix_select_emulated repeats the digit, histogram, bin-scan
// and two-rank logic in numpy; the CPU tests hold it against the key-sort
// versions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace infercnv {

constexpr int kMaxWarps = 32;       // a block has at most 1024 threads
constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kPasses = 32 / kRadixBits;
constexpr int kSelectItems = 8;     // values a thread keeps in registers
// ints of shared scratch a select needs: per pass one histogram for each rank
constexpr int kSelectScratch = kPasses * 2 * kBins;

__device__ __forceinline__ int float_key(float x) {
  int i = __float_as_int(x);
  return i ^ (0x7FFFFFFF & (i >> 31));
}

__device__ __forceinline__ float key_to_float(int k) {
  return __int_as_float(k ^ (0x7FFFFFFF & (k >> 31)));
}

// unsigned key whose unsigned order is the float order
__device__ __forceinline__ uint32_t radix_key(float x) {
  return static_cast<uint32_t>(float_key(x)) ^ 0x80000000u;
}

__device__ __forceinline__ float radix_key_to_float(uint32_t u) {
  return key_to_float(static_cast<int>(u ^ 0x80000000u));
}

// Sum one value per thread over the block; every thread gets the result.
// `red` is shared scratch of kMaxWarps entries of T.  Must be reached by all
// threads of the block (it synchronises).
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = (blockDim.x + 31) >> 5;
  __syncthreads();  // earlier readers of `red` are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < n_warps; ++w) r += red[w];
  return r;
}

// One lane's share of a 256-bin histogram (8 neighbouring bins) and the
// warp-wide running sums over the lanes' shares.
struct BinScan {
  int c[8];
  int exc, inc;  // weight in the bins before this lane's, and with them
};

// `hist`: kBins ints, 16-byte aligned.  Called by a whole warp.
__device__ __forceinline__ BinScan scan_bins(const int* hist) {
  const int lane = threadIdx.x & 31;
  const int4 a = reinterpret_cast<const int4*>(hist)[2 * lane];
  const int4 b = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
  BinScan s = {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}, 0, 0};
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += s.c[j];
  s.inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, s.inc, o);
    if (lane >= o) s.inc += up;
  }
  s.exc = s.inc - sum;
  return s;
}

// The bin that holds rank k, and the rank inside that bin: the smallest d
// with hist[0] + ... + hist[d] > k.  Every lane of the warp gets both.  k must
// be below the sum of the bins.
__device__ __forceinline__ void find_bin(const BinScan& s, int k, int* digit, int* k_in_bin) {
  const int lane = threadIdx.x & 31;
  // this lane's answer, valid in the one lane whose bins hold the rank
  int d = 0, rest = k - s.exc;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    if (d == j && rest >= s.c[j]) {
      rest -= s.c[j];
      d = j + 1;
    }
  }
  const unsigned holds = __ballot_sync(0xffffffffu, s.exc <= k && k < s.inc);
  const int src = __ffs(holds) - 1;
  *digit = __shfl_sync(0xffffffffu, 8 * lane + d, src);
  *k_in_bin = __shfl_sync(0xffffffffu, rest, src);
}

// Keys of the elements of ranks rank_lo <= rank_hi (0-based) among
// vals[0, n), each counted wts[i] times when kWeighted, else once; rank_hi
// must be below the total weight.  `vals` and `wts` may point to shared or
// global memory.  Every thread of the block must call it (it synchronises)
// and every thread gets both keys.  `hist` is shared scratch of
// kSelectScratch ints, 16-byte aligned.
template <bool kWeighted>
__device__ __forceinline__ void block_select2(const float* vals, const int* wts, int n, int rank_lo, int rank_hi,
                                              int* hist, uint32_t* key_lo, uint32_t* key_hi) {
  __shared__ int found[4];  // the first warp's answer of a pass: digit and rank in bin, for hi and lo
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  uint32_t keys[kSelectItems];
  int w[kSelectItems];
#pragma unroll
  for (int j = 0; j < kSelectItems; ++j) {
    const int i = tid + j * threads;
    w[j] = 0;
    keys[j] = 0;
    if (i < n) {
      keys[j] = radix_key(vals[i]);
      w[j] = kWeighted ? wts[i] : 1;
    }
  }
  const int cached = kSelectItems * threads;
  const bool two = rank_lo != rank_hi;

  __syncthreads();  // the previous user of `hist` and `found` is done
  for (int i = tid; i < kSelectScratch; i += threads) hist[i] = 0;
  __syncthreads();

  uint32_t pre_lo = 0, pre_hi = 0;
  int k_lo = rank_lo, k_hi = rank_hi;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int shift = 32 - kRadixBits * (p + 1);
    const uint32_t above = p == 0 ? 0u : 0xFFFFFFFFu << (shift + kRadixBits);
    int* h_hi = hist + p * 2 * kBins;
    int* h_lo = h_hi + kBins;
    const bool parted = pre_lo != pre_hi;  // block-uniform
    auto count = [&](uint32_t key, int weight) {
      if (weight <= 0) return;
      const int bin = (key >> shift) & (kBins - 1);
      if ((key & above) == pre_hi) {
        atomicAdd(h_hi + bin, weight);
      } else if (parted && (key & above) == pre_lo) {
        atomicAdd(h_lo + bin, weight);
      }
    };
#pragma unroll
    for (int j = 0; j < kSelectItems; ++j) count(keys[j], w[j]);
    for (int i = cached + tid; i < n; i += threads) count(radix_key(vals[i]), kWeighted ? wts[i] : 1);
    __syncthreads();
    // one warp scans the bins; the others wait for its answer and spend no
    // instructions on a scan of their own
    if (tid < 32) {
      const BinScan s_hi = scan_bins(h_hi);
      int d_hi, r_hi, d_lo, r_lo;
      find_bin(s_hi, k_hi, &d_hi, &r_hi);
      if (!two) {
        d_lo = d_hi;
        r_lo = r_hi;
      } else if (parted) {
        find_bin(scan_bins(h_lo), k_lo, &d_lo, &r_lo);
      } else {
        find_bin(s_hi, k_lo, &d_lo, &r_lo);
      }
      if (tid == 0) {
        found[0] = d_hi;
        found[1] = r_hi;
        found[2] = d_lo;
        found[3] = r_lo;
      }
    }
    __syncthreads();
    pre_hi |= static_cast<uint32_t>(found[0]) << shift;
    k_hi = found[1];
    pre_lo |= static_cast<uint32_t>(found[2]) << shift;
    k_lo = found[3];
    // the next pass's first write to `found` comes after its own barrier
  }
  *key_lo = pre_lo;
  *key_hi = pre_hi;
}

// Median of vals[0, n) with each value counted wts[i] times (once when not
// kWeighted), where `total` is the weight sum (>= 1):
// np.median(np.repeat(vals, wts)).
template <bool kWeighted>
__device__ __forceinline__ float block_weighted_median(const float* vals, const int* wts, int n, int total,
                                                       int* hist) {
  const int k_hi = total / 2;
  const int k_lo = (total & 1) ? k_hi : k_hi - 1;
  uint32_t lo, hi;
  block_select2<kWeighted>(vals, wts, n, k_lo, k_hi, hist, &lo, &hi);
  const float v_hi = radix_key_to_float(hi);
  if (total & 1) return v_hi;
  return (radix_key_to_float(lo) + v_hi) / 2.0f;
}

// Exact median of vals[0, n) (n >= 1), np.median semantics.
__device__ __forceinline__ float block_median(const float* vals, int n, int* hist) {
  return block_weighted_median<false>(vals, nullptr, n, n, hist);
}

// Element of rank k (0-based) of vals[0, n), 0 <= k < n.
__device__ __forceinline__ float block_kth_smallest(const float* vals, int n, int k, int* hist) {
  uint32_t lo, hi;
  block_select2<false>(vals, nullptr, n, k, k, hist, &lo, &hi);
  return radix_key_to_float(hi);
}

}  // namespace infercnv

// One warp per row: the exact rank select of select.cuh with the row's keys
// in registers and no block-wide barrier.
//
// Counterpart of the standalone TPU select kernels in
// infercnvpy_tpu/ops/pallas_select.py (_median_kernel, row_kth_smallest's
// inner kernel and _wmedian_kernel) for rows of up to kWarpMaxWidth values;
// wider rows keep the block routine of select.cuh (block_select2), which K1
// and K3 also call.
//
// What bounds it on an H100: bytes, if the select keeps out of the way.  A
// row of 1,793 values is 7 KB read once, and 16,384 of them take 0.035 ms at
// 3.35 TB/s.  The block routine spends a block of 256 threads and 10
// __syncthreads on each row, so most of the row's time is spent waiting on
// barriers with no load in flight.  Here:
//   * one warp owns a row: lane l holds the keys of values l, l + 32, ...
//     (kKeys registers, up to 64) for the whole select.  The row comes into
//     a stage in shared memory by one bulk copy (cp.async.bulk on an
//     mbarrier; the up to 3 values before the first 16-byte boundary and
//     after the last are loaded by lanes), and as soon as its keys are in
//     registers the copy of the warp's next row starts, so that row is in
//     flight while this one is selected.  Loading the keys straight from
//     device memory (4 bytes a lane, rows off 16 bytes) read at ~1.1 TB/s;
//   * the passes synchronise with __syncwarp, ballots and shuffles only: the
//     bin scan is select.cuh's warp-wide scan_bins / find_bin, run by the
//     warp itself;
//   * in the first pass, where every value counts and a row of similar
//     magnitudes falls into 10-15 of the 256 bins, lane l adds to copy l % 4
//     of the histogram (the copies set 4 ints apart, so one bin of two copies
//     sits in two banks), so at most 8 lanes meet on an address; the scan
//     sums the copies.  One histogram for the warp serialised on those few
//     bins; grouping the lanes of a bin with __match_any_sync was slower
//     still, byte counters of each lane's own (no two lanes on a word) cost
//     more to sum, and 8 copies more to zero and sum than their fewer
//     conflicts saved;
//   * the keys of the one or two top digits the first pass chose (a few
//     dozen of 1,793 for the median of continuous data) are compacted into a
//     list by ballot, and passes 2-4 read only the list, adding to one shared
//     histogram with atomics.  Counts stay exact integers.  Only the lower
//     rank goes through them: the upper middle of an even width is that key
//     again or the least listed key above it, two warp reductions (carrying
//     both ranks through the passes, as block_select2 does, cost 0.01-0.02
//     ms more).  Ranking a short list by comparison through shuffles, or bit
//     by bit with ballots, in place of passes 2-4 was slower;
//   * blocks of kWarpsPerBlock warps are persistent and each warp walks rows
//     r, r + kWarpsPerBlock * grid, ...; an SM holds 12 warps (their stages
//     and scratch fill its shared memory), 3 blocks.  1 to 4 warps a block
//     timed the same, 6 and 12 slower (ops/variants.py's warp_*_warps
//     variants time other counts).
// A warp's shared memory: the row's stage (8 KB), the first pass's 4
// histogram copies (4 KB, zeroed with 16-byte stores at each row), and over
// them the later passes' histogram (1 KB) and the list (8 KB at most).
//
// K4, the weighted median (np.median(np.repeat(row, weights))), runs the same
// row loop with an int32 weight a column (warp_wselect2):
//   * the weights are the same for every row: a block copies them once into
//     a table in shared memory, 16-bit where the weight total fits (4 KB a
//     block), else 32-bit (8 KB), and a lane reads a slot's weight where it
//     adds it.  Held in registers (two 16-bit weights a register, or one a
//     register), they and the compiler's per-slot tests, hoisted out of the
//     row loop, took 168 registers and spilled;
//   * the first pass adds weights, so lanes that meet on a bin take turns,
//     where K2's increments are merged by the hardware: most of what K4 costs
//     over K2.  Summing the row's heaviest bins in registers instead, or 8
//     copies, was slower;
//   * the list keeps (key, weight) pairs, a key of weight 0 among them (the
//     weight is not tested before the list); a list of at most 32 keys (the
//     usual one for continuous values) is ranked in one step, a longer one
//     goes through passes 2-4 over the list, and one longer than the list's
//     kListPairs (392) over the row read again from device memory (passes
//     over the keys in registers kept all 64 live and spilled);
//   * its scratch is the 4 copies only (4 KB; the later passes' histogram and
//     the list lie over them), so 16 warps fit an SM: 4 blocks, each with its
//     16-bit weight table, at most 128 registers a thread (ptxas: 116-122,
//     no spills; the 32-bit table leaves room for 3 blocks).  With 12 warps,
//     as K2, it took 5-7 % longer.
//
// The same digits as block_select2, and exact: the keys are elements of the
// row, bit for bit those of the plain sort.  ops/select.py::
// warp_select_emulated repeats the lane layout, the first pass's copies, the
// list, the later passes and the upper middle in numpy; ops/select.py::
// warp_row_walk the rows each warp takes and row_stage_split the staging of
// a row.

#pragma once

#include <map>
#include <mutex>
#include <utility>

#include "select.cuh"

namespace infercnv {

constexpr int kWarpMaxKeys = 64;                       // keys a lane holds
constexpr int kWarpMaxWidth = 32 * kWarpMaxKeys;       // widest row of the warp routine
// the first pass's histogram: kCopies copies, lane l adding to copy l % kCopies;
// the 4 ints between copies put one bin of two copies in two banks
constexpr int kCopies = 4;
constexpr int kCopyStride = kBins + 4;
// ints of a warp's scratch: the first pass's copies, and over them the later
// passes' histogram (kBins) and the list of the keys they read (up to
// kWarpMaxWidth)
constexpr int kWarpScratch = kBins + kWarpMaxWidth;
static_assert(kCopies * kCopyStride <= kWarpScratch, "the first pass's copies overlay the scratch");
// floats of a warp's row stage: a row of up to kWarpMaxWidth values placed as
// far from a 16-byte boundary (0-3 floats) as it lies in device memory
constexpr int kWarpStage = kWarpMaxWidth + 4;
// bytes of shared memory a warp uses: the stage, the select's scratch of
// `scratch` ints and the stage's mbarrier (with 8 bytes of padding)
__host__ __device__ constexpr int warp_smem_bytes(int scratch) { return kWarpStage * 4 + scratch * 4 + 16; }
constexpr int kWarpSmem = warp_smem_bytes(kWarpScratch);
// warps an SM holds: 12 warps' shared memory (204 KB) fits in its 227 KB
constexpr int kWarpsPerSm = 12;
// warps of a block of the warp kernels (at most kWarpsPerSm)
constexpr int kWarpsPerBlock = 4;
constexpr int kWarpThreads = 32 * kWarpsPerBlock;
// the kernels' __launch_bounds__: kWarpsPerSm warps an SM, so at most 170
// registers a thread, whatever the block size
constexpr int kWarpBlocksPerSm = kWarpsPerSm / kWarpsPerBlock > 0 ? kWarpsPerSm / kWarpsPerBlock : 1;
static_assert(kWarpsPerBlock >= 1 && kWarpsPerBlock <= kWarpsPerSm, "a block holds 1 to kWarpsPerSm warps");

// The running sums over the lanes' shares of a histogram (BinScan::c) and
// the lanes' bins before each: scan_bins without the load.
__device__ __forceinline__ void warp_prefix(BinScan& s) {
  const int lane = threadIdx.x & 31;
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
}

// The first pass's histogram, summed over its kCopies copies: lane t gets
// bins 8t .. 8t + 7 (two 16-byte reads a copy).  Called by the whole warp.
__device__ __forceinline__ BinScan scan_copies(const int* h) {
  const int lane = threadIdx.x & 31;
  BinScan s = {{0, 0, 0, 0, 0, 0, 0, 0}, 0, 0};
#pragma unroll
  for (int c = 0; c < kCopies; ++c) {
    const int4 a = reinterpret_cast<const int4*>(h + c * kCopyStride)[2 * lane];
    const int4 b = reinterpret_cast<const int4*>(h + c * kCopyStride)[2 * lane + 1];
    s.c[0] += a.x;
    s.c[1] += a.y;
    s.c[2] += a.z;
    s.c[3] += a.w;
    s.c[4] += b.x;
    s.c[5] += b.y;
    s.c[6] += b.z;
    s.c[7] += b.w;
  }
  warp_prefix(s);
  return s;
}

// Keys of the elements of ranks rank_lo and, when kTwo, rank_hi = rank_lo + 1
// (0-based) of a row of n values whose keys the warp holds: keys[j] of lane l
// is the value j * 32 + l (slots at or past n are ignored).  rank_hi < n <=
// 32 * kKeys.  `scratch`: kWarpScratch ints of shared memory, 16-byte
// aligned, the copies zero.  Called by the whole warp; every lane gets both
// keys (key_hi = key_lo without kTwo).
template <int kKeys, bool kTwo>
__device__ __forceinline__ void warp_select2(const uint32_t (&keys)[kKeys], int n, int rank_lo, int* scratch,
                                             uint32_t* key_lo, uint32_t* key_hi) {
  const int lane = threadIdx.x & 31;
  const int mine = (n - lane + 31) >> 5;  // slots of this lane that hold a value
  // pass 1 (the top digit: every value counts): lane l adds to copy l % 4 of
  // the histogram, so at most 8 lanes share a copy's bin
  int* copy = scratch + (lane % kCopies) * kCopyStride;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    if (j < mine) atomicAdd(copy + (keys[j] >> (32 - kRadixBits)), 1);
  }
  __syncwarp();
  int d_lo, r_lo, d_hi = 0, r_hi;
  {
    const BinScan s = scan_copies(scratch);
    find_bin(s, rank_lo, &d_lo, &r_lo);
    if (kTwo) {
      find_bin(s, rank_lo + 1, &d_hi, &r_hi);
    } else {
      d_hi = d_lo;
    }
  }
  __syncwarp();
  // the later passes' histogram lies over the copies: zero it
  for (int i = lane; i < kBins / 4; i += 32) reinterpret_cast<int4*>(scratch)[i] = make_int4(0, 0, 0, 0);
  __syncwarp();
  // the keys of bins d_lo .. d_hi, into a list in slot-and-lane order (a few
  // dozen in a row of 1,793 values); no key lies in a bin between the two
  // (their ranks are adjacent), so one unsigned compare tests for both
  int* hist = scratch;
  uint32_t* list = reinterpret_cast<uint32_t*>(scratch) + kBins;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t first = static_cast<uint32_t>(d_lo) << (32 - kRadixBits);
  const uint32_t last = (static_cast<uint32_t>(d_hi - d_lo + 1) << (32 - kRadixBits)) - 1u;  // all 256 bins: ~0
  int count = 0;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const bool keep = j < mine && keys[j] - first <= last;
    const unsigned took = __ballot_sync(0xffffffffu, keep);
    if (keep) list[count + __popc(took & below)] = keys[j];
    count += __popc(took);
  }
  __syncwarp();
  // passes 2-4 over the list for rank_lo, with shared atomics on one histogram
  uint32_t pre = first;
  int k = r_lo;
#pragma unroll 1
  for (int p = 1; p < kPasses; ++p) {
    const int shift = 32 - kRadixBits * (p + 1);
    const uint32_t above = 0xFFFFFFFFu << (shift + kRadixBits);
    for (int e = lane; e < count; e += 32) {
      const uint32_t key = list[e];
      if ((key & above) == pre) atomicAdd(hist + static_cast<int>((key >> shift) & (kBins - 1)), 1);
    }
    __syncwarp();
    int d;
    find_bin(scan_bins(hist), k, &d, &k);
    // each lane zeroes the 8 bins it scanned; the next pass adds after the barrier
    reinterpret_cast<int4*>(hist)[2 * lane] = make_int4(0, 0, 0, 0);
    reinterpret_cast<int4*>(hist)[2 * lane + 1] = make_int4(0, 0, 0, 0);
    __syncwarp();
    pre |= static_cast<uint32_t>(d) << shift;
  }
  *key_lo = *key_hi = pre;
  if (kTwo) {
    // rank_lo + 1 holds rank_lo's key again if more than rank_lo + 1 keys of
    // the row are at most that key (the bins before d_lo hold rank_lo - r_lo
    // of them), else the least listed key above it
    int at_most = 0;
    uint32_t above_min = 0xFFFFFFFFu;
    for (int e = lane; e < count; e += 32) {
      const uint32_t key = list[e];
      at_most += key <= pre;
      if (key > pre) above_min = min(above_min, key);
    }
    at_most = __reduce_add_sync(0xffffffffu, at_most) + rank_lo - r_lo;
    above_min = __reduce_min_sync(0xffffffffu, above_min);
    *key_hi = at_most > rank_lo + 1 ? pre : above_min;
  }
}

// ints of a warp's scratch in the weighted select: the first pass's kCopies
// copies, and over them the later passes' histogram (kBins) and a list of
// kListPairs (key, weight) pairs, the keys and then their weights.  Under half
// of the K2 / K5 scratch, so that 16 warps fit an SM (their select waits on
// its own steps, so more warps keep more rows going)
constexpr int kWScratch = kCopies * kCopyStride;
constexpr int kListPairs = (kWScratch - kBins) / 2;
constexpr int kWWarpSmem = warp_smem_bytes(kWScratch);
// blocks of the weighted kernels an SM holds, with a 16-bit weight table
// each: 16 warps, so at most 128 registers a thread
constexpr int kWBlocksPerSm = 4;

// The weights of a lane's slots for the weighted select: slot j of lane l is
// column j * 32 + l.  The weights are the same for every row, so a block
// reads them once, before its warps' first rows, into a table in shared
// memory beside the warps' (kWarpMaxWidth entries of W, 0 past the row):
// 16-bit entries where the weight total fits them (4 KB: 4 blocks of 4 warps
// fit an SM), 32-bit ones otherwise (8 KB: 3 blocks an SM).  A lane reads a
// slot's weight from there where it adds it, 32 lanes on 32 neighbouring
// entries.  The reads are volatile, so the compiler holds no weight (nor a
// test of one) in a register from one row to the next: 64 of them, hoisted
// out of the row loop, took the registers the keys need.
template <typename W>
struct SlotWeights {
  const volatile W* lane_base;  // the table + lane
  __device__ __forceinline__ int operator[](int j) const { return static_cast<int>(lane_base[32 * j]); }
};

// Fill the block's weight table from wts[0, width) (0 past it); return this
// lane's view of it.  Called by every thread of the block, before any warp's
// first row.
template <typename W>
__device__ __forceinline__ SlotWeights<W> block_weight_table(const int* __restrict__ wts, int width) {
  extern __shared__ __align__(16) unsigned char warp_smem[];
  W* table = reinterpret_cast<W*>(warp_smem + kWarpsPerBlock * kWWarpSmem);
  for (int i = threadIdx.x; i < kWarpMaxWidth; i += blockDim.x) {
    table[i] = static_cast<W>(i < width ? __ldg(wts + i) : 0);
  }
  __syncthreads();
  return SlotWeights<W>{table + (threadIdx.x & 31)};
}

// warp_select2 with a weight a slot: the keys of the elements of ranks rank_lo
// and, when kTwo, rank_lo + 1 (0-based) of the row's values each repeated
// wt[j] times (a zero weight drops its value).  rank_lo + kTwo is below the
// weight total, and counts are exact int32: the total fits them.
//   * The first pass adds each slot's weight to copy l % kCopies, the weights
//     read 8 slots at a time.  Lanes that meet on a bin in one add take
//     turns, where the unweighted count's increments are merged by the
//     hardware: most of what this select costs over K2's.
//   * The list keeps the row's keys in bins d_lo .. d_hi with their weights
//     (a key of weight 0 among them adds nothing; no key of weight above 0
//     lies between the two bins).  A list of at most 32 keys is ranked in
//     one step, each lane summing the weight of the keys at most its own; a
//     longer one goes through passes 2-4, adding the weights.
//   * A row of few distinct values can choose more keys than the list holds
//     (kListPairs); its passes then read the row again from device memory
//     (`row`, most of it from L2), with the same keys and sums.  (Passes over
//     the keys in registers instead took 168 registers and spilled, for
//     every row.)
//   * The upper middle of an even total is rank_lo's key again if the weight
//     of the keys at most that key exceeds rank_lo + 1, else the least key of
//     weight above 0 above it.
// `scratch`: kWScratch ints, its first kCopies copies zero.
template <int kKeys, bool kTwo, typename W>
__device__ __forceinline__ void warp_wselect2(const uint32_t (&keys)[kKeys], const SlotWeights<W>& wt, int rank_lo,
                                              const float* __restrict__ row, int width, int* scratch,
                                              uint32_t* key_lo, uint32_t* key_hi) {
  static_assert(kKeys % 8 == 0, "the first pass reads 8 weights at a time");
  const int lane = threadIdx.x & 31;
  const int mine = (width - lane + 31) >> 5;  // slots of this lane that hold a value
  // pass 1: each slot's weight into copy l % kCopies (a slot past the row weighs 0)
  int* copy = scratch + (lane % kCopies) * kCopyStride;
#pragma unroll
  for (int j0 = 0; j0 < kKeys; j0 += 8) {
    int w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = wt[j0 + i];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (w[i] > 0) atomicAdd(copy + (keys[j0 + i] >> (32 - kRadixBits)), w[i]);
    }
  }
  __syncwarp();
  int d_lo, r_lo, d_hi = 0, r_hi;
  {
    const BinScan s = scan_copies(scratch);
    find_bin(s, rank_lo, &d_lo, &r_lo);
    if (kTwo) {
      find_bin(s, rank_lo + 1, &d_hi, &r_hi);
    } else {
      d_hi = d_lo;
    }
  }
  __syncwarp();
  for (int i = lane; i < kBins / 4; i += 32) reinterpret_cast<int4*>(scratch)[i] = make_int4(0, 0, 0, 0);
  __syncwarp();
  int* hist = scratch;
  uint32_t* list_key = reinterpret_cast<uint32_t*>(scratch) + kBins;
  int* list_wt = scratch + kBins + kListPairs;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t first = static_cast<uint32_t>(d_lo) << (32 - kRadixBits);
  const uint32_t last = (static_cast<uint32_t>(d_hi - d_lo + 1) << (32 - kRadixBits)) - 1u;  // all 256 bins: ~0
  int count = 0;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const bool keep = j < mine && keys[j] - first <= last;
    const unsigned took = __ballot_sync(0xffffffffu, keep);
    const int at = count + __popc(took & below);
    if (keep && at < kListPairs) {
      list_key[at] = keys[j];
      list_wt[at] = wt[j];
    }
    count += __popc(took);
  }
  __syncwarp();
  if (count <= 32) {
    // a short list (continuous values: a few keys): lane e takes entry e and
    // sums the weight of the listed keys at most its own; rank_lo's key is
    // the least key whose sum exceeds r_lo (its rank past the bins before
    // d_lo), rank_lo + 1's the least whose sum exceeds r_lo + 1.  (A key of
    // weight 0 whose sum exceeds one has a key of weight above 0 at most it
    // with the same sum, so it never is the least.)
    const uint32_t key = lane < count ? list_key[lane] : 0xFFFFFFFFu;
    int at_most = 0;
    for (int f = 0; f < count; ++f) at_most += list_key[f] <= key ? list_wt[f] : 0;
    *key_lo = __reduce_min_sync(0xffffffffu, at_most > r_lo ? key : 0xFFFFFFFFu);
    *key_hi = kTwo ? __reduce_min_sync(0xffffffffu, at_most > r_lo + 1 ? key : 0xFFFFFFFFu) : *key_lo;
    return;
  }
  const bool listed = count <= kListPairs;  // the same in every lane
  // passes 2-4 for rank_lo: over the list, or where it overflowed over the row read again
  uint32_t pre = first;
  int k = r_lo;
#pragma unroll 1
  for (int pass = 1; pass < kPasses; ++pass) {
    const int shift = 32 - kRadixBits * (pass + 1);
    const uint32_t above = 0xFFFFFFFFu << (shift + kRadixBits);
    if (listed) {
      for (int e = lane; e < count; e += 32) {
        const uint32_t key = list_key[e];
        if ((key & above) == pre) atomicAdd(hist + static_cast<int>((key >> shift) & (kBins - 1)), list_wt[e]);
      }
    } else {
      for (int j = 0; j < mine; ++j) {
        const uint32_t key = radix_key(__ldg(row + j * 32 + lane));
        if ((key & above) == pre) atomicAdd(hist + static_cast<int>((key >> shift) & (kBins - 1)), wt[j]);
      }
    }
    __syncwarp();
    int d;
    find_bin(scan_bins(hist), k, &d, &k);
    reinterpret_cast<int4*>(hist)[2 * lane] = make_int4(0, 0, 0, 0);
    reinterpret_cast<int4*>(hist)[2 * lane + 1] = make_int4(0, 0, 0, 0);
    __syncwarp();
    pre |= static_cast<uint32_t>(d) << shift;
  }
  *key_lo = *key_hi = pre;
  if (kTwo) {
    // the weight of the keys at most `pre` and the least key of weight above
    // 0 above it: from the list, with the bins before d_lo (rank_lo - r_lo);
    // or over the whole row (the least such key above `pre` is a listed one
    // where it is needed: rank_lo + 1 then lies in d_lo or d_hi)
    int at_most = 0;
    uint32_t above_min = 0xFFFFFFFFu;
    auto look = [&](uint32_t key, int w) {
      if (key <= pre) {
        at_most += w;
      } else if (w > 0) {
        above_min = min(above_min, key);
      }
    };
    if (listed) {
      for (int e = lane; e < count; e += 32) look(list_key[e], list_wt[e]);
      at_most += lane == 0 ? rank_lo - r_lo : 0;
    } else {
      for (int j = 0; j < mine; ++j) look(radix_key(__ldg(row + j * 32 + lane)), wt[j]);
    }
    at_most = __reduce_add_sync(0xffffffffu, at_most);
    above_min = __reduce_min_sync(0xffffffffu, above_min);
    *key_hi = at_most > rank_lo + 1 ? pre : above_min;
  }
}

// How a row at `r` is staged: it sits `m` floats past a 16-byte boundary;
// its first `head` values (up to the boundary) and its last width - head -
// body are loaded by lanes, the `body` values between (a multiple of 4,
// 16-byte aligned at both ends) by one bulk copy.  Value i goes to stage[m + i],
// so the body lands on a 16-byte boundary of the stage too.
// ops/select.py::row_stage_split is this function in Python.
__device__ __forceinline__ void row_stage_split(const float* r, int width, int* m, int* head, int* body) {
  *m = static_cast<int>((reinterpret_cast<uintptr_t>(r) >> 2) & 3);
  *head = min((4 - *m) & 3, width);
  *body = (width - *head) & ~3;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Start staging the row at `r`: lane 0 arms the mbarrier with the body's
// bytes and issues the bulk copy; lanes 0-2 load a head value and lanes 4-6 a
// tail value, returned for stage_finish.  Called by the whole warp.
__device__ __forceinline__ float stage_start(const float* r, int width, float* stage, uint32_t bar) {
  const int lane = threadIdx.x & 31;
  int m, head, body;
  row_stage_split(r, width, &m, &head, &body);
  if (lane == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(body * 4) : "memory");
    if (body > 0) {
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                       smem_addr(stage + m + head)),
                   "l"(r + head), "r"(body * 4), "r"(bar)
                   : "memory");
    }
  }
  float v = 0.f;
  if (lane < head) {
    v = __ldg(r + lane);
  } else if (lane >= 4 && lane < 4 + width - head - body) {
    v = __ldg(r + head + body + (lane - 4));
  }
  return v;
}

// Wait for the bulk copy of the phase `parity`, then put the lanes' head and
// tail values (`peel`, from stage_start) beside it.  Called by the whole warp.
__device__ __forceinline__ void stage_finish(const float* r, int width, float* stage, uint32_t bar, uint32_t parity,
                                             float peel) {
  const int lane = threadIdx.x & 31;
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
  int m, head, body;
  row_stage_split(r, width, &m, &head, &body);
  if (lane < head) {
    stage[m + lane] = peel;
  } else if (lane >= 4 && lane < 4 + width - head - body) {
    stage[m + head + body + (lane - 4)] = peel;
  }
  __syncwarp();
}

// Rows of x (rows x width, row-major, any alignment), one warp a row along
// the persistent walk: out[row] = select(keys, scratch, r), where r is the
// row in device memory and keys[j] of lane l is the key of value j * 32 + l
// (slots past the row hold what the stage holds there; the select ignores
// them).  width <= 32 * kKeys.  Dynamic
// shared memory: warp_smem_bytes(Select::kScratch) bytes a warp, the first
// kCopies copies of its scratch zeroed at each row.  A row is staged in
// shared memory by a bulk copy; as soon as its keys are in registers, the
// copy of the warp's next row starts, so it is in flight while this row is
// selected.
template <int kKeys, typename Select>
__device__ __forceinline__ void warp_rows(const float* __restrict__ x, float* __restrict__ out, int rows, int width,
                                          const Select& select) {
  extern __shared__ __align__(16) unsigned char warp_smem[];
  const int lane = threadIdx.x & 31;
  unsigned char* mine = warp_smem + (threadIdx.x >> 5) * warp_smem_bytes(Select::kScratch);
  float* stage = reinterpret_cast<float*>(mine);
  int* scratch = reinterpret_cast<int*>(mine + kWarpStage * 4);
  const uint32_t bar = smem_addr(mine + kWarpStage * 4 + Select::kScratch * 4);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  float peel = row < rows ? stage_start(x + row * width, width, stage, bar) : 0.f;
  for (uint32_t parity = 0; row < rows; row += stride, parity ^= 1u) {
    const float* r = x + row * width;
    stage_finish(r, width, stage, bar, parity, peel);
    int m, head, body;
    row_stage_split(r, width, &m, &head, &body);
    // past the row a slot reads what the stage holds there (at most index
    // m + 32 * kKeys - 1 < kWarpStage); the select ignores it
    uint32_t keys[kKeys];
    const float* mine_stage = stage + m + lane;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) keys[j] = radix_key(mine_stage[32 * j]);
    // the stage's reads come before the next bulk copy's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (row + stride < rows) peel = stage_start(r + stride * width, width, stage, bar);
    // the first pass's histograms start at zero
    for (int i = lane; i < kCopies * kCopyStride / 4; i += 32) reinterpret_cast<int4*>(scratch)[i] = make_int4(0, 0, 0, 0);
    __syncwarp();
    const float v = select(keys, scratch, r);
    if (lane == 0) out[row] = v;
    __syncwarp();  // the select's last reads of `scratch` come before the next row's zeroing
  }
}

// K2 / K5's select of a row: the element of rank k, or with kTwo the mean of
// the elements of ranks k and k + 1 (np.median of an even width).
template <int kKeys, bool kTwo>
struct RankSelect {
  static constexpr int kScratch = kWarpScratch;  // ints of a warp's scratch
  int width, k;
  __device__ __forceinline__ float operator()(const uint32_t (&keys)[kKeys], int* scratch, const float*) const {
    uint32_t lo, hi;
    warp_select2<kKeys, kTwo>(keys, width, k, scratch, &lo, &hi);
    return kTwo ? (radix_key_to_float(lo) + radix_key_to_float(hi)) / 2.0f : radix_key_to_float(lo);
  }
};

template <int kKeys, bool kTwo>
__device__ __forceinline__ void warp_select_rows(const float* __restrict__ x, float* __restrict__ out, int rows,
                                                 int width, int k) {
  warp_rows<kKeys>(x, out, rows, width, RankSelect<kKeys, kTwo>{width, k});
}

// K4's select of a row: np.median(np.repeat(row, weights)), with kTwo for an
// even weight total.
template <int kKeys, bool kTwo, typename W>
struct WeightedMedianSelect {
  static constexpr int kScratch = kWScratch;
  SlotWeights<W> wt;
  int rank_lo, width;
  __device__ __forceinline__ float operator()(const uint32_t (&keys)[kKeys], int* scratch, const float* row) const {
    uint32_t lo, hi;
    warp_wselect2<kKeys, kTwo, W>(keys, wt, rank_lo, row, width, scratch, &lo, &hi);
    return kTwo ? (radix_key_to_float(lo) + radix_key_to_float(hi)) / 2.0f : radix_key_to_float(lo);
  }
};

// total = the sum of wts[0, width) (>= 1); every weight fits W.  Dynamic
// shared memory: kWWarpSmem bytes a warp and kWarpMaxWidth entries of W.
template <int kKeys, bool kTwo, typename W>
__device__ __forceinline__ void warp_weighted_median_rows(const float* __restrict__ x, const int* __restrict__ wts,
                                                          float* __restrict__ out, int rows, int width, int total) {
  const WeightedMedianSelect<kKeys, kTwo, W> select{block_weight_table<W>(wts, width),
                                                    kTwo ? total / 2 - 1 : total / 2, width};
  warp_rows<kKeys>(x, out, rows, width, select);
}

// The persistent grid's size for `kernel` on the current device: as many
// blocks as fit the card at once, each with `smem` bytes of dynamic shared
// memory.  Found once per (kernel, device), with the kernel's shared-memory
// limit raised to what a block needs; later launches read it from a table.
// Returns a cudaError_t.
template <typename Kernel>
int warp_resident_blocks(Kernel kernel, int smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), dev);
  std::lock_guard<std::mutex> hold(mu);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *blocks = hit->second;
    return 0;
  }
  int sms = 0, per_sm = 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarpThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = known[key] = sms * per_sm;
  return 0;
}

// Launch `kernel` on a persistent grid: as many blocks of kWarpsPerBlock
// warps, each with `smem` bytes of dynamic shared memory, as fit the card at
// once, but no more than the rows need.  Returns a cudaError_t.
template <typename Kernel, typename... Args>
int launch_warp_grid(Kernel kernel, int rows, int smem, cudaStream_t stream, Args... args) {
  int resident = 0;
  const int e = warp_resident_blocks(kernel, smem, &resident);
  if (e != 0) return e;
  const long long need = (static_cast<long long>(rows) + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int grid = static_cast<int>(need < resident ? need : resident);
  kernel<<<grid > 0 ? grid : 1, kWarpThreads, static_cast<size_t>(smem), stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// launch_warp_grid for K2 / K5's kernels: kWarpSmem bytes a warp
template <typename Kernel, typename... Args>
int launch_warp_rows(Kernel kernel, int rows, cudaStream_t stream, Args... args) {
  return launch_warp_grid(kernel, rows, kWarpsPerBlock * kWarpSmem, stream, args...);
}

}  // namespace infercnv

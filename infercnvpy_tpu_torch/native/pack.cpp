// Host packers of the infercnv pipeline, in C++ with OpenMP, loaded via ctypes.
//
// The port's own copy of infercnvpy_tpu/native/pack.cpp, with four changes:
// every entry point takes its OpenMP thread count (the Python side passes
// torch's intra-op count, so a process that pins torch to one thread pins
// the packer too); the dense packers zero each output row themselves, so
// they can write into a reused (pinned) buffer instead of a fresh calloc'ed
// one; f64 variants exist of the COO remap and the dense-to-CSR scan; and
// the result pack's host assembly (mask_to_csr) and the reference means
// (reference_sums) are native here, numpy and scipy there.
//
// Stages (reference: tl/_infercnv.py:115-137, 419 — the per-worker densify):
//   pack_csr_*    CSR rows -> dense rows in the plan's packed column layout
//   pack_dense_*  dense rows -> the same packed layout (column remap)
//   coo_remap_*   CSR rows -> compact (cols, vals, counts) for the device
//                 densify, optionally with the values rounded to bfloat16
//   dense_*_csr_* dense result block -> CSR (a counting pass, then a fill)
//   mask_to_csr_* the result pack's word masks and compacted values -> CSR
//                 rows, written into the call's arrays at a row and value
//                 offset (a popcount a row, a prefix sum, then a fill)
//   count_in_columns  the nonzeros of a CSR range that lie in marked columns
//                 (a batch's upload capacity when genes are left out)
//   reference_sums_*  the reference categories' column means, one pass over
//                 the caller's CSR rows (scipy's arithmetic, bit for bit)
//
// Rows are disjoint in every output, so the row loops need no
// synchronisation.  `lut` maps a column of the expression matrix to its
// packed column, -1 for a column no window uses or a gene left out; the
// Python wrappers check every index against it before a call (the scatters
// here are unchecked).

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

template <typename T>
int64_t pack_csr(const int64_t* indptr, const int32_t* indices, const T* data, int64_t n_rows,
                 const int64_t* lut, int64_t out_width, T* out, int32_t n_threads) {
  int64_t kept = 0;
#pragma omp parallel for num_threads(n_threads) schedule(static) reduction(+ : kept)
  for (int64_t r = 0; r < n_rows; ++r) {
    T* row = out + r * out_width;
    std::memset(row, 0, sizeof(T) * out_width);
    for (int64_t j = indptr[r]; j < indptr[r + 1]; ++j) {
      const int64_t c = lut[indices[j]];
      if (c >= 0) {
        row[c] = data[j];
        ++kept;
      }
    }
  }
  return kept;
}

template <typename T>
void pack_dense(const T* src, int64_t n_rows, int64_t n_cols, const int64_t* lut, int64_t out_width, T* out,
                int32_t n_threads) {
#pragma omp parallel for num_threads(n_threads) schedule(static)
  for (int64_t r = 0; r < n_rows; ++r) {
    const T* in_row = src + r * n_cols;
    T* row = out + r * out_width;
    std::memset(row, 0, sizeof(T) * out_width);
    for (int64_t c = 0; c < n_cols; ++c) {
      const int64_t p = lut[c];
      if (p >= 0) row[p] = in_row[c];
    }
  }
}

// Round to nearest even, as ml_dtypes does.  NaN: rounding would carry into
// the exponent (-> Inf) or the sign bit, so every NaN becomes the quiet NaN
// 0x7FC0 with its sign kept (ml_dtypes' canonical NaN).
inline uint16_t f32_to_bf16(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return static_cast<uint16_t>(0x7fc0u | ((u >> 16) & 0x8000u));
  const uint32_t rounding = 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>((u + rounding) >> 16);
}

// cols_is16: write 16-bit column ids (packed width <= 65536) else int32.
// bf16_vals: write the values as bfloat16 bit patterns (from float32) else as T.
// Capacity is checked between the counting and the writing pass: on overflow
// it returns -(kept nnz) having written nothing to cols/vals (counts_out is
// filled), so an overflow never reaches the heap.
template <typename T>
int64_t coo_remap(const int64_t* indptr, const int32_t* indices, const T* data, int64_t n_rows,
                  const int64_t* lut, int64_t cap, int64_t* row_offsets, void* cols_out, int32_t cols_is16,
                  void* vals_out, int32_t bf16_vals, int32_t* counts_out, int32_t n_threads) {
#pragma omp parallel for num_threads(n_threads) schedule(static)
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t kept = 0;
    for (int64_t j = indptr[r]; j < indptr[r + 1]; ++j) kept += (lut[indices[j]] >= 0);
    counts_out[r] = static_cast<int32_t>(kept);
  }
  row_offsets[0] = 0;
  for (int64_t r = 0; r < n_rows; ++r) row_offsets[r + 1] = row_offsets[r] + counts_out[r];
  if (row_offsets[n_rows] > cap) return -row_offsets[n_rows];
#pragma omp parallel for num_threads(n_threads) schedule(static)
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t w = row_offsets[r];
    for (int64_t j = indptr[r]; j < indptr[r + 1]; ++j) {
      const int64_t c = lut[indices[j]];
      if (c < 0) continue;
      if (cols_is16) {
        static_cast<uint16_t*>(cols_out)[w] = static_cast<uint16_t>(c);
      } else {
        static_cast<int32_t*>(cols_out)[w] = static_cast<int32_t>(c);
      }
      if (bf16_vals) {
        static_cast<uint16_t*>(vals_out)[w] = f32_to_bf16(static_cast<float>(data[j]));
      } else {
        static_cast<T*>(vals_out)[w] = data[j];
      }
      ++w;
    }
  }
  return row_offsets[n_rows];
}

template <typename T>
void dense_nnz_rows(const T* src, int64_t n_rows, int64_t n_cols, int64_t* row_nnz, int32_t n_threads) {
#pragma omp parallel for num_threads(n_threads) schedule(static)
  for (int64_t r = 0; r < n_rows; ++r) {
    const T* row = src + r * n_cols;
    int64_t k = 0;
    for (int64_t c = 0; c < n_cols; ++c) k += (row[c] != T(0));
    row_nnz[r] = k;
  }
}

template <typename T>
void dense_fill_csr(const T* src, int64_t n_rows, int64_t n_cols, const int64_t* indptr, int32_t* indices,
                    T* data, int32_t n_threads) {
#pragma omp parallel for num_threads(n_threads) schedule(static)
  for (int64_t r = 0; r < n_rows; ++r) {
    const T* row = src + r * n_cols;
    int64_t w = indptr[r];
    for (int64_t c = 0; c < n_cols; ++c) {
      if (row[c] != T(0)) {
        indices[w] = static_cast<int32_t>(c);
        data[w] = row[c];
        ++w;
      }
    }
  }
}

// Set bits of a word, without a call into libgcc (the build targets no popcnt instruction).
inline int64_t bit_count(uint32_t v) {
  v = v - ((v >> 1) & 0x55555555u);
  v = (v & 0x33333333u) + ((v >> 2) & 0x33333333u);
  return static_cast<int64_t>((((v + (v >> 4)) & 0x0f0f0f0fu) * 0x01010101u) >> 24);
}

// Shard s holds seg_rows[s] rows of n_words mask words (bit k of word j:
// window 32j + k) and seg_nnz[s] values; the shards' rows follow one
// another.  indptr points at the batch's first row in the call's indptr:
// indptr[0] is the value offset, the rows' ends go to indptr[1 ..], and the
// rows' column ids and values to indices / data from indptr[0] on.  Bits at or
// past n_windows are ignored.  Returns the values written; -1 if a shard's
// bits do not count its values, -2 if they would pass cap (the length of
// indices and data): then nothing is written to indices or data.
template <typename T>
int64_t mask_to_csr(const uint64_t* mask_ptrs, const uint64_t* val_ptrs, const int64_t* seg_rows,
                    const int64_t* seg_nnz, int64_t n_seg, int64_t n_words, int64_t n_windows, int64_t cap,
                    int64_t* indptr, int32_t* indices, T* data, int32_t n_threads) {
  const uint32_t tail = (n_windows % 32) ? ((1u << (n_windows % 32)) - 1u) : 0xffffffffu;
  int64_t fault = 0;
#pragma omp parallel num_threads(n_threads)
  {
    int64_t row0 = 0;
    for (int64_t s = 0; s < n_seg; ++s) {
      const uint32_t* mask = reinterpret_cast<const uint32_t*>(mask_ptrs[s]);
#pragma omp for schedule(static) nowait
      for (int64_t r = 0; r < seg_rows[s]; ++r) {
        const uint32_t* w = mask + r * n_words;
        int64_t k = 0;
        for (int64_t j = 0; j + 1 < n_words; ++j) k += bit_count(w[j]);
        if (n_words > 0) k += bit_count(w[n_words - 1] & tail);
        indptr[row0 + r + 1] = k;
      }
      row0 += seg_rows[s];
    }
#pragma omp barrier
#pragma omp single
    {
      int64_t row = 0;
      for (int64_t s = 0; s < n_seg && !fault; ++s) {
        const int64_t first = indptr[row];
        for (int64_t r = 0; r < seg_rows[s]; ++r, ++row) indptr[row + 1] += indptr[row];
        if (indptr[row] - first != seg_nnz[s]) fault = -1;
      }
      if (!fault && indptr[row] > cap) fault = -2;
    }
    if (!fault) {
      row0 = 0;
      for (int64_t s = 0; s < n_seg; ++s) {
        const uint32_t* mask = reinterpret_cast<const uint32_t*>(mask_ptrs[s]);
        const T* vals = reinterpret_cast<const T*>(val_ptrs[s]);
        const int64_t first = indptr[row0];
#pragma omp for schedule(static) nowait
        for (int64_t r = 0; r < seg_rows[s]; ++r) {
          const int64_t lo = indptr[row0 + r];
          std::memcpy(data + lo, vals + (lo - first), sizeof(T) * (indptr[row0 + r + 1] - lo));
          const uint32_t* w = mask + r * n_words;
          int32_t* out = indices + lo;
          for (int64_t j = 0; j < n_words; ++j) {
            uint32_t bits = (j + 1 < n_words) ? w[j] : (w[j] & tail);
            while (bits) {
              *out++ = static_cast<int32_t>(32 * j + __builtin_ctz(bits));
              bits &= bits - 1;
            }
          }
        }
        row0 += seg_rows[s];
      }
    }
  }
  int64_t rows = 0;
  for (int64_t s = 0; s < n_seg; ++s) rows += seg_rows[s];
  return fault ? fault : indptr[rows] - indptr[0];
}

// Slot s's row of out (n_cols wide) gets the sum, over the rows r with
// slot[r] == s in ascending order and their entries in storage order, of
// A(x) * scale[s], in one accumulator of type A a slot and column that starts
// at zero: scipy's (X[rows] * (1.0 / n)).sum(axis=0) for a CSR X, which sums
// through a matrix-vector product in that order (scipy 1.18 first sums a
// row's float entries of one column, so a repeated column id can differ
// there in the last bits).  Integer values are first
// made double and a row's entries of one column summed (scipy's mean converts
// them with astype, which sums duplicates), exact below 2^53.  Reassociating
// would change the bits, so the threads split the slots, never a slot's rows;
// the build keeps x * scale and the add apart (-ffp-contract=off).  A row of
// another slot is not read.  Returns the entries summed; -1 if a row's range
// or a column id that it reads lies out of bounds (then out is undefined).
template <typename T, typename A>
int64_t reference_sums(const int64_t* indptr, const int32_t* indices, const T* data, int64_t nnz, int64_t n_rows,
                       const int32_t* slot, int64_t n_slots, const A* scale, int64_t n_cols, A* out,
                       int32_t n_threads) {
  constexpr bool merge = std::is_integral<T>::value;
  int64_t summed = 0;
  int64_t bad = 0;
#pragma omp parallel num_threads(n_threads) reduction(+ : summed, bad)
  {
    // integer values: a row's sum a column, and the row that last wrote it
    std::vector<A> row_sum(merge ? n_cols : 0);
    std::vector<int64_t> row_of(merge ? n_cols : 0, -1);
    std::vector<int32_t> touched;
#pragma omp for schedule(dynamic, 1)
    for (int64_t s = 0; s < n_slots; ++s) {
      A* acc = out + s * n_cols;
      for (int64_t c = 0; c < n_cols; ++c) acc[c] = A(0);
      const A k = scale[s];
      for (int64_t r = 0; r < n_rows && !bad; ++r) {
        if (slot[r] != s) continue;
        const int64_t lo = indptr[r];
        const int64_t hi = indptr[r + 1];
        if (lo < 0 || lo > hi || hi > nnz) {
          ++bad;
          break;
        }
        for (int64_t j = lo; j < hi; ++j) {
          const int32_t c = indices[j];
          if (c < 0 || c >= n_cols) {
            ++bad;
            break;
          }
          if constexpr (merge) {
            if (row_of[c] != r) {
              row_of[c] = r;
              row_sum[c] = static_cast<A>(data[j]);
              touched.push_back(c);
            } else {
              row_sum[c] += static_cast<A>(data[j]);
            }
          } else {
            acc[c] += static_cast<A>(data[j]) * k;
          }
        }
        if constexpr (merge) {
          for (const int32_t c : touched) acc[c] += row_sum[c] * k;
          touched.clear();
        }
        summed += hi - lo;
      }
    }
  }
  return bad ? -1 : summed;
}

}  // namespace

extern "C" {

int64_t pack_csr_f32(const int64_t* indptr, const int32_t* indices, const float* data, int64_t n_rows,
                     const int64_t* lut, int64_t out_width, float* out, int32_t n_threads) {
  return pack_csr(indptr, indices, data, n_rows, lut, out_width, out, n_threads);
}

int64_t pack_csr_f64(const int64_t* indptr, const int32_t* indices, const double* data, int64_t n_rows,
                     const int64_t* lut, int64_t out_width, double* out, int32_t n_threads) {
  return pack_csr(indptr, indices, data, n_rows, lut, out_width, out, n_threads);
}

void pack_dense_f32(const float* src, int64_t n_rows, int64_t n_cols, const int64_t* lut, int64_t out_width,
                    float* out, int32_t n_threads) {
  pack_dense(src, n_rows, n_cols, lut, out_width, out, n_threads);
}

void pack_dense_f64(const double* src, int64_t n_rows, int64_t n_cols, const int64_t* lut, int64_t out_width,
                    double* out, int32_t n_threads) {
  pack_dense(src, n_rows, n_cols, lut, out_width, out, n_threads);
}

int64_t coo_remap_f32(const int64_t* indptr, const int32_t* indices, const float* data, int64_t n_rows,
                      const int64_t* lut, int64_t cap, int64_t* row_offsets, void* cols_out, int32_t cols_is16,
                      void* vals_out, int32_t bf16_vals, int32_t* counts_out, int32_t n_threads) {
  return coo_remap(indptr, indices, data, n_rows, lut, cap, row_offsets, cols_out, cols_is16, vals_out, bf16_vals,
                   counts_out, n_threads);
}

int64_t coo_remap_f64(const int64_t* indptr, const int32_t* indices, const double* data, int64_t n_rows,
                      const int64_t* lut, int64_t cap, int64_t* row_offsets, void* cols_out, int32_t cols_is16,
                      void* vals_out, int32_t bf16_vals, int32_t* counts_out, int32_t n_threads) {
  return coo_remap(indptr, indices, data, n_rows, lut, cap, row_offsets, cols_out, cols_is16, vals_out, bf16_vals,
                   counts_out, n_threads);
}

void dense_nnz_rows_f32(const float* src, int64_t n_rows, int64_t n_cols, int64_t* row_nnz, int32_t n_threads) {
  dense_nnz_rows(src, n_rows, n_cols, row_nnz, n_threads);
}

void dense_nnz_rows_f64(const double* src, int64_t n_rows, int64_t n_cols, int64_t* row_nnz, int32_t n_threads) {
  dense_nnz_rows(src, n_rows, n_cols, row_nnz, n_threads);
}

void dense_fill_csr_f32(const float* src, int64_t n_rows, int64_t n_cols, const int64_t* indptr, int32_t* indices,
                        float* data, int32_t n_threads) {
  dense_fill_csr(src, n_rows, n_cols, indptr, indices, data, n_threads);
}

void dense_fill_csr_f64(const double* src, int64_t n_rows, int64_t n_cols, const int64_t* indptr, int32_t* indices,
                        double* data, int32_t n_threads) {
  dense_fill_csr(src, n_rows, n_cols, indptr, indices, data, n_threads);
}

int64_t mask_to_csr_f32(const uint64_t* mask_ptrs, const uint64_t* val_ptrs, const int64_t* seg_rows,
                        const int64_t* seg_nnz, int64_t n_seg, int64_t n_words, int64_t n_windows, int64_t cap,
                        int64_t* indptr, int32_t* indices, float* data, int32_t n_threads) {
  return mask_to_csr(mask_ptrs, val_ptrs, seg_rows, seg_nnz, n_seg, n_words, n_windows, cap, indptr, indices, data,
                     n_threads);
}

int64_t mask_to_csr_f64(const uint64_t* mask_ptrs, const uint64_t* val_ptrs, const int64_t* seg_rows,
                        const int64_t* seg_nnz, int64_t n_seg, int64_t n_words, int64_t n_windows, int64_t cap,
                        int64_t* indptr, int32_t* indices, double* data, int32_t n_threads) {
  return mask_to_csr(mask_ptrs, val_ptrs, seg_rows, seg_nnz, n_seg, n_words, n_windows, cap, indptr, indices, data,
                     n_threads);
}

// How many of the n column ids in `indices` lie in a column that `keep`
// marks (nonzero); -1 if any id lies outside [0, n_cols).
int64_t count_in_columns(const int32_t* indices, int64_t n, const uint8_t* keep, int64_t n_cols,
                         int32_t n_threads) {
  int64_t kept = 0;
  int64_t bad = 0;
#pragma omp parallel for num_threads(n_threads) schedule(static) reduction(+ : kept, bad)
  for (int64_t j = 0; j < n; ++j) {
    const int64_t c = indices[j];
    if (c < 0 || c >= n_cols) {
      ++bad;
    } else {
      kept += (keep[c] != 0);
    }
  }
  return bad ? -1 : kept;
}

int64_t reference_sums_f32(const int64_t* indptr, const int32_t* indices, const float* data, int64_t nnz,
                           int64_t n_rows, const int32_t* slot, int64_t n_slots, const float* scale, int64_t n_cols,
                           float* out, int32_t n_threads) {
  return reference_sums(indptr, indices, data, nnz, n_rows, slot, n_slots, scale, n_cols, out, n_threads);
}

// `source` names data's type: 0 float64, 1-4 int8 / int16 / int32 / int64,
// 5-8 uint8 / uint16 / uint32 / uint64; -2 for another code.
int64_t reference_sums_f64(const int64_t* indptr, const int32_t* indices, const void* data, int32_t source,
                           int64_t nnz, int64_t n_rows, const int32_t* slot, int64_t n_slots, const double* scale,
                           int64_t n_cols, double* out, int32_t n_threads) {
#define REFERENCE_SUMS(T)                                                                                   \
  reference_sums(indptr, indices, static_cast<const T*>(data), nnz, n_rows, slot, n_slots, scale, n_cols, out, \
                 n_threads)
  switch (source) {
    case 0: return REFERENCE_SUMS(double);
    case 1: return REFERENCE_SUMS(int8_t);
    case 2: return REFERENCE_SUMS(int16_t);
    case 3: return REFERENCE_SUMS(int32_t);
    case 4: return REFERENCE_SUMS(int64_t);
    case 5: return REFERENCE_SUMS(uint8_t);
    case 6: return REFERENCE_SUMS(uint16_t);
    case 7: return REFERENCE_SUMS(uint32_t);
    case 8: return REFERENCE_SUMS(uint64_t);
    default: return -2;
  }
#undef REFERENCE_SUMS
}

}  // extern "C"

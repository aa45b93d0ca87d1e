// Host packers of the infercnv pipeline, in C++ with OpenMP, loaded via ctypes.
//
// The port's own copy of infercnvpy_tpu/native/pack.cpp, with three changes:
// every entry point takes its OpenMP thread count (the Python side passes
// torch's intra-op count, so a process that pins torch to one thread pins
// the packer too); the dense packers zero each output row themselves, so
// they can write into a reused (pinned) buffer instead of a fresh calloc'ed
// one; and f64 variants exist of the COO remap and the dense-to-CSR scan.
//
// Stages (reference: tl/_infercnv.py:115-137, 419 — the per-worker densify):
//   pack_csr_*    CSR rows -> dense rows in the plan's packed column layout
//   pack_dense_*  dense rows -> the same packed layout (column remap)
//   coo_remap_*   CSR rows -> compact (cols, vals, counts) for the device
//                 densify, optionally with the values rounded to bfloat16
//   dense_*_csr_* dense result block -> CSR (a counting pass, then a fill)
//
// Rows are disjoint in every output, so the row loops need no
// synchronisation.  `lut` maps a masked-gene index to its packed column,
// -1 for an unused gene; the Python wrappers check every index against it
// before a call (the scatters here are unchecked).

#include <cstdint>
#include <cstring>

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

}  // extern "C"

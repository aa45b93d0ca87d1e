// Device-memory write-bandwidth probe for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/probe_write_bw.py::make_writer.kernel: it
// writes an (n, w) float32 matrix from an (n, ld) input, in one of two modes
//   mode 0 "bcast":  out[r, c]          = x[r, 0] * 1.000001f
//   mode 1 "blocks": out[r, 128 q + j]  = x[r, j] * (q + 1)   (q < w / 128, j < 128)
// so that its time is the time to write n * w * 4 bytes.  The Pallas kernel
// swept a VMEM row-tile size; here one block of 256 threads writes one row.
//
// What bounds it on an H100: device-memory writes only (the input is
// n * 512 bytes read once, 0.04 % of the output in "blocks" mode).  Each
// thread issues 16-byte (float4) stores, neighbouring threads at neighbouring
// addresses, so every warp store is four full 128-byte lines; the row's few
// input values are read once into registers ("bcast") or shared memory
// ("blocks").  One f32 multiply per value, as in the plain version, so both
// agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) write_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                               int ld, int w, int mode) {
  __shared__ float4 head[32];  // x[r, 0:128] for "blocks"
  const long long r = blockIdx.x;
  const float* xr = x + r * ld;
  float4* orow = reinterpret_cast<float4*>(out + r * static_cast<long long>(w));
  const int n4 = w / 4;
  if (mode == 0) {
    const float v = __fmul_rn(__ldg(xr), 1.000001f);
    const float4 v4 = make_float4(v, v, v, v);
    for (int i = threadIdx.x; i < n4; i += kThreads) orow[i] = v4;
    return;
  }
  if (threadIdx.x < 32) head[threadIdx.x] = reinterpret_cast<const float4*>(xr)[threadIdx.x];
  __syncthreads();
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float s = static_cast<float>(i / 32 + 1);  // q + 1, with q = 4 i / 128
    const float4 h = head[i % 32];
    orow[i] = make_float4(__fmul_rn(h.x, s), __fmul_rn(h.y, s), __fmul_rn(h.z, s), __fmul_rn(h.w, s));
  }
}

}  // namespace

// x: (n, ld) float32, 16-byte aligned rows (ld % 4 == 0); out: (n, w) float32,
// w % 4 == 0 ("bcast") or w % 128 == 0 and ld >= 128 ("blocks").  The
// wrapper (ops/probe.py) checks these.
extern "C" int write_probe_launch(const void* x, void* out, int n, int ld, int w, int mode, void* stream) {
  write_probe_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                                            static_cast<float*>(out), ld, w, mode);
  return static_cast<int>(cudaGetLastError());
}

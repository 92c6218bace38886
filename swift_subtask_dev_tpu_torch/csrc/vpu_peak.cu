// FP32 throughput probe for Hopper (sm_90a).
//
// Replaces: swift_subtask_dev_tpu's tools/vpu_peak.py:19 kernel (run by
// :33 main), a Pallas TPU kernel that measures the vector unit's f32 rate
// with two multiply-add chains on a VMEM-resident (256, 128) tile.
//
// What it computes: for each element x of the input, a = x, b = x + 1,
// then iters x INNER steps of
//     a = fmaf(a, 1.000001, b);   b = fmaf(b, 0.999999, 1e-7)
// and out = a + b.  Each step is two FMAs (4 FP32 operations).  fmaf
// rounds once where the plain torch version (probes/vpu_peak.py) rounds
// the product and the sum apart, so the two agree to a tolerance.
//
// Launch: each thread keeps PER_THREAD elements in registers (independent
// chains hide the FMA latency); probes/vpu_peak.py sizes the grid to fill
// every SM (the TPU's one-core tile does not fill the card).  No memory
// traffic in the hot loop: it is bound by the FP32 pipes, which is what
// it measures.
//
// Build: as csrc/pair_flat.cu (nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -fmad=false ...; the explicit fmaf is unaffected); bound
// with ctypes; the entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int INNER = 64;        // steps per outer iteration (unrolled)
constexpr int PER_THREAD = 4;

__global__ void __launch_bounds__(LANES)
vpu_peak_kernel(const float* __restrict__ x, float* __restrict__ out,
                int n, int iters) {
  const int stride = gridDim.x * LANES;
  const int i0 = blockIdx.x * LANES + threadIdx.x;
  float a[PER_THREAD], b[PER_THREAD];
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = i0 + e * stride;
    a[e] = i < n ? x[i] : 0.f;
    b[e] = a[e] + 1.f;
  }
  const float ca = (float)1.000001, cb = (float)0.999999, cc = (float)1e-7;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < INNER; ++j) {
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) {
        a[e] = fmaf(a[e], ca, b[e]);
        b[e] = fmaf(b[e], cb, cc);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = i0 + e * stride;
    if (i < n) out[i] = a[e] + b[e];
  }
}

}  // namespace

extern "C" int vpu_peak_fma(const float* x, float* out, int n, int iters,
                            void* stream) {
  if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  const int per_block = LANES * PER_THREAD;
  const int blocks = (n + per_block - 1) / per_block;
  vpu_peak_kernel<<<blocks, LANES, 0, (cudaStream_t)stream>>>(x, out, n,
                                                               iters);
  return (int)cudaGetLastError();
}

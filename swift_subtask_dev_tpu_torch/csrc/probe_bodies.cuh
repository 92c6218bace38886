// Synthetic pair bodies of the flat kernel's cost probe (csrc/pair_flat.cu
// instantiates pair_flat_kernel with them; they are run by
// swift_subtask_dev_tpu_torch/probes/probe_kernel.py).
//
// Replaces: the six pair callbacks of swift_subtask_dev_tpu's
// tools/probe_kernel.py:26 main (A00, A, B, C, D, E at :68-126), which
// time the TPU flat kernel (ops/pallas_flat.py:268) with one sum and no
// max each, to split a pass's cost into the walk, the j-field reads, FP32
// work and transcendentals.  Same formulas and f32 operation order as
// there and as the plain torch callbacks of probes/probe_kernel.py.
//
// Fields: A00 and A take (mask, off0-2, h, m); B-E add x0..x7 (x_k =
// (k + 1) m).  No parameters.  E's pl.reciprocal(approx=True) is
// __fdividef (rcp.approx, <= 2 ulp) and its sqrt is composed from rsqrtf,
// so E is held against the exact plain version with a tolerance.

#pragma once

#include "pair_bodies.cuh"

constexpr int PR_H = 4, PR_M = 5, PR_X0 = 6;

// the pair range of bodies A-E (r2 < R2_CUT), as the flat kernel's warp
// filter bounds it (csrc/pair_bodies.cuh: in_range, lane_reach2,
// row_reach2)
struct ProbeCut {
  static __device__ __forceinline__ bool in_range(
      const float*, const float*, float r2, const BodyParams&) {
    return r2 < FL(0.0036);
  }
  static __device__ __forceinline__ float lane_reach2(const float*,
                                                      const BodyParams&) {
    return FL(0.0036);
  }
  static __device__ __forceinline__ float row_reach2(const float*,
                                                     const BodyParams&) {
    return 0.f;
  }
};

// A00: walk only -- every candidate accepted, r2 summed
struct ProbeA00 {
  static constexpr int F = 6, NS = 1, NM = 0, NP = 0;
  static __device__ __forceinline__ bool in_range(
      const float*, const float*, float r2, const BodyParams&) {
    return r2 > -1.f;
  }
  // every pair is in range: the filter keeps every live row
  static __device__ __forceinline__ float lane_reach2(const float*,
                                                      const BodyParams&) {
    return INFINITY;
  }
  static __device__ __forceinline__ float row_reach2(const float*,
                                                     const BodyParams&) {
    return 0.f;
  }
  static __device__ __forceinline__ bool eval(
      const float*, const float*, float, float, float, float r2,
      const BodyParams&, float* sums, float*) {
    sums[0] = r2;
    return r2 > -1.f;
  }
};

// A: walk + one j field
struct ProbeA : ProbeCut {
  static constexpr int F = 6, NS = 1, NM = 0, NP = 0;
  static __device__ __forceinline__ bool eval(
      const float*, const float* nj, float, float, float, float r2,
      const BodyParams&, float* sums, float*) {
    sums[0] = nj[PR_M];
    return r2 < FL(0.0036);
  }
};

// B: walk + nine j fields, one sum
struct ProbeB : ProbeCut {
  static constexpr int F = 14, NS = 1, NM = 0, NP = 0;
  static __device__ __forceinline__ bool eval(
      const float*, const float* nj, float, float, float, float r2,
      const BodyParams&, float* sums, float*) {
    float acc = nj[PR_M];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = acc + nj[PR_X0 + k];
    sums[0] = acc;
    return r2 < FL(0.0036);
  }
};

// C: B's fields + 56 multiply-adds (two roundings each, as the plain
// version: the library is built with -fmad=false)
struct ProbeC : ProbeCut {
  static constexpr int F = 14, NS = 1, NM = 0, NP = 0;
  static __device__ __forceinline__ bool eval(
      const float* si, const float* nj, float, float, float, float r2,
      const BodyParams&, float* sums, float*) {
    const float acc = nj[PR_M] * si[PR_M];
    float v = r2;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float x = nj[PR_X0 + k];
#pragma unroll
      for (int i = 0; i < 7; ++i) v = v * x + acc;
    }
    sums[0] = v;
    return r2 < FL(0.0036);
  }
};

// D: the fused force pass's transcendental chain per pair: 2 rsqrt, a
// divide, a sqrt and an exp
struct ProbeD : ProbeCut {
  static constexpr int F = 14, NS = 1, NM = 0, NP = 0;
  static __device__ __forceinline__ bool eval(
      const float* si, const float* nj, float, float, float, float r2,
      const BodyParams&, float* sums, float*) {
    const float r_inv = rsqrtf(fmaxf(r2, FL(1e-38)));
    const float r = r2 * r_inv;
    const float a = 1.f / (nj[PR_X0] + si[PR_M] + 3.f);
    const float b = sqrtf(fabsf(nj[PR_X0 + 1] - si[PR_M]) * a);
    const float e = expf(-r2);
    const float r2b = rsqrtf(fmaxf(r2 + 1.f, FL(1e-38)));
    sums[0] = r + a + b + e + r2b;
    return r2 < FL(0.0036);
  }
};

// E: D with an approximate reciprocal and an rsqrt-composed sqrt
struct ProbeE : ProbeCut {
  static constexpr int F = 14, NS = 1, NM = 0, NP = 0;
  static __device__ __forceinline__ bool eval(
      const float* si, const float* nj, float, float, float, float r2,
      const BodyParams&, float* sums, float*) {
    const float r_inv = rsqrtf(fmaxf(r2, FL(1e-38)));
    const float r = r2 * r_inv;
    const float a = __fdividef(1.f, nj[PR_X0] + si[PR_M] + 3.f);
    const float ab = fabsf(nj[PR_X0 + 1] - si[PR_M]) * a;
    const float b = ab * rsqrtf(fmaxf(ab, FL(1e-38)));
    const float e = expf(-r2);
    const float r2b = rsqrtf(fmaxf(r2 + 1.f, FL(1e-38)));
    sums[0] = r + a + b + e + r2b;
    return r2 < FL(0.0036);
  }
};

// Flat (column/z-sorted) pair kernel for Hopper (sm_90a).
//
// Replaces: swift_subtask_dev_tpu/ops/pallas_flat.py:268 pair_apply (the
// Pallas TPU kernel, inner `kernel` at :408) for its six bodies
// (csrc/pair_bodies.cuh): density, gradient, force, force + gravity, P2P
// gravity and the limiter's timebin scan.  The six synthetic bodies of the
// cost probe (csrc/probe_bodies.cuh; tools/probe_kernel.py:26 main of the
// reference) run on the same kernel through their own entries.
//
// What it computes: for each 128-slot i-tile of a z-sorted column and each
// of the 9 neighbour columns, it walks exactly the j-rows named by the
// tile's two packed range words (s | c << 16, unsigned 16-bit fields, in
// granules of `gran` rows; one run, or two when the z-window wraps the
// box), evaluates the body per (i slot, j row), and reduces NS masked sums
// and NM masked maxes per i slot.  Pair mask: mask_j > 0 & r2 > 0 &
// ok_extra.  z wraps with rintf (round half to even, as torch.round).
//
// Launch: grid (TPC, Ncol), 128 threads; thread t owns i slot
// col*W + tile*128 + t and keeps that slot's F fields in registers.  A
// block whose tile is at or past the column's live-tile count returns at
// once (the wrapper zeroes the output, so such tiles read 0).  j-rows are
// staged CHUNK rows x F fields at a time in shared memory (one coalesced
// copy of contiguous AoS rows), then every thread walks the staged rows.
//
// What bounds it: FP32 and SFU pair arithmetic (rsqrt, exp, divides, sqrt
// per pair; ~100-200 flops in the force bodies).  Each staged j-row is
// reused by 128 i-threads, so device-memory bytes are not the limit.
// What the design does about it: nothing yet, deliberately — this is the
// simple, exact first version (no pair symmetry, no tensor cores, no
// warp-level j broadcast, no persistent blocks).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no --use_fast_math: expf, sqrtf
// and divides stay IEEE; no FMA contraction, so every pair expression
// rounds like its torch counterpart).  Bound with ctypes; each entry
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_bodies.cuh"
#include "probe_bodies.cuh"

namespace {

constexpr int LANES = 128;
constexpr int CHUNK = 64;   // staged j-rows per shared-memory fill

// the 9 (dx, dy) column offsets, self first (ops/pair_flat.py OFFSETS_9)
__constant__ int OFF_DX[9] = {0, -1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int OFF_DY[9] = {0, -1, 0, 1, -1, 1, -1, 0, 1};

struct Geometry {
  int ncx, ncy, W, gran;
  float ex, ey, boxz, inv_boxz;
};

template <class Body>
__global__ void __launch_bounds__(LANES)
pair_flat_kernel(const int* __restrict__ tcounts,
                 const int* __restrict__ ranges,
                 const float* __restrict__ Xi,
                 const float* __restrict__ Xa,
                 float* __restrict__ out, Geometry g, BodyParams prm) {
  constexpr int F = Body::F, NS = Body::NS, NM = Body::NM;
  __shared__ float rows_j[CHUNK * F];

  const int tile = blockIdx.x, col = blockIdx.y, t = threadIdx.x;
  if (tile >= tcounts[col]) return;          // dead tile: output stays 0
  const int TPC = gridDim.x;
  const size_t Np = (size_t)gridDim.y * g.W;
  const size_t slot = (size_t)col * g.W + (size_t)tile * LANES + t;

  float si[F];
#pragma unroll
  for (int f = 0; f < F; ++f) si[f] = Xi[(size_t)f * Np + slot];

  float acc[NS > 0 ? NS : 1];
  float mx[NM > 0 ? NM : 1];
#pragma unroll
  for (int q = 0; q < NS; ++q) acc[q] = 0.f;
#pragma unroll
  for (int q = 0; q < NM; ++q) mx[q] = -INFINITY;

  const int ix = col / g.ncy, iy = col % g.ncy;
  const int* words = ranges + ((size_t)col * TPC + tile) * 18;

  for (int o = 0; o < 9; ++o) {
    const int dx = OFF_DX[o], dy = OFF_DY[o];
    const int jcol = ((ix + dx + g.ncx) % g.ncx) * g.ncy
        + (iy + dy + g.ncy) % g.ncy;
    const float sx = (float)dx * g.ex;
    const float sy = (float)dy * g.ey;
    const float* xa = Xa + (size_t)jcol * g.W * F;
    for (int run = 0; run < 2; ++run) {
      const uint32_t w = (uint32_t)words[o * 2 + run];
      const int lo = (int)(w & 0xFFFFu) * g.gran;
      const int hi = lo + (int)(w >> 16) * g.gran;
      for (int r0 = lo; r0 < hi; r0 += CHUNK) {
        const int nr = min(CHUNK, hi - r0);
        __syncthreads();                     // previous rows consumed
        for (int k = t; k < nr * F; k += LANES)
          rows_j[k] = xa[(size_t)r0 * F + k];
        __syncthreads();
        for (int r = 0; r < nr; ++r) {
          const float* nj = rows_j + r * F;
          float dz = si[I_OFF2] - nj[I_OFF2];
          dz = dz - g.boxz * rintf(dz * g.inv_boxz);
          const float dx0 = si[I_OFF0] - (nj[I_OFF0] + sx);
          const float dx1 = si[I_OFF1] - (nj[I_OFF1] + sy);
          const float r2 = dx0 * dx0 + dx1 * dx1 + dz * dz;
          float sums[NS > 0 ? NS : 1];
          float maxes[NM > 0 ? NM : 1];
          const bool ok_extra =
              Body::eval(si, nj, dx0, dx1, dz, r2, prm, sums, maxes);
          const bool ok = (nj[I_MASK] > 0.f) && (r2 > 0.f) && ok_extra;
          if (ok) {
#pragma unroll
            for (int q = 0; q < NS; ++q) acc[q] += sums[q];
#pragma unroll
            for (int q = 0; q < NM; ++q) mx[q] = fmaxf(mx[q], maxes[q]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NS; ++q) out[(size_t)q * Np + slot] = acc[q];
#pragma unroll
  for (int q = 0; q < NM; ++q) out[(size_t)(NS + q) * Np + slot] = mx[q];
}

template <class Body>
int launch(const int* tcounts, const int* ranges, const float* Xi,
           const float* Xa, float* out, int ncx, int ncy, int W, int gran,
           int F, float ex, float ey, float boxz, float inv_boxz,
           const float* params, int n_params, void* stream) {
  if (F != Body::F || n_params != Body::NP || n_params > MAX_PARAMS ||
      W % LANES != 0 || ncx * ncy > 65535)
    return (int)cudaErrorInvalidValue;
  Geometry g{ncx, ncy, W, gran, ex, ey, boxz, inv_boxz};
  BodyParams prm{};
  for (int i = 0; i < n_params; ++i) prm.v[i] = params[i];
  dim3 grid(W / LANES, ncx * ncy);
  pair_flat_kernel<Body><<<grid, LANES, 0, (cudaStream_t)stream>>>(
      tcounts, ranges, Xi, Xa, out, g, prm);
  return (int)cudaGetLastError();
}

}  // namespace

#define PAIR_FLAT_ENTRY(NAME, BODY)                                        \
  extern "C" int pair_flat_##NAME(                                         \
      const int* tcounts, const int* ranges, const float* Xi,              \
      const float* Xa, float* out, int ncx, int ncy, int W, int gran,      \
      int F, float ex, float ey, float boxz, float inv_boxz,               \
      const float* params, int n_params, void* stream) {                   \
    return launch<BODY>(tcounts, ranges, Xi, Xa, out, ncx, ncy, W, gran,   \
                        F, ex, ey, boxz, inv_boxz, params, n_params,       \
                        stream);                                           \
  }

PAIR_FLAT_ENTRY(density, Density)
PAIR_FLAT_ENTRY(gradient, Gradient)
PAIR_FLAT_ENTRY(force, Force)
PAIR_FLAT_ENTRY(force_gravity, ForceGravity)
PAIR_FLAT_ENTRY(p2p_gravity, P2PGravity)
PAIR_FLAT_ENTRY(timebin, Timebin)
PAIR_FLAT_ENTRY(probe_a00, ProbeA00)
PAIR_FLAT_ENTRY(probe_a, ProbeA)
PAIR_FLAT_ENTRY(probe_b, ProbeB)
PAIR_FLAT_ENTRY(probe_c, ProbeC)
PAIR_FLAT_ENTRY(probe_d, ProbeD)
PAIR_FLAT_ENTRY(probe_e, ProbeE)

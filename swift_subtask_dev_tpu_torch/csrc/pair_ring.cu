// Ring-buffer 27-cell pair kernel for Hopper (sm_90a).
//
// Replaces: swift_subtask_dev_tpu/ops/pallas_pairs.py:93 pair_apply (the
// Pallas TPU kernel, inner `kernel` at :160; the `--backend pallas_ring`
// engine) for the density, gradient and force bodies (csrc/pair_bodies.cuh,
// shared unchanged with csrc/pair_flat.cu and csrc/pair_packed.cu).
//
// What it computes: on a periodic 3-d grid of C cells with K slots each,
// for every LIVE slot k (mask > 0) of cell c and each of the 27 stencil
// offsets d in (dx, dy, dz) lexicographic order (ops/pair_ring.py OFFSETS;
// self is index 13), the body is evaluated against every slot of cell
// wrap(ixyz(c) + d) whose mask is > 0.  The separation rounds as the TPU
// kernel rounds it: dx_a = (off_i[a] - off_j[a]) - f32(d_a * edge_a).
// Pair mask: mask_j > 0 & r2 > 0 & ok_extra.  NS masked sums (from 0) and
// NM masked maxes (from -inf) are reduced per live slot: a live slot with
// no accepted pair reads 0 / -inf.  The reference pads the grid by one
// wrapped cell per face; the neighbour id computed with periodic wrap here
// is the same cell for any cdim >= 1.
//
// Contract on the i side (it differs from the TPU kernel, which also
// evaluates the empty slots, with their pad fills): a slot whose mask is 0
// is not evaluated and reads 0 in every output (the wrapper zeroes the
// output).  The loops multiply every output by the mask or merge it only
// into live particles, so they see the reference's values; the plain
// version (ops/pair_ring.py pair_apply_plain) has the same contract.
//
// What it does not rely on: the cells' live counts or any front-packing.
// Every one of a neighbour cell's K slots is examined; a j slot whose mask
// is 0 is skipped before its body is evaluated (exact: the pair mask
// excludes it).  All threads of a block walk the same j row, so the skip
// is block-uniform; a block with no live i slot returns at once.
//
// Launch: grid (C, ceil(K / 128)), 128 threads; thread t owns slot
// c * K + chunk * 128 + t with its F fields in registers.  Each neighbour
// cell's K rows are read in place from an AoS (C * K, F) copy, staged
// CHUNK rows at a time in shared memory (one coalesced copy of contiguous
// rows).  Each block owns its output slots: no atomics, nothing carried
// between blocks.  The TPU kernel's double-buffered DMA ring of padded
// (CB, F, Kp) windows is not built.
//
// What bounds it: FP32 and SFU pair arithmetic (~60-170 operations per
// pair in these bodies) over 27 x (live slots of the neighbour cells)
// candidates for each live slot, as K2.  Device-memory bytes are not the
// limit: each staged j row is reused by 128 threads.  What the design does
// about it: nothing yet, on purpose (the simple, exact first version).
//
// Build: as csrc/pair_flat.cu (nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC, no fast math);
// bound with ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_bodies.cuh"

namespace {

constexpr int LANES = 128;
constexpr int CHUNK = 64;   // staged j rows per shared-memory fill

struct Geometry {
  int ncx, ncy, ncz, K;
  float ex, ey, ez;
};

template <class Body>
__global__ void __launch_bounds__(LANES)
pair_ring_kernel(const float* __restrict__ Xi, const float* __restrict__ Xa,
                 float* __restrict__ out, Geometry g, BodyParams prm) {
  constexpr int F = Body::F, NS = Body::NS, NM = Body::NM;
  __shared__ float rows_j[CHUNK * F];

  const int c = blockIdx.x, t = threadIdx.x;
  const int k = blockIdx.y * LANES + t;
  const size_t Np = (size_t)gridDim.x * g.K;
  const size_t slot = (size_t)c * g.K + k;
  const bool mine = k < g.K && Xi[(size_t)I_MASK * Np + slot] > 0.f;
  if (!__syncthreads_or(mine)) return;       // no live slot: outputs stay 0

  float si[F];
#pragma unroll
  for (int f = 0; f < F; ++f) si[f] = mine ? Xi[(size_t)f * Np + slot] : 0.f;

  float acc[NS > 0 ? NS : 1];
  float mx[NM > 0 ? NM : 1];
#pragma unroll
  for (int q = 0; q < NS; ++q) acc[q] = 0.f;
#pragma unroll
  for (int q = 0; q < NM; ++q) mx[q] = -INFINITY;

  const int iz = c % g.ncz;
  const int iy = (c / g.ncz) % g.ncy;
  const int ix = c / (g.ncz * g.ncy);

  for (int o = 0; o < 27; ++o) {
    const int dx = o / 9 - 1, dy = (o / 3) % 3 - 1, dz = o % 3 - 1;
    const int jc = (((ix + dx + g.ncx) % g.ncx) * g.ncy
                    + (iy + dy + g.ncy) % g.ncy) * g.ncz
        + (iz + dz + g.ncz) % g.ncz;
    const float sx = (float)dx * g.ex;
    const float sy = (float)dy * g.ey;
    const float sz = (float)dz * g.ez;
    const float* xa = Xa + (size_t)jc * g.K * F;
    for (int r0 = 0; r0 < g.K; r0 += CHUNK) {
      const int nr = min(CHUNK, g.K - r0);
      __syncthreads();                       // previous rows consumed
      for (int e = t; e < nr * F; e += LANES)
        rows_j[e] = xa[(size_t)r0 * F + e];
      __syncthreads();
      if (!mine) continue;
      for (int r = 0; r < nr; ++r) {
        const float* nj = rows_j + r * F;
        if (!(nj[I_MASK] > 0.f)) continue;   // same row for every thread
        const float dx0 = (si[I_OFF0] - nj[I_OFF0]) - sx;
        const float dx1 = (si[I_OFF1] - nj[I_OFF1]) - sy;
        const float dx2 = (si[I_OFF2] - nj[I_OFF2]) - sz;
        const float r2 = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
        float sums[NS > 0 ? NS : 1];
        float maxes[NM > 0 ? NM : 1];
        const bool ok_extra =
            Body::eval(si, nj, dx0, dx1, dx2, r2, prm, sums, maxes);
        if ((r2 > 0.f) && ok_extra) {
#pragma unroll
          for (int q = 0; q < NS; ++q) acc[q] += sums[q];
#pragma unroll
          for (int q = 0; q < NM; ++q) mx[q] = fmaxf(mx[q], maxes[q]);
        }
      }
    }
  }
  if (!mine) return;
#pragma unroll
  for (int q = 0; q < NS; ++q) out[(size_t)q * Np + slot] = acc[q];
#pragma unroll
  for (int q = 0; q < NM; ++q) out[(size_t)(NS + q) * Np + slot] = mx[q];
}

template <class Body>
int launch(const float* Xi, const float* Xa, float* out, int ncx, int ncy,
           int ncz, int K, int F, float ex, float ey, float ez,
           const float* params, int n_params, void* stream) {
  if (F != Body::F || n_params != Body::NP || n_params > MAX_PARAMS ||
      ncx < 1 || ncy < 1 || ncz < 1 || K <= 0 || (K + LANES - 1) / LANES
      > 65535)
    return (int)cudaErrorInvalidValue;
  Geometry g{ncx, ncy, ncz, K, ex, ey, ez};
  BodyParams prm{};
  for (int i = 0; i < n_params; ++i) prm.v[i] = params[i];
  dim3 grid(ncx * ncy * ncz, (K + LANES - 1) / LANES);
  pair_ring_kernel<Body><<<grid, LANES, 0, (cudaStream_t)stream>>>(
      Xi, Xa, out, g, prm);
  return (int)cudaGetLastError();
}

}  // namespace

#define PAIR_RING_ENTRY(NAME, BODY)                                        \
  extern "C" int pair_ring_##NAME(                                         \
      const float* Xi, const float* Xa, float* out, int ncx, int ncy,      \
      int ncz, int K, int F, float ex, float ey, float ez,                 \
      const float* params, int n_params, void* stream) {                   \
    return launch<BODY>(Xi, Xa, out, ncx, ncy, ncz, K, F, ex, ey, ez,      \
                        params, n_params, stream);                         \
  }

PAIR_RING_ENTRY(density, Density)
PAIR_RING_ENTRY(gradient, Gradient)
PAIR_RING_ENTRY(force, Force)

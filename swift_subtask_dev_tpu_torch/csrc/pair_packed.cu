// Packed 27-cell pair kernel for Hopper (sm_90a).
//
// Replaces: swift_subtask_dev_tpu/ops/pallas_packed.py:48 pair_apply (the
// Pallas TPU kernel, inner `kernel` at :127) for the density, gradient and
// force bodies (csrc/pair_bodies.cuh, shared unchanged with the flat
// kernel csrc/pair_flat.cu).
//
// What it computes: on a periodic 3-d grid of C cells with K slots each,
// for i slot k of cell c and each stencil offset d (STENCIL_27 order, self
// first), the body is evaluated against the j slots of cell
// linear_cell_of(ixyz(c) + d), with the stencil shift folded into the j
// offsets: dx_a = off_i[a] - (off_j[a] + f32(d_a * edge_a)) on all three
// axes (no rint wrap: the shift alone makes the image right).  Pair mask:
// mask_j > 0 & r2 > 0 & ok_extra.  NS masked sums (from 0) and NM masked
// maxes (from -inf) are reduced per i slot.  An i slot whose 8-slot block
// starts at or past its cell's live count (8 * floor(k / 8) >= count_c)
// is skipped: its outputs stay 0 (the wrapper zeroes them).  Slots inside
// a live 8-block but past count_c are evaluated like any other slot.
//
// Invariant it relies on: the bucketing front-packs every cell's live
// particles (grid/cellgrid.py bucket_fields, rebucket_offsets), so every
// slot at or past count_j has mask 0.  Walking only [0, count_j) of each
// neighbour cell is therefore exact; the plain version
// (ops/pair_packed.py pair_apply_plain) checks the invariant.
//
// Launch: grid (C, ceil(K / 128)), 128 threads; thread t owns slot
// c * K + chunk * 128 + t with its F fields in registers.  A block whose
// first slot is at or past count_c returns at once.  The live j rows of
// each neighbour cell are read in place from an AoS (C * K, F) copy,
// staged CHUNK rows at a time in shared memory (one coalesced copy of
// contiguous rows), and every thread walks the staged rows.  Each block
// owns its output slots: no atomics, nothing carried between blocks.
// The TPU kernel's 27x rolled j buffer (it fills 128-lane tiles) is not
// built.
//
// What bounds it: FP32 and SFU pair arithmetic (rsqrt, divides, per pair;
// ~80-200 operations in these bodies) over the ~27 x count candidates of
// each i slot.  Device-memory bytes are not the limit: each staged j row
// is reused by 128 threads.  What the design does about it: nothing yet,
// on purpose: no pair symmetry, no sub-cell culling of the 27 candidate
// cells, one thread per i slot even when a cell holds far fewer than 128
// live slots.
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

// ops/stencil.py STENCIL_27: self first, then dx, dy, dz in (-1, 0, 1)
__constant__ signed char ST_DX[27] = {
    0, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, 0, 0,
    0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1};
__constant__ signed char ST_DY[27] = {
    0, -1, -1, -1, 0, 0, 0, 1, 1, 1, -1, -1, -1, 0,
    0, 1, 1, 1, -1, -1, -1, 0, 0, 0, 1, 1, 1};
__constant__ signed char ST_DZ[27] = {
    0, -1, 0, 1, -1, 0, 1, -1, 0, 1, -1, 0, 1, -1,
    1, -1, 0, 1, -1, 0, 1, -1, 0, 1, -1, 0, 1};

struct Geometry {
  int ncx, ncy, ncz, K;
  float ex, ey, ez;
};

template <class Body>
__global__ void __launch_bounds__(LANES)
pair_packed_kernel(const int* __restrict__ counts,
                   const float* __restrict__ Xi,
                   const float* __restrict__ Xa,
                   float* __restrict__ out, Geometry g, BodyParams prm) {
  constexpr int F = Body::F, NS = Body::NS, NM = Body::NM;
  __shared__ float rows_j[CHUNK * F];

  const int c = blockIdx.x, t = threadIdx.x;
  const int k0 = blockIdx.y * LANES;
  const int count_c = counts[c];
  if (k0 >= count_c) return;                 // every 8-block skipped
  const int k = k0 + t;
  const bool live = k < g.K && (k & ~7) < count_c;
  const size_t Np = (size_t)gridDim.x * g.K;
  const size_t slot = (size_t)c * g.K + k;

  float si[F];
#pragma unroll
  for (int f = 0; f < F; ++f) si[f] = live ? Xi[(size_t)f * Np + slot] : 0.f;

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
    const int dx = ST_DX[o], dy = ST_DY[o], dz = ST_DZ[o];
    const int jc = (((ix + dx + g.ncx) % g.ncx) * g.ncy
                    + (iy + dy + g.ncy) % g.ncy) * g.ncz
        + (iz + dz + g.ncz) % g.ncz;
    const float sx = (float)dx * g.ex;
    const float sy = (float)dy * g.ey;
    const float sz = (float)dz * g.ez;
    const float* xa = Xa + (size_t)jc * g.K * F;
    const int n_j = counts[jc];
    for (int r0 = 0; r0 < n_j; r0 += CHUNK) {
      const int nr = min(CHUNK, n_j - r0);
      __syncthreads();                       // previous rows consumed
      for (int e = t; e < nr * F; e += LANES)
        rows_j[e] = xa[(size_t)r0 * F + e];
      __syncthreads();
      if (!live) continue;
      for (int r = 0; r < nr; ++r) {
        const float* nj = rows_j + r * F;
        const float dx0 = si[I_OFF0] - (nj[I_OFF0] + sx);
        const float dx1 = si[I_OFF1] - (nj[I_OFF1] + sy);
        const float dx2 = si[I_OFF2] - (nj[I_OFF2] + sz);
        const float r2 = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
        float sums[NS > 0 ? NS : 1];
        float maxes[NM > 0 ? NM : 1];
        const bool ok_extra =
            Body::eval(si, nj, dx0, dx1, dx2, r2, prm, sums, maxes);
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
  if (!live) return;
#pragma unroll
  for (int q = 0; q < NS; ++q) out[(size_t)q * Np + slot] = acc[q];
#pragma unroll
  for (int q = 0; q < NM; ++q) out[(size_t)(NS + q) * Np + slot] = mx[q];
}

template <class Body>
int launch(const int* counts, const float* Xi, const float* Xa, float* out,
           int ncx, int ncy, int ncz, int K, int F, float ex, float ey,
           float ez, const float* params, int n_params, void* stream) {
  if (F != Body::F || n_params != Body::NP || n_params > MAX_PARAMS ||
      ncx < 3 || ncy < 3 || ncz < 3 || K <= 0)
    return (int)cudaErrorInvalidValue;
  Geometry g{ncx, ncy, ncz, K, ex, ey, ez};
  BodyParams prm{};
  for (int i = 0; i < n_params; ++i) prm.v[i] = params[i];
  dim3 grid(ncx * ncy * ncz, (K + LANES - 1) / LANES);
  pair_packed_kernel<Body><<<grid, LANES, 0, (cudaStream_t)stream>>>(
      counts, Xi, Xa, out, g, prm);
  return (int)cudaGetLastError();
}

}  // namespace

#define PAIR_PACKED_ENTRY(NAME, BODY)                                      \
  extern "C" int pair_packed_##NAME(                                       \
      const int* counts, const float* Xi, const float* Xa, float* out,     \
      int ncx, int ncy, int ncz, int K, int F, float ex, float ey,         \
      float ez, const float* params, int n_params, void* stream) {         \
    return launch<BODY>(counts, Xi, Xa, out, ncx, ncy, ncz, K, F, ex, ey,  \
                        ez, params, n_params, stream);                     \
  }

PAIR_PACKED_ENTRY(density, Density)
PAIR_PACKED_ENTRY(gradient, Gradient)
PAIR_PACKED_ENTRY(force, Force)

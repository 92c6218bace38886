// Packed 27-cell pair kernel K2 for Hopper (sm_90a).
//
// Replaces: swift_subtask_dev_tpu/ops/pallas_packed.py:48 pair_apply (the
// Pallas TPU kernel, inner `kernel` at :127; the `backend="pallas"`
// engine) for the density, gradient and force bodies (csrc/pair_bodies.cuh,
// shared unchanged with csrc/pair_flat.cu and csrc/pair_ring.cu).
//
// What it computes: the 27-cell walk of csrc/walk27.cuh in STENCIL_27
// order (ops/stencil.py: self first, then dx, dy, dz in (-1, 0, 1)), with
// the stencil shift folded into the j offsets as the TPU kernel folds it:
// dx_a = off_i[a] - (off_j[a] + f32(d_a * edge_a)) on all three axes (no
// rint wrap: the shift alone makes the image right).
//
// Invariant it relies on: the bucketing front-packs every cell's live
// particles (grid/cellgrid.py bucket_fields, rebucket_offsets), so the
// rows [0, count_j) of each cell are its live ones and the fields as they
// lie are the walk's j side; the plain version (ops/pair_packed.py
// pair_apply_plain) checks the invariant.
//
// Contract on the i side (it differs from the TPU kernel, which evaluates
// every slot of an 8-slot block that starts below the cell's count, with
// the pad fills of its empty slots): only walked slots (live, and active
// when the caller passes a subset) are evaluated; every other slot reads
// 0.  The loops multiply by the mask or merge only into live (active)
// particles, so their results are the reference's.
//
// What bounds it, and the design: csrc/walk27.cuh.
//
// Build: as csrc/pair_flat.cu (nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC, no fast math);
// bound with ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk27.cuh"

namespace {

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

struct PackedStencil {
  static constexpr int MIN_CDIM = 3;
  static __device__ __forceinline__ void offset(int o, int& dx, int& dy,
                                                int& dz) {
    dx = ST_DX[o];
    dy = ST_DY[o];
    dz = ST_DZ[o];
  }
  static __device__ __forceinline__ float sep(float a, float b, float s) {
    return a - (b + s);
  }
};

}  // namespace

WALK27_ENTRY(pair_packed, PackedStencil, density, Density)
WALK27_ENTRY(pair_packed, PackedStencil, gradient, Gradient)
WALK27_ENTRY(pair_packed, PackedStencil, force, Force)

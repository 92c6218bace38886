// Ring-buffer 27-cell pair kernel K3 for Hopper (sm_90a).
//
// Replaces: swift_subtask_dev_tpu/ops/pallas_pairs.py:93 pair_apply (the
// Pallas TPU kernel, inner `kernel` at :160; the `--backend pallas_ring`
// engine) for the density, gradient and force bodies (csrc/pair_bodies.cuh,
// shared unchanged with csrc/pair_flat.cu and csrc/pair_packed.cu).
//
// What it computes: the 27-cell walk of csrc/walk27.cuh in the TPU
// kernel's order, (dx, dy, dz) lexicographic (ops/pair_ring.py OFFSETS;
// self is index 13), with the separation rounded as the TPU kernel rounds
// it: dx_a = (off_i[a] - off_j[a]) - f32(d_a * edge_a).  The reference
// pads the grid by one wrapped cell per face; the neighbour found by
// periodic wrap here is the same cell for any cdim >= 1.
//
// What it does not rely on: the cells' live counts or any front-packing.
// ops/pair_ring.py prepare builds the walk's j side: each cell's live rows
// (mask > 0), wherever they sit, copied in slot order to the front of the
// cell, with their count; the dead slots are neither staged nor tested.
//
// Contract on the i side (it differs from the TPU kernel, which also
// evaluates the empty slots, with their pad fills): only walked slots
// (live, and active when the caller passes a subset) are evaluated; every
// other slot reads 0.  The loops multiply by the mask or merge only into
// live (active) particles, so their results are the reference's.
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

struct RingStencil {
  static constexpr int MIN_CDIM = 1;
  static __device__ __forceinline__ void offset(int o, int& dx, int& dy,
                                                int& dz) {
    dx = o / 9 - 1;
    dy = (o / 3) % 3 - 1;
    dz = o % 3 - 1;
  }
  static __device__ __forceinline__ float sep(float a, float b, float s) {
    return (a - b) - s;
  }
};

}  // namespace

WALK27_ENTRY(pair_ring, RingStencil, density, Density)
WALK27_ENTRY(pair_ring, RingStencil, gradient, Gradient)
WALK27_ENTRY(pair_ring, RingStencil, force, Force)

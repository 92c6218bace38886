// The walk of the 27-cell pair kernels for Hopper (sm_90a), shared by the
// packed kernel K2 (csrc/pair_packed.cu) and the ring-buffer kernel K3
// (csrc/pair_ring.cu).  Each instantiates it with a Stencil, the one
// thing in which the two differ: the order of the 27 offsets and how the
// separation rounds (K2: off_i - (off_j + shift), STENCIL_27 order, self
// first; K3: (off_i - off_j) - shift, lexicographic order, self at 13).
//
// What it computes: on a periodic 3-d grid of C cells with K slots each,
// for every walked i slot of a cell (live, and active when the caller
// passes a subset) and each stencil offset d in the Stencil's order, the
// body on the rows [0, count_j) of cell j = wrap(ixyz(c) + d) of the j-side
// AoS copy Xa (KJ rows a cell, KJ >= K a multiple of 4): each cell's live
// rows first, in slot order (K2's cells are front-packed, so Xa is the
// fields as they lie; ops/pair_ring.py prepare compacts K3's).  The shift
// is f32(d_a * edge_a), applied when a row is tested or evaluated.  Pair
// mask: mask_j > 0 & r2 > 0 & in_range (the body's ok_extra).  Per walked
// slot NS sums (from 0) and NM maxes (from -inf): a walked slot with no
// accepted pair reads 0 / -inf; every slot that is not walked reads 0 in
// every output (the wrapper zeroes the output).
//
// What bounds it: the TPU kernels evaluate the body for every (i slot, j
// row) of the 27 cells and mask afterwards: at Sedov's 16^3 cells and ~65
// live slots a cell, ~1,750 candidate rows per slot for ~48 neighbours,
// so ~97% of their FP32 and SFU work (60-200 operations a pair: rsqrt,
// exp, divides) is discarded, on every slot, active or not.  This walk
// evaluates a body only on the pairs it accepts, of the slots that need
// an answer; what bounds it is the walk (the filter, the kept rows'
// tests, waits on the staging ring) and the rounds' lane utilisation.
// The design, K1's walk (csrc/pair_flat.cu) on the 27-cell stencil:
//
// 1. Warps.  The wrapper packs each cell's walked slots 32 to a warp, in
//    slot order (`wslot`: the slot of each lane, -1 past the cell's last),
//    and the warps of a cell into blocks of at most MAX_WARPS (`blocks`:
//    cell, first warp, warps).  A launch has WPB i-slot warps a block and
//    a producer warp; the wrapper picks WPB to use the fewest warp slots
//    (idle ones and producers included): with ~65 walked slots a cell, 2
//    or 3; when a cell has a few active slots, 1.  A cell with no walked
//    slot costs nothing; a warp of a cell's last block with no slot exits
//    at once.
// 2. Staging.  The block's 27 stencil cells' rows are contiguous AoS
//    spans of Xa, cut into CH-row chunks.  The producer keeps up to
//    STAGES of them in flight into a ring of shared-memory buffers with
//    1-D bulk copies, each completing on its stage's "full" mbarrier
//    (a chunk's copy is rounded up to 4 rows: 16-byte sizes); each i-slot
//    warp arrives on the stage's "empty" mbarrier once it has scanned it,
//    and the producer refills a stage when all have.
// 3. Warp filter.  Each warp bounds its walked slots by a box (x, y, z)
//    and a reach (the body's lane_reach2, maxed over the warp).  A lane
//    tests one staged row in 32 (mask_j, the body's row_reach2, the row's
//    distance to the box with the cell's shift) and a ballot keeps the
//    rows that some slot of the warp may accept, with csrc/walk.cuh's
//    slack (here x (ex + ey + ez)): no accepted pair is dropped.
// 4. Per-lane compaction.  For each 32-row group with a kept row, every
//    lane tests the kept rows (separation, r2 and in_range; eight at a
//    time) into a word of the rows it accepts.  The rows that some lane
//    accepts are copied in order into the warp's window in shared memory,
//    each with its cell's stencil code in the spare column F, and each
//    lane's bits go to their window rows.  When a group would overflow
//    the window, or the walk ends, the warp runs rounds: each lane pops
//    its lowest set bit and evaluates the body on that row.  So each lane
//    sums its pairs in stencil-then-slot order, the plain version's: no
//    atomics, no cross-lane reduction, the same bits from run to run, and
//    which lane owns a slot changes no bits.
//
// Each body has two instantiations: the production one, and one that
// writes per-warp statistics to `stats` (a launch with a non-null
// pointer): the rows staged and kept (accepted by some slot of the warp),
// the rounds and pairs (lane utilisation: pairs over 32 x rounds), and
// clock64 cycles spent waiting for staged rows, in rounds and in the
// whole walk.  Without statistics no counter is kept and no clock read.

#pragma once

#include <limits.h>

#include "pair_bodies.cuh"
#include "walk.cuh"

namespace walk27 {

constexpr int MAX_WARPS = 4;     // i-slot warps per block at most
constexpr int CH = 32;           // j rows per staged chunk
constexpr int STAGES = 4;        // chunks in flight
// per-warp statistics: rows staged, kept, rounds, pairs; then clock64
// cycles waiting for staged chunks, in rounds, and in the whole walk
constexpr int NSTAT = 7;

struct Geometry {
  int ncx, ncy, ncz, K, KJ;
  float ex, ey, ez;
};

// a body's walk: WIN kept rows per warp window, rows of FW = F + 1
// floats (the spare column holds the row's stencil code; an odd stride
// spreads the banks), and the block's dynamic shared memory for `warps`
// i-slot warps: STAGES chunk buffers, then one window per warp.  Small
// chunks and windows keep more blocks on an SM, which the walk's
// latency-bound scan needs more than the fuller rounds of a larger window
// (PERF.md §6)
template <int F>
struct Walk {
  static_assert(F % 2 == 0, "a window row keeps its stencil code in an "
                "odd column F");
  static constexpr int WIN = 128;
  static constexpr int FW = F + 1;
  static constexpr int STAGE = CH * F;
  static constexpr size_t bytes(int warps) {
    return (size_t)(STAGES * STAGE + warps * WIN * FW) * sizeof(float);
  }
};

// the shift of stencil code 9 (dx + 1) + 3 (dy + 1) + (dz + 1)
__device__ __forceinline__ void shift_of(int code, const Geometry& g,
                                         float& sx, float& sy, float& sz) {
  sx = (float)(code / 9 - 1) * g.ex;
  sy = (float)((code / 3) % 3 - 1) * g.ey;
  sz = (float)(code % 3 - 1) * g.ez;
}

// separation and r2 of slot si and row nj of the cell shifted by (sx, sy,
// sz), rounded as the Stencil rounds it
template <class Stencil>
__device__ __forceinline__ float sep_r2(const float* si, const float* nj,
                                        float sx, float sy, float sz,
                                        float& dx0, float& dx1,
                                        float& dx2) {
  dx0 = Stencil::sep(si[I_OFF0], nj[I_OFF0], sx);
  dx1 = Stencil::sep(si[I_OFF1], nj[I_OFF1], sy);
  dx2 = Stencil::sep(si[I_OFF2], nj[I_OFF2], sz);
  return dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
}

// rounds over a warp's window: each lane evaluates the body on its kept
// rows (its set bits), lowest first, one per round
template <class Stencil, class Body, class Bits>
__device__ __forceinline__ void run_rounds(
    const float* si, const float* win, Bits& bits, float* acc, float* mx,
    const Geometry& g, const BodyParams& prm, int& rounds, int& pairs) {
  constexpr int F = Body::F, NS = Body::NS, NM = Body::NM;
  constexpr int FW = Walk<F>::FW;
  __syncwarp();                       // the window rows are written
  for (;;) {
    const int idx = bits.pop();       // this lane's lowest kept row
    if (!__any_sync(FULL, idx >= 0)) break;
    ++rounds;
    if (idx >= 0) {
      const float* nj = win + idx * FW;
      float sx, sy, sz, dx0, dx1, dx2;
      shift_of(__float_as_int(nj[F]), g, sx, sy, sz);
      const float r2 = sep_r2<Stencil>(si, nj, sx, sy, sz, dx0, dx1, dx2);
      float sums[NS > 0 ? NS : 1];
      float maxes[NM > 0 ? NM : 1];
      Body::eval(si, nj, dx0, dx1, dx2, r2, prm, sums, maxes);
#pragma unroll
      for (int q = 0; q < NS; ++q) acc[q] += sums[q];
#pragma unroll
      for (int q = 0; q < NM; ++q) mx[q] = fmaxf(mx[q], maxes[q]);
      ++pairs;
    }
  }
  __syncwarp();                       // the window may be refilled
}

// position in the block's chunk list: stencil cell s, first row r0; done
// when s == 27
struct Cursor {
  int s, r0;
  __device__ __forceinline__ void settle(const int* cnt) {
    while (s < 27 && r0 >= cnt[s]) {
      ++s;
      r0 = 0;
    }
  }
  __device__ __forceinline__ void start(const int* cnt) {
    s = 0;
    r0 = 0;
    settle(cnt);
  }
  __device__ __forceinline__ void next(const int* cnt) {
    r0 += CH;
    settle(cnt);
  }
  __device__ __forceinline__ bool done() const { return s >= 27; }
};

template <class Stencil, class Body, bool STATS>
__global__ void __launch_bounds__((MAX_WARPS + 1) * 32)
walk27_kernel(const int* __restrict__ blocks, const int* __restrict__ wslot,
              const int* __restrict__ counts, const float* __restrict__ Xi,
              const float* __restrict__ Xa, float* __restrict__ out,
              int* __restrict__ stats, Geometry g, BodyParams prm) {
  constexpr int F = Body::F, NS = Body::NS, NM = Body::NM;
  constexpr int WIN = Walk<F>::WIN, FW = Walk<F>::FW;
  constexpr int STAGE = Walk<F>::STAGE;
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ int span_cell[27], span_cnt[27], span_code[27];
  // per warp: a group's kept rows, and those some lane accepts
  __shared__ int kept_rows[MAX_WARPS * 32], used_rows[MAX_WARPS * 32];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wpb = blockDim.x / 32 - 1;      // i-slot warps of a block
  const int cell = blocks[3 * blockIdx.x];
  const int w0 = blocks[3 * blockIdx.x + 1];
  const int nw = blocks[3 * blockIdx.x + 2];   // of them with slots
  const bool producer = warp == wpb;
  const size_t Np = (size_t)g.ncx * g.ncy * g.ncz * g.K;

  if (t < 27) {
    int dx, dy, dz;
    Stencil::offset(t, dx, dy, dz);
    const int iz = cell % g.ncz;
    const int iy = (cell / g.ncz) % g.ncy;
    const int ix = cell / (g.ncz * g.ncy);
    const int jc = (((ix + dx + g.ncx) % g.ncx) * g.ncy
                    + (iy + dy + g.ncy) % g.ncy) * g.ncz
        + (iz + dz + g.ncz) % g.ncz;
    span_cell[t] = jc;
    span_cnt[t] = counts[jc];
    span_code[t] = 9 * (dx + 1) + 3 * (dy + 1) + (dz + 1);
  }
  if (t == 32) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], nw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (!producer && warp >= nw) return;      // no slot: the last block's

  if (producer) {
    // keep STAGES chunks in flight, each once every i-slot warp is done
    // with the chunk STAGES before it in the same buffer
    if (lane == 0) {
      Cursor pc;
      pc.start(span_cnt);
      for (int k = 0; !pc.done(); ++k, pc.next(span_cnt)) {
        const int st = k % STAGES;
        if (k >= STAGES) mbar_wait(&empty_bar[st], ((k / STAGES) + 1) & 1);
        const int nr = min(CH, span_cnt[pc.s] - pc.r0);
        const uint32_t bytes = (uint32_t)(((nr + 3) & ~3) * F * sizeof(float));
        mbar_arrive_tx(&full_bar[st], bytes);
        bulk_load(smem + st * STAGE,
                  Xa + ((size_t)span_cell[pc.s] * g.KJ + pc.r0) * F, bytes,
                  &full_bar[st]);
      }
    }
    return;
  }

  const int gw = w0 + warp;                 // the warp's number
  const int slot = wslot[(size_t)gw * 32 + lane];
  const bool own = slot >= 0;
  float si[F];
#pragma unroll
  for (int f = 0; f < F; ++f) si[f] = own ? Xi[(size_t)f * Np + slot] : 0.f;
  float acc[NS > 0 ? NS : 1];
  float mx[NM > 0 ? NM : 1];
#pragma unroll
  for (int q = 0; q < NS; ++q) acc[q] = 0.f;
#pragma unroll
  for (int q = 0; q < NM; ++q) mx[q] = -INFINITY;
  int n_staged = 0, n_kept = 0, rounds = 0, pairs = 0;
  long long c_wait = 0, c_rounds = 0;
  const long long c_start = stamp<STATS>();

  // the warp's box and reach over its walked slots
  const float inf = INFINITY;
  float xlo = own ? si[I_OFF0] : inf, xhi = own ? si[I_OFF0] : -inf;
  float ylo = own ? si[I_OFF1] : inf, yhi = own ? si[I_OFF1] : -inf;
  float zlo = own ? si[I_OFF2] : inf, zhi = own ? si[I_OFF2] : -inf;
  float lr2 = own ? Body::lane_reach2(si, prm) : -inf;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    xlo = fminf(xlo, __shfl_xor_sync(FULL, xlo, d));
    xhi = fmaxf(xhi, __shfl_xor_sync(FULL, xhi, d));
    ylo = fminf(ylo, __shfl_xor_sync(FULL, ylo, d));
    yhi = fmaxf(yhi, __shfl_xor_sync(FULL, yhi, d));
    zlo = fminf(zlo, __shfl_xor_sync(FULL, zlo, d));
    zhi = fmaxf(zhi, __shfl_xor_sync(FULL, zhi, d));
    lr2 = fmaxf(lr2, __shfl_xor_sync(FULL, lr2, d));
  }
  const float slack = BOX_SLACK * (g.ex + g.ey + g.ez);
  const float xc = 0.5f * (xlo + xhi), xhw = 0.5f * (xhi - xlo) + slack;
  const float yc = 0.5f * (ylo + yhi), yhw = 0.5f * (yhi - ylo) + slack;
  const float zc = 0.5f * (zlo + zhi), zhw = 0.5f * (zhi - zlo) + slack;

  float* win = smem + STAGES * STAGE + warp * WIN * FW;
  int* klist = kept_rows + warp * 32;
  int* ulist = used_rows + warp * 32;
  LaneBits<WIN / 32> bits;        // this lane's accepted window rows
  int n = 0;                      // rows in the window (warp-uniform)
  Cursor cc;
  cc.start(span_cnt);
  for (int k = 0; !cc.done(); ++k, cc.next(span_cnt)) {
    const int st = k % STAGES;
    long long c0 = stamp<STATS>();
    mbar_wait(&full_bar[st], (k / STAGES) & 1);
    c_wait += stamp<STATS>() - c0;
    const float* rows = smem + st * STAGE;
    const int nr = min(CH, span_cnt[cc.s] - cc.r0);
    const int code = span_code[cc.s];
    float sx, sy, sz;
    shift_of(code, g, sx, sy, sz);
    n_staged += nr;
    for (int b0 = 0; b0 < nr; b0 += 32) {
      bool keep = false;
      if (b0 + lane < nr) {
        const float* nj = rows + (b0 + lane) * F;
        const float rr = Body::row_reach2(nj, prm);
        if (nj[I_MASK] > 0.f && rr >= 0.f) {
          // the row's distance to the warp's box
          const float bx = fmaxf(fabsf(xc - (nj[I_OFF0] + sx)) - xhw, 0.f);
          const float by = fmaxf(fabsf(yc - (nj[I_OFF1] + sy)) - yhw, 0.f);
          const float bz = fmaxf(fabsf(zc - (nj[I_OFF2] + sz)) - zhw, 0.f);
          keep = bx * bx + by * by + bz * bz
              <= fmaxf(rr, lr2) * REACH_SLACK;
        }
      }
      const uint32_t kept = __ballot_sync(FULL, keep);
      if (kept == 0u) continue;
      // the kept rows' numbers in order, then this lane's tests of them,
      // eight independent ones at a time; bit u of `mine`: kept row u
      const float* grp = rows + b0 * F;
      if (keep) klist[__popc(kept & ((1u << lane) - 1u))] = lane;
      __syncwarp();
      const int nk = __popc(kept);
      uint32_t mine = 0;
      for (int u0 = 0; u0 < nk; u0 += 8) {
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int q = u0 + v;
          const float* nj = grp + klist[min(q, nk - 1)] * F;
          float dx0, dx1, dx2;
          const float r2 = sep_r2<Stencil>(si, nj, sx, sy, sz, dx0, dx1,
                                           dx2);
          const bool ok = (q < nk) & (r2 > 0.f)
              & Body::in_range(si, nj, r2, prm);
          mine |= (uint32_t)ok << q;
        }
      }
      if (!own) mine = 0u;
      const uint32_t used = __reduce_or_sync(FULL, mine);
      if (used == 0u) {
        __syncwarp();                      // klist is rewritten next
        continue;
      }
      const int u = __popc(used);
      if (n + u > WIN) {
        c0 = stamp<STATS>();
        run_rounds<Stencil, Body>(si, win, bits, acc, mx, g, prm, rounds,
                                  pairs);
        c_rounds += stamp<STATS>() - c0;
        n = 0;
      }
      // the rows some lane accepts, in order: their numbers, then their
      // fields and the cell's stencil code into the window, every lane
      // copying at once
      if ((used >> lane) & 1u)
        ulist[__popc(used & ((1u << lane) - 1u))] = klist[lane];
      __syncwarp();
      for (int e = lane; e < u * FW; e += 32) {
        const int ur = e / FW, f = e - ur * FW;
        win[(n + ur) * FW + f] =
            f < F ? grp[ulist[ur] * F + f] : __int_as_float(code);
      }
      // this lane's bits at their window rows
      uint32_t packed = 0;
      for (uint32_t m = mine; m != 0u; m &= m - 1) {
        const int r = __ffs(m) - 1;
        packed |= 1u << __popc(used & ((1u << r) - 1u));
      }
      bits.or_at(n, packed);
      n += u;
      n_kept += u;
      __syncwarp();                        // klist is rewritten next
    }
    __syncwarp();                          // the warp is done with st
    if (lane == 0) mbar_arrive(&empty_bar[st]);
  }
  if (n > 0) {
    const long long c0 = stamp<STATS>();
    run_rounds<Stencil, Body>(si, win, bits, acc, mx, g, prm, rounds,
                              pairs);
    c_rounds += stamp<STATS>() - c0;
  }
  const long long c_walk = stamp<STATS>() - c_start;

  if (own) {
#pragma unroll
    for (int q = 0; q < NS; ++q) out[(size_t)q * Np + slot] = acc[q];
#pragma unroll
    for (int q = 0; q < NM; ++q) out[(size_t)(NS + q) * Np + slot] = mx[q];
  }
  if constexpr (STATS) {
    pairs = __reduce_add_sync(FULL, pairs);
    if (lane == 0) {
      int* s = stats + (size_t)gw * NSTAT;
      s[0] = n_staged;
      s[1] = n_kept;
      s[2] = rounds;
      s[3] = pairs;
      s[4] = (int)min(c_wait, (long long)INT_MAX);
      s[5] = (int)min(c_rounds, (long long)INT_MAX);
      s[6] = (int)min(c_walk, (long long)INT_MAX);
    }
  }
}

template <class Stencil, class Body, bool STATS>
cudaError_t configure() {
  static bool done = false;     // the attribute is set once per kernel
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      walk27_kernel<Stencil, Body, STATS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Walk<Body::F>::bytes(MAX_WARPS));
  done = e == cudaSuccess;
  return e;
}

template <class Stencil, class Body, bool STATS>
int start(int n_blocks, int wpb, cudaStream_t stream, const int* blocks,
          const int* wslot, const int* counts, const float* Xi,
          const float* Xa, float* out, int* stats, const Geometry& g,
          const BodyParams& prm) {
  const cudaError_t e = configure<Stencil, Body, STATS>();
  if (e != cudaSuccess) return (int)e;
  walk27_kernel<Stencil, Body, STATS>
      <<<n_blocks, (wpb + 1) * 32, Walk<Body::F>::bytes(wpb), stream>>>(
          blocks, wslot, counts, Xi, Xa, out, stats, g, prm);
  return (int)cudaGetLastError();
}

template <class Stencil, class Body>
int launch(const int* blocks, int n_blocks, int wpb, const int* wslot,
           const int* counts, const float* Xi, const float* Xa, float* out,
           int* stats, int ncx, int ncy, int ncz, int K, int KJ, int F,
           float ex, float ey, float ez, const float* params, int n_params,
           void* stream) {
  // bulk copies need 16-byte aligned spans: Xa aligned, cells of KJ rows
  // with KJ a multiple of 4 (F may be 2 mod 4)
  if (F != Body::F || n_params != Body::NP || n_params > MAX_PARAMS ||
      ncx < Stencil::MIN_CDIM || ncy < Stencil::MIN_CDIM ||
      ncz < Stencil::MIN_CDIM || K <= 0 || KJ < K || KJ % 4 != 0 ||
      wpb < 1 || wpb > MAX_WARPS || n_blocks <= 0 ||
      (reinterpret_cast<uintptr_t>(Xa) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Geometry g{ncx, ncy, ncz, K, KJ, ex, ey, ez};
  BodyParams prm{};
  for (int i = 0; i < n_params; ++i) prm.v[i] = params[i];
  const cudaStream_t st = (cudaStream_t)stream;
  return stats != nullptr
      ? start<Stencil, Body, true>(n_blocks, wpb, st, blocks, wslot, counts,
                                   Xi, Xa, out, stats, g, prm)
      : start<Stencil, Body, false>(n_blocks, wpb, st, blocks, wslot,
                                    counts, Xi, Xa, out, nullptr, g, prm);
}

// registers, local (spill) bytes, static and dynamic shared memory per
// block and resident blocks per SM of one body's production kernel (no
// statistics) at `wpb` i-slot warps a block, then its walk: fields,
// window rows, chunk rows, stages, most warps a block, statistics per
// warp
template <class Stencil, class Body>
int attributes(int* res, int wpb) {
  if (wpb < 1 || wpb > MAX_WARPS) return (int)cudaErrorInvalidValue;
  cudaError_t e = configure<Stencil, Body, false>();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, walk27_kernel<Stencil, Body, false>);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, walk27_kernel<Stencil, Body, false>, (wpb + 1) * 32,
      Walk<Body::F>::bytes(wpb));
  if (e != cudaSuccess) return (int)e;
  res[0] = a.numRegs;
  res[1] = (int)a.localSizeBytes;
  res[2] = (int)a.sharedSizeBytes;
  res[3] = (int)Walk<Body::F>::bytes(wpb);
  res[4] = blocks;
  res[5] = Body::F;
  res[6] = Walk<Body::F>::WIN;
  res[7] = CH;
  res[8] = STAGES;
  res[9] = MAX_WARPS;
  res[10] = NSTAT;
  return 0;
}

}  // namespace walk27

// the C entries of one body: <PREFIX>_<NAME>(...) launches it,
// <PREFIX>_<NAME>_attributes(res, wpb) describes it
#define WALK27_ENTRY(PREFIX, STENCIL, NAME, BODY)                          \
  extern "C" int PREFIX##_##NAME(                                          \
      const int* blocks, int n_blocks, int wpb, const int* wslot,          \
      const int* counts, const float* Xi, const float* Xa, float* out,     \
      int* stats, int ncx, int ncy, int ncz, int K, int KJ, int F,         \
      float ex, float ey, float ez, const float* params, int n_params,     \
      void* stream) {                                                      \
    return walk27::launch<STENCIL, BODY>(                                  \
        blocks, n_blocks, wpb, wslot, counts, Xi, Xa, out, stats, ncx,     \
        ncy, ncz, K, KJ, F, ex, ey, ez, params, n_params, stream);         \
  }                                                                        \
  extern "C" int PREFIX##_##NAME##_attributes(int* res, int wpb) {         \
    return walk27::attributes<STENCIL, BODY>(res, wpb);                    \
  }

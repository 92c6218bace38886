// Flat (column/z-sorted) pair kernel K1 for Hopper (sm_90a).
//
// Replaces: swift_subtask_dev_tpu/ops/pallas_flat.py:268 pair_apply (the
// Pallas TPU kernel, inner `kernel` at :408) for its six bodies
// (csrc/pair_bodies.cuh): density, gradient, force, force + gravity, P2P
// gravity and the limiter's timebin scan; the SPH bodies in each SPH
// scheme's mode (the reference traces the scheme's term functions into
// the kernel, ops/hydro_pallas.py:85, :140, :192, :288) under each
// smoothing kernel; and its cross-species mode
// (`fields_j`, :280-281): the i slots come from one species' tiles (W
// slots a column) and the j rows from another species' AoS (Wj rows a
// column) on the same column grid, with range words over the j species'
// blocks.  Only the staging of j rows reads Wj; the i tiles, the range
// words and the statistics are laid out by the i side.  A seventh body,
// chemistry smoothing (ChemSmooth), has no TPU kernel: the reference
// computes it in XLA (ops/stencil.py:597 chemistry_smooth_loop), as a
// (C, W, 27 W) tile on the column grid; its pair set is the density
// body's, so it runs on this walk.  The six
// synthetic bodies of the cost probe (csrc/probe_bodies.cuh;
// tools/probe_kernel.py:26 main of the reference) run on the same kernel
// through their own entries.
//
// What it computes: for each 128-slot i-tile of a z-sorted column and each
// of the 9 neighbour columns, the j-rows named by the tile's two packed
// range words (s | c << 16, unsigned 16-bit fields, in granules of `gran`
// rows; one run, or two when the z-window wraps the box); per i slot, NS
// sums and NM maxes of the body over the pairs it accepts.  Pair mask:
// mask_j > 0 & r2 > 0 & in_range (the body's ok_extra).  z wraps with
// rintf (round half to even, as torch.round); the separation is
// off_i - (off_j + shift).  Dead tiles read 0; a live slot with no pair
// reads 0 (sums) and -inf (maxes).
//
// What bounds it: the TPU kernel evaluates the body for every (i slot, j
// row) its range words name and masks afterwards: on the main path 1,870
// candidate rows per slot for ~48 neighbours, so ~97% of its FP32 and SFU
// work (78-243 operations per pair: rsqrt, exp, divides, sqrt) is
// discarded.  This walk evaluates a body only on the pairs it accepts;
// what bounds it now is the walk itself (the filter, the kept rows'
// tests, the copy of accepted rows, waits on the staging ring) and the
// rounds' lane utilisation (~0.54 for the force bodies, ~0.75 for
// density), far from the card's FP32 rate (PERF.md §6).  The design:
//
// 1. Staging.  The block's (neighbour column, run, CH-row chunk) sequence
//    is one flat list of contiguous AoS spans (16-byte aligned: rows come
//    in granules of 16).  A fifth warp, the producer, keeps up to STAGES
//    of them in flight into a ring of shared-memory buffers with 1-D bulk
//    copies (cp.async.bulk, the TMA), each completing on its stage's
//    "full" mbarrier; each of the four i-slot warps arrives on the stage's
//    "empty" mbarrier once it has scanned it, and the producer refills a
//    stage when all four have.  The warps drift up to STAGES - 1 chunks
//    apart; the walk has no __syncthreads.
// 2. Warp filter.  Each warp bounds its 32 i slots by a box (x, y; z
//    periodic) and a reach (the body's lane_reach2, maxed over the warp).
//    A lane tests one staged row in 32 (mask_j, the body's row_reach2,
//    the row's distance to the box) and a ballot keeps the rows that some
//    slot of the warp may accept.  Slack of 1e-4 on r2 and 1e-5 of the box
//    on each distance exceeds the rounding, so no accepted pair is lost.
// 3. Per-lane compaction.  For each 32-row group with a kept row, every
//    lane tests the kept rows (separation, r2 and in_range; eight
//    independent tests at a time) into a word of the rows it accepts.
//    The rows that some lane accepts are copied in order into the warp's
//    window in shared memory (x, y with the column shift added; all lanes
//    at once), and each lane's bits go to their window rows (a WIN-bit
//    mask, 32-bit words in registers).  When a group would overflow the
//    window, or the walk ends, the warp runs rounds: each lane pops its
//    lowest set bit and evaluates the body on that row.  So each lane sums
//    its pairs in j-row order, the order of the TPU kernel: no atomics, no
//    cross-lane reduction, the same bits from run to run.
//
// 4. Empty slots.  A live tile's empty i slots hold pad fills (h = 1), so
//    they accept nearly every row, and as a rule their fields are all
//    alike.  The first of them (the representative) is evaluated by its
//    warp 32 staged rows at a time, one row per lane, and its own lane
//    adds the accepted rows in row order (shuffles, no reduction across
//    lanes); the empty slots bit-identical to it copy its outputs.  An
//    empty slot whose fields differ is walked like a live one.
//
// The ring's mbarrier and bulk-copy helpers, a lane's bits and the
// filter's slack are csrc/walk.cuh's, shared with the 27-cell walk
// (csrc/walk27.cuh).
//
// Each body has two instantiations: the production one, and one that
// writes per-warp statistics to `stats` (a launch with a non-null
// pointer): the rows staged and kept (accepted by some slot of the warp),
// the rounds and pairs (lane utilisation: pairs over 32 x rounds), and
// clock64 cycles spent waiting for staged rows, in rounds, on the
// representative's rows and in the whole walk.  Without statistics the
// counters are dead code and no clock is read.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no --use_fast_math: expf, sqrtf
// and divides stay IEEE; no FMA contraction, so every pair expression
// rounds like its torch counterpart).  Bound with ctypes; each entry
// returns a cudaError_t (cudaGetLastError() after the launch).  Built as
// is, the library holds SPHENIX with the cubic spline and the other
// bodies; with -DSPH_SCHEME=<scheme struct> -DSPH_KERNEL=<kernel struct>
// -DSPH_GRADIENT=<0|1> it holds one scheme's SPH bodies under one kernel
// (a mode library, built when a run first asks for it).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "pair_bodies.cuh"
#include "probe_bodies.cuh"
#include "walk.cuh"

namespace {

constexpr int LANES = 128;       // i slots per block, one thread each
constexpr int WARPS = LANES / 32;
constexpr int THREADS = LANES + 32;   // and the producer warp
constexpr int CH = 64;           // j rows per staged chunk
constexpr int STAGES = 4;        // chunks in flight
constexpr int NSPAN = 18;        // 9 neighbour columns x 2 runs
// per-warp statistics: rows staged, kept, rounds, pairs; then clock64
// cycles waiting for staged chunks, in rounds, in the representative's
// rows, and in the whole walk
constexpr int NSTAT = 8;

// the 9 (dx, dy) column offsets, self first (ops/pair_flat.py OFFSETS_9)
__constant__ int OFF_DX[9] = {0, -1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int OFF_DY[9] = {0, -1, 0, 1, -1, 1, -1, 0, 1};

// W: the i side's column capacity (tiles, outputs, statistics); Wj: the
// j side's (the AoS the producer stages from; W for one species)
struct Geometry {
  int ncx, ncy, W, Wj, gran;
  float ex, ey, boxz, inv_boxz;
};

// a body's walk: WIN kept rows per warp window (256 for rows of at most
// 11 fields, as density's; 128 otherwise, so that a block of gradient or
// the force bodies fits 3-4 times in an SM), and the block's dynamic
// shared memory: STAGES chunk buffers, then one window per warp (rows of
// FW = F | 1 floats: an odd stride spreads the banks)
template <int F>
struct Walk {
  static constexpr int WIN = F <= 11 ? 256 : 128;
  static constexpr int FW = F | 1;
  static constexpr int STAGE = CH * F;
  static constexpr size_t BYTES =
      (size_t)(STAGES * STAGE + WARPS * WIN * FW) * sizeof(float);
};

// position in the block's chunk list: span s (= 2 * offset + run), first
// row r0; done when s == NSPAN
struct Cursor {
  int s, r0;
  __device__ __forceinline__ void settle(const int* lo, const int* hi) {
    while (s < NSPAN && r0 >= hi[s]) {
      if (++s < NSPAN) r0 = lo[s];
    }
  }
  __device__ __forceinline__ void start(const int* lo, const int* hi) {
    s = 0;
    r0 = lo[0];
    settle(lo, hi);
  }
  __device__ __forceinline__ void next(const int* lo, const int* hi) {
    r0 += CH;
    settle(lo, hi);
  }
  __device__ __forceinline__ bool done() const { return s >= NSPAN; }
};

// separation and r2 of slot si and a row whose x, y already hold the
// column shift (the rounding of off_i - (off_j + shift))
__device__ __forceinline__ float pair_r2(const float* si, float wx, float wy,
                                         float wz, const Geometry& g,
                                         float& dx0, float& dx1,
                                         float& dz) {
  dz = si[I_OFF2] - wz;
  dz = dz - g.boxz * rintf(dz * g.inv_boxz);
  dx0 = si[I_OFF0] - wx;
  dx1 = si[I_OFF1] - wy;
  return dx0 * dx0 + dx1 * dx1 + dz * dz;
}

// rounds over a warp's window: each lane evaluates the body on its kept
// rows (its set bits), lowest first, one per round
template <class Body, class Bits>
__device__ __forceinline__ void run_rounds(
    const float* si, const float* win, Bits& bits, float* acc, float* mx,
    const Geometry& g, const BodyParams& prm, int& rounds, int& pairs) {
  constexpr int NS = Body::NS, NM = Body::NM, FW = Walk<Body::F>::FW;
  __syncwarp();                       // the window rows are written
  for (;;) {
    const int idx = bits.pop();       // this lane's lowest kept row
    if (!__any_sync(FULL, idx >= 0)) break;
    ++rounds;
    if (idx >= 0) {
      const float* nj = win + idx * FW;
      float dx0, dx1, dz;
      const float r2 = pair_r2(si, nj[I_OFF0], nj[I_OFF1], nj[I_OFF2], g,
                               dx0, dx1, dz);
      float sums[NS > 0 ? NS : 1];
      float maxes[NM > 0 ? NM : 1];
      Body::eval(si, nj, dx0, dx1, dz, r2, prm, sums, maxes);
#pragma unroll
      for (int q = 0; q < NS; ++q) acc[q] += sums[q];
#pragma unroll
      for (int q = 0; q < NM; ++q) mx[q] = fmaxf(mx[q], maxes[q]);
      ++pairs;
    }
  }
  __syncwarp();                       // the window may be refilled
}

// the representative empty slot's pairs with 32 staged rows: each lane
// evaluates one row, and lane `rep_lane` accumulates the accepted ones in
// row order (its own sums, in the order of every other slot's)
template <class Body>
__device__ __forceinline__ void rep_rows(
    const float* rep_si, const float* rows, int b0, int nr, float sx,
    float sy, int lane, int rep_lane, float* acc, float* mx,
    const Geometry& g, const BodyParams& prm) {
  constexpr int F = Body::F, NS = Body::NS, NM = Body::NM;
  float sums[NS > 0 ? NS : 1] = {};
  float maxes[NM > 0 ? NM : 1] = {};
  bool ok = false;
  if (b0 + lane < nr) {
    const float* nj = rows + (b0 + lane) * F;
    if (nj[I_MASK] > 0.f) {
      float dx0, dx1, dz;
      const float r2 = pair_r2(rep_si, nj[I_OFF0] + sx, nj[I_OFF1] + sy,
                               nj[I_OFF2], g, dx0, dx1, dz);
      ok = (r2 > 0.f) && Body::in_range(rep_si, nj, r2, prm);
      if (ok) Body::eval(rep_si, nj, dx0, dx1, dz, r2, prm, sums, maxes);
    }
  }
  uint32_t bits = __ballot_sync(FULL, ok);
  while (bits) {
    const int b = __ffs(bits) - 1;
    bits &= bits - 1;
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const float v = __shfl_sync(FULL, sums[q], b);
      if (lane == rep_lane) acc[q] += v;
    }
#pragma unroll
    for (int q = 0; q < NM; ++q) {
      const float v = __shfl_sync(FULL, maxes[q], b);
      if (lane == rep_lane) mx[q] = fmaxf(mx[q], v);
    }
  }
}

template <class Body, bool STATS>
__global__ void __launch_bounds__(THREADS)
pair_flat_kernel(const int* __restrict__ tcounts,
                 const int* __restrict__ ranges,
                 const float* __restrict__ Xi,
                 const float* __restrict__ Xa,
                 float* __restrict__ out, int* __restrict__ stats,
                 Geometry g, BodyParams prm) {
  constexpr int F = Body::F, NS = Body::NS, NM = Body::NM;
  constexpr int WIN = Walk<F>::WIN, FW = Walk<F>::FW;
  constexpr int STAGE = Walk<F>::STAGE;
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ int span_lo[NSPAN], span_hi[NSPAN];
  __shared__ unsigned empty_bits[WARPS];
  // per warp: a group's kept rows, and those some lane accepts
  __shared__ int kept_rows[WARPS * 32], used_rows[WARPS * 32];
  __shared__ float rep_si[F];
  __shared__ float rep_out[NS + NM > 0 ? NS + NM : 1];

  const int tile = blockIdx.x, col = blockIdx.y, t = threadIdx.x;
  if (tile >= tcounts[col]) return;          // dead tile: output stays 0
  const int lane = t & 31, warp = t >> 5;
  const bool producer = warp == WARPS;
  const int TPC = gridDim.x;
  const size_t Np = (size_t)gridDim.y * g.W;
  const size_t slot = (size_t)col * g.W + (size_t)tile * LANES + t;
  const int ix = col / g.ncy, iy = col % g.ncy;

  float si[F];
  if (producer) {
#pragma unroll
    for (int f = 0; f < F; ++f) si[f] = 0.f;
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) si[f] = Xi[(size_t)f * Np + slot];
  }
  float acc[NS > 0 ? NS : 1];
  float mx[NM > 0 ? NM : 1];
#pragma unroll
  for (int q = 0; q < NS; ++q) acc[q] = 0.f;
#pragma unroll
  for (int q = 0; q < NM; ++q) mx[q] = -INFINITY;

  if (t < NSPAN) {
    const uint32_t w = (uint32_t)ranges[((size_t)col * TPC + tile) * NSPAN
                                        + t];
    const int lo = (int)(w & 0xFFFFu) * g.gran;
    span_lo[t] = lo;
    span_hi[t] = lo + (int)(w >> 16) * g.gran;
  }
  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const bool empty = !producer && !(si[I_MASK] > 0.f);
  const unsigned eb = __ballot_sync(FULL, empty);
  if (lane == 0 && !producer) empty_bits[warp] = eb;
  __syncthreads();

  // The tile's empty slots hold pad fills, as a rule the same in every
  // one: the first empty slot (the representative) is evaluated by its
  // warp on every staged row, 32 rows at a time, and the empty slots whose
  // fields are bit-identical to its copy its outputs.  Every other slot
  // ("own") goes through the warp filter and the rounds.
  int rep = -1;
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    if (rep < 0 && empty_bits[w] != 0u)
      rep = 32 * w + __ffs(empty_bits[w]) - 1;
  if (t == rep) {
#pragma unroll
    for (int f = 0; f < F; ++f) rep_si[f] = si[f];
  }
  __syncthreads();

  if (producer) {
    // keep STAGES chunks in flight, each once every warp is done with the
    // chunk STAGES before it in the same buffer
    if (lane == 0) {
      Cursor pc;
      pc.start(span_lo, span_hi);
      for (int k = 0; !pc.done(); ++k, pc.next(span_lo, span_hi)) {
        const int st = k % STAGES;
        if (k >= STAGES) mbar_wait(&empty_bar[st], ((k / STAGES) + 1) & 1);
        const int o = pc.s >> 1;
        const int jcol = ((ix + OFF_DX[o] + g.ncx) % g.ncx) * g.ncy
            + (iy + OFF_DY[o] + g.ncy) % g.ncy;
        const int nr = min(CH, span_hi[pc.s] - pc.r0);
        const uint32_t bytes = (uint32_t)(nr * F * sizeof(float));
        mbar_arrive_tx(&full_bar[st], bytes);
        bulk_load(smem + st * STAGE,
                  Xa + ((size_t)jcol * g.Wj + pc.r0) * F, bytes,
                  &full_bar[st]);
      }
    }
    __syncwarp();
  }

  bool own = !producer;
  if (rep >= 0 && empty) {
    own = false;
#pragma unroll
    for (int f = 0; f < F; ++f)
      own |= __float_as_uint(si[f]) != __float_as_uint(rep_si[f]);
  }
  const bool rep_warp = rep >= 0 && warp == (rep >> 5);
  const int rep_lane = rep & 31;
  int n_staged = 0, n_kept = 0, rounds = 0, pairs = 0;
  long long c_wait = 0, c_rounds = 0, c_rep = 0;
  const long long c_start = stamp<STATS>();

  if (!producer) {
    // the warp's box and reach over its own slots
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
    const bool any_own = __any_sync(FULL, own);
    const float slack = BOX_SLACK * (g.boxz + g.ex + g.ey);
    const float xc = 0.5f * (xlo + xhi), xhw = 0.5f * (xhi - xlo) + slack;
    const float yc = 0.5f * (ylo + yhi), yhw = 0.5f * (yhi - ylo) + slack;
    const float zc = 0.5f * (zlo + zhi), zhw = 0.5f * (zhi - zlo) + slack;

    float* win = smem + STAGES * STAGE + warp * WIN * FW;
    int* klist = kept_rows + warp * 32;
    int* ulist = used_rows + warp * 32;
    LaneBits<WIN / 32> bits;      // this lane's accepted window rows
    int n = 0;                    // rows in the window (warp-uniform)
    Cursor cc;
    cc.start(span_lo, span_hi);
    for (int k = 0; !cc.done(); ++k, cc.next(span_lo, span_hi)) {
      const int st = k % STAGES;
      long long c0 = stamp<STATS>();
      mbar_wait(&full_bar[st], (k / STAGES) & 1);
      c_wait += stamp<STATS>() - c0;
      const float* rows = smem + st * STAGE;
      const int nr = min(CH, span_hi[cc.s] - cc.r0);
      const int o = cc.s >> 1;
      const float sx = (float)OFF_DX[o] * g.ex;
      const float sy = (float)OFF_DY[o] * g.ey;
      n_staged += nr;
      for (int b0 = 0; b0 < nr; b0 += 32) {
        if (rep_warp) {
          c0 = stamp<STATS>();
          rep_rows<Body>(rep_si, rows, b0, nr, sx, sy, lane, rep_lane, acc,
                         mx, g, prm);
          c_rep += stamp<STATS>() - c0;
        }
        bool keep = false;
        if (any_own && b0 + lane < nr) {
          const float* nj = rows + (b0 + lane) * F;
          const float rr = Body::row_reach2(nj, prm);
          if (nj[I_MASK] > 0.f && rr >= 0.f) {
            // the row's distance to the warp's box, z periodic
            float bz = zc - nj[I_OFF2];
            bz = bz - g.boxz * rintf(bz * g.inv_boxz);
            bz = fmaxf(fabsf(bz) - zhw, 0.f);
            const float bx =
                fmaxf(fabsf(xc - (nj[I_OFF0] + sx)) - xhw, 0.f);
            const float by =
                fmaxf(fabsf(yc - (nj[I_OFF1] + sy)) - yhw, 0.f);
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
            float dx0, dx1, dz;
            const float r2 = pair_r2(si, nj[I_OFF0] + sx, nj[I_OFF1] + sy,
                                     nj[I_OFF2], g, dx0, dx1, dz);
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
          run_rounds<Body>(si, win, bits, acc, mx, g, prm, rounds, pairs);
          c_rounds += stamp<STATS>() - c0;
          n = 0;
        }
        // the rows some lane accepts, in order: their numbers, then their
        // fields into the window (x, y with the column shift), every lane
        // copying at once
        if ((used >> lane) & 1u)
          ulist[__popc(used & ((1u << lane) - 1u))] = klist[lane];
        __syncwarp();
        for (int e = lane; e < u * F; e += 32) {
          const int ur = e / F, f = e - ur * F;
          const float v = grp[ulist[ur] * F + f];
          win[(n + ur) * FW + f] =
              f == I_OFF0 ? v + sx : (f == I_OFF1 ? v + sy : v);
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
      run_rounds<Body>(si, win, bits, acc, mx, g, prm, rounds, pairs);
      c_rounds += stamp<STATS>() - c0;
    }
  }
  const long long c_walk = stamp<STATS>() - c_start;

  // the empty slots that copy the representative
  if (t == rep) {
#pragma unroll
    for (int q = 0; q < NS; ++q) rep_out[q] = acc[q];
#pragma unroll
    for (int q = 0; q < NM; ++q) rep_out[NS + q] = mx[q];
  }
  __syncthreads();
  if (producer) return;
  if (!own && t != rep) {
#pragma unroll
    for (int q = 0; q < NS; ++q) acc[q] = rep_out[q];
#pragma unroll
    for (int q = 0; q < NM; ++q) mx[q] = rep_out[NS + q];
  }
#pragma unroll
  for (int q = 0; q < NS; ++q) out[(size_t)q * Np + slot] = acc[q];
#pragma unroll
  for (int q = 0; q < NM; ++q) out[(size_t)(NS + q) * Np + slot] = mx[q];
  if constexpr (STATS) {
    pairs = __reduce_add_sync(FULL, pairs);
    if (lane == 0) {
      int* s = stats + (((size_t)col * TPC + tile) * WARPS + warp) * NSTAT;
      s[0] = n_staged;
      s[1] = n_kept;
      s[2] = rounds;
      s[3] = pairs;
      s[4] = (int)min(c_wait, (long long)INT_MAX);
      s[5] = (int)min(c_rounds, (long long)INT_MAX);
      s[6] = (int)min(c_rep, (long long)INT_MAX);
      s[7] = (int)min(c_walk, (long long)INT_MAX);
    }
  }
}

template <class Body, bool STATS>
cudaError_t configure() {
  static bool done = false;     // the attribute is set once per kernel
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      pair_flat_kernel<Body, STATS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Walk<Body::F>::BYTES);
  done = e == cudaSuccess;
  return e;
}

template <class Body, bool STATS>
int start(dim3 grid, cudaStream_t stream, const int* tcounts,
          const int* ranges, const float* Xi, const float* Xa, float* out,
          int* stats, const Geometry& g, const BodyParams& prm) {
  const cudaError_t e = configure<Body, STATS>();
  if (e != cudaSuccess) return (int)e;
  pair_flat_kernel<Body, STATS><<<grid, THREADS, Walk<Body::F>::BYTES,
                                  stream>>>(tcounts, ranges, Xi, Xa, out,
                                            stats, g, prm);
  return (int)cudaGetLastError();
}

template <class Body>
int launch(const int* tcounts, const int* ranges, const float* Xi,
           const float* Xa, float* out, int* stats, int ncx, int ncy,
           int W, int Wj, int gran, int F, float ex, float ey, float boxz,
           float inv_boxz, const float* params, int n_params,
           void* stream) {
  // bulk copies need 16-byte aligned spans: Xa aligned, rows in multiples
  // of 4 (F may be odd); the range words' 16-bit counts of granules
  if (F != Body::F || n_params != Body::NP || n_params > MAX_PARAMS ||
      W % LANES != 0 || gran <= 0 || Wj % gran != 0 ||
      Wj / gran > 65535 || ncx * ncy > 65535 || gran % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(Xa) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Geometry g{ncx, ncy, W, Wj, gran, ex, ey, boxz, inv_boxz};
  BodyParams prm{};
  for (int i = 0; i < n_params; ++i) prm.v[i] = params[i];
  const dim3 grid(W / LANES, ncx * ncy);
  const cudaStream_t st = (cudaStream_t)stream;
  return stats != nullptr
      ? start<Body, true>(grid, st, tcounts, ranges, Xi, Xa, out, stats, g,
                          prm)
      : start<Body, false>(grid, st, tcounts, ranges, Xi, Xa, out, nullptr,
                           g, prm);
}

// registers, local (spill) bytes, static and dynamic shared memory per
// block and resident blocks per SM of one body's production kernel (no
// statistics), then its walk: fields, window rows, chunk rows, stages,
// warps, statistics per warp
template <class Body>
int attributes(int* res) {
  cudaError_t e = configure<Body, false>();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, pair_flat_kernel<Body, false>);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pair_flat_kernel<Body, false>, THREADS,
      Walk<Body::F>::BYTES);
  if (e != cudaSuccess) return (int)e;
  res[0] = a.numRegs;
  res[1] = (int)a.localSizeBytes;
  res[2] = (int)a.sharedSizeBytes;
  res[3] = (int)Walk<Body::F>::BYTES;
  res[4] = blocks;
  res[5] = Body::F;
  res[6] = Walk<Body::F>::WIN;
  res[7] = CH;
  res[8] = STAGES;
  res[9] = WARPS;
  res[10] = NSTAT;
  return 0;
}

}  // namespace

#define PAIR_FLAT_ENTRY(NAME, BODY)                                        \
  extern "C" int pair_flat_##NAME(                                         \
      const int* tcounts, const int* ranges, const float* Xi,              \
      const float* Xa, float* out, int* stats, int ncx, int ncy, int W,    \
      int Wj, int gran, int F, float ex, float ey, float boxz,             \
      float inv_boxz, const float* params, int n_params, void* stream) {   \
    return launch<BODY>(tcounts, ranges, Xi, Xa, out, stats, ncx, ncy, W,  \
                        Wj, gran, F, ex, ey, boxz, inv_boxz, params,       \
                        n_params, stream);                                 \
  }                                                                        \
  extern "C" int pair_flat_##NAME##_attributes(int* res) {                 \
    return attributes<BODY>(res);                                          \
  }

#ifdef SPH_SCHEME
// a mode library (ops/pair_flat.py mode_library): the SPH bodies of one
// scheme (SPH_SCHEME, a struct of csrc/pair_bodies.cuh) under one
// smoothing kernel (SPH_KERNEL), with the gradient body when the scheme
// has a gradient loop (SPH_GRADIENT)
using ModeDensity = DensityT<SPH_SCHEME, SPH_KERNEL>;
using ModeForce = ForceT<SPH_SCHEME, SPH_KERNEL>;
using ModeForceGravity = ForceGravityT<SPH_SCHEME, SPH_KERNEL>;
PAIR_FLAT_ENTRY(density, ModeDensity)
#if SPH_GRADIENT
using ModeGradient = GradientT<SPH_SCHEME, SPH_KERNEL>;
PAIR_FLAT_ENTRY(gradient, ModeGradient)
#endif
PAIR_FLAT_ENTRY(force, ModeForce)
PAIR_FLAT_ENTRY(force_gravity, ModeForceGravity)
#else
PAIR_FLAT_ENTRY(density, Density)
PAIR_FLAT_ENTRY(gradient, Gradient)
PAIR_FLAT_ENTRY(force, Force)
PAIR_FLAT_ENTRY(force_gravity, ForceGravity)
PAIR_FLAT_ENTRY(p2p_gravity, P2PGravity)
PAIR_FLAT_ENTRY(timebin, Timebin)
PAIR_FLAT_ENTRY(chem_smooth, ChemSmooth)
PAIR_FLAT_ENTRY(probe_a00, ProbeA00)
PAIR_FLAT_ENTRY(probe_a, ProbeA)
PAIR_FLAT_ENTRY(probe_b, ProbeB)
PAIR_FLAT_ENTRY(probe_c, ProbeC)
PAIR_FLAT_ENTRY(probe_d, ProbeD)
PAIR_FLAT_ENTRY(probe_e, ProbeE)
#endif

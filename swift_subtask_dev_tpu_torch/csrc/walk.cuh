// The pieces of a warp walk that the flat pair kernel (csrc/pair_flat.cu)
// and the 27-cell pair kernels (csrc/walk27.cuh) share: the filter's
// slack, a lane's accepted-row bits, the clock of the statistics, and
// the mbarrier ring fed by 1-D bulk copies (cp.async.bulk, the TMA).
//
// Slack: a warp keeps a staged row when the row's distance to the box
// around the warp's i slots, squared, is at most max(lane_reach2 of its
// slots, row_reach2 of the row) x REACH_SLACK, each distance widened by
// BOX_SLACK x (the sum of the grid's periodic lengths or cell edges).  The
// separations of the pair tests round in f32 on coordinates within a few
// cell edges of the box, so their error is a few ulp of those lengths,
// far below 1e-5 of them; REACH_SLACK covers the rounding of the r2
// bounds.  So no pair that a body's in_range accepts is dropped (held on
// the CPU by each engine's walk_filter model, on the card by the pairs
// each warp evaluates).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr unsigned FULL = 0xffffffffu;
constexpr float REACH_SLACK = 1.0001f;   // on the r2 bounds
constexpr float BOX_SLACK = 1e-5f;       // x (the lengths), on distances
constexpr long long WAIT_CYCLES = 1LL << 34;   // ~10 s at 1.7 GHz

// a lane's accepted rows of a window, NWORD 32-bit words held in
// registers (no array: a dynamically indexed one would go to local
// memory)
template <int NWORD>
struct LaneBits {
  static_assert(NWORD == 4 || NWORD == 8, "windows of 128 or 256 rows");
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0, w4 = 0, w5 = 0, w6 = 0, w7 = 0;
  // bits p .. p + 31 |= c (p + 32 - clz(c) <= 32 * NWORD)
  __device__ __forceinline__ void or_at(int p, uint32_t c) {
    const int j = p >> 5, sh = p & 31;
    const uint32_t lo = c << sh, hi = sh ? c >> (32 - sh) : 0u;
    w0 |= j == 0 ? lo : 0u;
    w1 |= j == 1 ? lo : (j == 0 ? hi : 0u);
    w2 |= j == 2 ? lo : (j == 1 ? hi : 0u);
    w3 |= j == 3 ? lo : (j == 2 ? hi : 0u);
    if constexpr (NWORD == 8) {
      w4 |= j == 4 ? lo : (j == 3 ? hi : 0u);
      w5 |= j == 5 ? lo : (j == 4 ? hi : 0u);
      w6 |= j == 6 ? lo : (j == 5 ? hi : 0u);
      w7 |= j == 7 ? lo : (j == 6 ? hi : 0u);
    }
  }
  // the lowest set bit's index, cleared; -1 if none
  __device__ __forceinline__ int pop() {
    if (w0) return take(w0, 0);
    if (w1) return take(w1, 32);
    if (w2) return take(w2, 64);
    if (w3) return take(w3, 96);
    if constexpr (NWORD == 8) {
      if (w4) return take(w4, 128);
      if (w5) return take(w5, 160);
      if (w6) return take(w6, 192);
      if (w7) return take(w7, 224);
    }
    return -1;
  }
  static __device__ __forceinline__ int take(uint32_t& w, int base) {
    const int b = __ffs(w) - 1;
    w &= w - 1;
    return base + b;
  }
};

// clock64() in a kernel with statistics, else a constant 0
template <bool STATS>
__device__ __forceinline__ long long stamp() {
  if constexpr (STATS) return clock64();
  return 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait for the phase of parity `parity`; a wait of over WAIT_CYCLES (a
// lost arrival, a fault of the walk) traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
    if (done) return;
    if (spin == 0) t0 = clock64();
    else if (clock64() - t0 > WAIT_CYCLES) __trap();
  }
}

// one 1-D bulk copy global -> shared, completing on `bar` (16-byte
// aligned addresses, a multiple of 16 bytes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(smem_addr(bar)) : "memory");
}

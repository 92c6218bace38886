// Pair bodies of the flat and packed pair kernels (csrc/pair_flat.cu,
// csrc/pair_packed.cu).
//
// Each body is the per-pair evaluation of one loop of ops/hydro_flat.py,
// with the same formulas and the same f32 operation order as the plain
// torch callbacks there (the schemes' density_terms, gradient_terms and
// force_terms in models/sph/; ops/p2p_gravity.py force_pot_factors).
// The library is built without fast math and without FMA contraction, so
// each expression rounds as its torch counterpart does.
//
// The SPH bodies are templates over a smoothing kernel (a struct with
// deval_x: models/sph/kernels.py, the six of its KERNELS) and an SPH
// scheme (a struct of term functions and layout constants: Sphenix,
// Minimal, Gadget2, PressureEnergy, AnarchyPU, PressureEntropy,
// PressureEnergyMM, Phantom, Gasoline, NoneScheme; Planetary's bodies
// are Minimal's).  DensityT<S, K>, GradientT<S, K>, ForceT<S, K> and
// ForceGravityT<S, K> are the flat kernel's modes (csrc/pair_flat.cu
// builds one library per scheme and kernel); Density, Gradient and
// Force, the packed and ring kernels' bodies, are SPHENIX with the cubic
// spline.
//
// A body is a struct with
//   F, NS, NM        field count, sum outputs, max outputs
//   eval(si, nj, dx, dy, dz, r2, prm, sums, maxes) -> ok_extra
//   in_range(si, nj, r2, prm)  the same ok_extra alone (eval returns it)
//   lane_reach2(si, prm), row_reach2(nj, prm)
//                    bounds on the r2 that in_range accepts: it accepts
//                    no pair with r2 above max(lane_reach2 of any i slot
//                    of a set, row_reach2 of the j row), and no pair at
//                    all with a j row whose row_reach2 is negative
//                    (the flat kernel's warp filter, ops/pair_flat.py
//                    REACH2)
// si: the i slot's F fields (registers); nj: the j row's F fields (shared
// memory).  Field indices follow the body's field tuple in
// ops/hydro_flat.py; parameter indices follow PairBody.params.
//
// rsqrt: rsqrtf (the CUDA intrinsic PyTorch's own rsqrt uses), <= 2 ulp.
// erfc: the Abramowitz & Stegun 7.1.26 polynomial, as the reference.

#pragma once

#include <math.h>

#define FL(x) ((float)(x))   // a python float literal, rounded to f32

constexpr int MAX_PARAMS = 24;

struct BodyParams {
  float v[MAX_PARAMS];
};

// common field indices (every body starts with mask, off0, off1, off2)
constexpr int I_MASK = 0, I_OFF0 = 1, I_OFF1 = 2, I_OFF2 = 3;

// kernel constants shared by the hydro bodies: (gamma2, gamma_inv, g3, g4)
constexpr int P_GAMMA2 = 0, P_GAMMA_INV = 1, P_G3 = 2, P_G4 = 3;
// cosmology factors of the gradient and force bodies: (a^2 H, fac_mu)
constexpr int P_A2H = 4, P_FAC_MU = 5;

__device__ __forceinline__ float r_inv_of(float r2) {
  return r2 > 0.f ? rsqrtf(fmaxf(r2, FL(1e-38))) : 0.f;
}

// ---------------------------------------------------------------------------
// Smoothing kernels (models/sph/kernels.py SPHKernel.deval): deval_x(x)
// gives (w, dw/dx) on x = u / gamma, before the normalisations g3, g4.
// The splines in truncated-power form, w = sum_k c_k (a_k - x)_+^deg,
// term by term; the Wendland kernels by Horner over their one branch,
// w clamped to >= 0 and dw to <= 0, zero for x >= 1.
// ---------------------------------------------------------------------------

// one truncated-power term c (a - x)_+^DEG added to (w, dw)
template <int DEG>
__device__ __forceinline__ void tp_term(float x, float a, float c,
                                        float& w, float& dw) {
  const float t = fmaxf(a - x, 0.f);
  float pw = t;
#pragma unroll
  for (int k = 0; k < DEG - 2; ++k) pw = pw * t;     // t^(DEG-1)
  w = w + c * (pw * t);
  dw = dw + (FL(-DEG) * c) * pw;
}

// Horner over one branch's coefficients (highest power first), then the
// Wendland clamps
template <int N>
__device__ __forceinline__ void horner_branch(const float (&cs)[N], float x,
                                              float& w, float& dw) {
  float wi = cs[0];
  float dwi = 0.f;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    dwi = dwi * x + wi;
    wi = wi * x + cs[k];
  }
  const bool inside = x < 1.f;
  w = inside ? fmaxf(wi, 0.f) : 0.f;
  dw = inside ? fminf(dwi, 0.f) : 0.f;
}

struct CubicSpline {
  static __device__ __forceinline__ void deval_x(float x, float& w,
                                                 float& dw) {
    w = 0.f;
    dw = 0.f;
    tp_term<3>(x, FL(1.0), FL(1.0), w, dw);
    tp_term<3>(x, FL(0.5), FL(-4.0), w, dw);
  }
};

struct QuarticSpline {
  static __device__ __forceinline__ void deval_x(float x, float& w,
                                                 float& dw) {
    w = 0.f;
    dw = 0.f;
    tp_term<4>(x, FL(1.0), FL(1.0), w, dw);
    tp_term<4>(x, FL(0.6), FL(-5.0), w, dw);
    tp_term<4>(x, FL(0.2), FL(10.0), w, dw);
  }
};

struct QuinticSpline {
  static __device__ __forceinline__ void deval_x(float x, float& w,
                                                 float& dw) {
    w = 0.f;
    dw = 0.f;
    tp_term<5>(x, FL(1.0), FL(1.0), w, dw);
    tp_term<5>(x, FL(2.0 / 3.0), FL(-6.0), w, dw);
    tp_term<5>(x, FL(1.0 / 3.0), FL(15.0), w, dw);
  }
};

struct WendlandC2 {
  static __device__ __forceinline__ void deval_x(float x, float& w,
                                                 float& dw) {
    const float cs[6] = {FL(4.0), FL(-15.0), FL(20.0), FL(-10.0), FL(0.0),
                         FL(1.0)};
    horner_branch(cs, x, w, dw);
  }
};

struct WendlandC4 {
  static __device__ __forceinline__ void deval_x(float x, float& w,
                                                 float& dw) {
    const float cs[9] = {FL(11.666667), FL(-64.0), FL(140.0),
                         FL(-149.333333), FL(70.0), FL(0.0),
                         FL(-9.3333333), FL(0.0), FL(1.0)};
    horner_branch(cs, x, w, dw);
  }
};

struct WendlandC6 {
  static __device__ __forceinline__ void deval_x(float x, float& w,
                                                 float& dw) {
    const float cs[12] = {FL(32.0), FL(-231.0), FL(704.0), FL(-1155.0),
                          FL(1056.0), FL(-462.0), FL(0.0), FL(66.0),
                          FL(0.0), FL(-11.0), FL(0.0), FL(1.0)};
    horner_branch(cs, x, w, dw);
  }
};

// (w, dw_du) for u = r/h: W(r, h) = w / h^3, dW/dr = dw_du / h^4
template <class K>
__device__ __forceinline__ void kernel_deval(float u, const BodyParams& p,
                                             float& w, float& dw) {
  const float x = u * p.v[P_GAMMA_INV];
  K::deval_x(x, w, dw);
  w = w * p.v[P_G3];
  dw = dw * p.v[P_G4];
}

// (F, P) softened + erfc-truncated force/potential factors
// (ops/p2p_gravity.py force_pot_factors with trunc=True: the P2P pairs
// always pair with the PM mesh).
__device__ __forceinline__ void force_pot_factors(float r2, float H_inv,
                                                  float H3_inv,
                                                  float r_s_inv,
                                                  float& F, float& P) {
  const float r_inv = r_inv_of(r2);
  const float r = r2 * r_inv;
  const float u = r * H_inv;
  float W = FL(21.0) * u - FL(90.0);
  W = W * u + FL(140.0);
  W = W * u - FL(84.0);
  W = W * u;
  W = W * u + FL(14.0);
  const float r_inv2 = r_inv * r_inv;
  const bool inside = u < 1.f;
  F = inside ? W * H3_inv : r_inv2 * r_inv;
  const float u2 = u * u;
  const float S = u2 * (FL(7.0) + u2 * (FL(-21.0) + u * (FL(28.0) + u * (
      FL(-15.0) + FL(3.0) * u))));
  P = inside ? (FL(3.0) - S) * H_inv : r_inv;
  const float x = FL(0.5) * r * r_s_inv;
  const float e = expf(-x * x);
  const float t = 1.f / (1.f + FL(0.3275911) * x);
  const float poly = t * (FL(0.254829592) + t * (FL(-0.284496736) + t * (
      FL(1.421413741) + t * (FL(-1.453152027) + t * FL(1.061405429)))));
  const float erfc = poly * e;
  F = F * (erfc + FL(2.0 * 0.5641895835477563) * x * e);
  P = P * erfc;
}

// ---------------------------------------------------------------------------
// What a scheme's density extras and gradient sums see of a pair
// ---------------------------------------------------------------------------
struct DensityPair {
  float m_j, u_j, wi, wi_dx, kick, faci, r2;
  float dx[3], dv[3];
};

struct GradientPair {
  float r_inv, r, r2, m_j;
};

// The layout constants and hooks of a scheme that a struct below does not
// declare: no u_j and no sums after the density's eight, no parameters of
// its own, SPHENIX's gradient sum (laplace_u) and no j-side extras
struct SchemeDefaults {
  static constexpr bool DENSITY_NEEDS_U = false;
  static constexpr int N_DENSITY_EXTRA = 0, NP_DENSITY = 0, NP_FORCE = 0;
  static constexpr int N_GRAD_J_EXTRA = 0, N_GRAD_SUM = 1;
  static __device__ __forceinline__ void density_extra(
      const DensityPair&, const float*, float*) {}
  // models/sph/sphenix.py gradient_terms' sum: laplace_u
  template <class K>
  static __device__ __forceinline__ void gradient_sums(
      const float* si, const float* nj, const GradientPair& q,
      const BodyParams& p, float* sums);
};

// ---------------------------------------------------------------------------
// density: fields (mask, off0-2, v0-2, h, hinv, m), and u when the scheme's
// density reads u_j (S::DENSITY_NEEDS_U); 8 sums, then the scheme's
// S::N_DENSITY_EXTRA (S::density_extra, in the reference's order);
// parameters: the kernel's 4, then the scheme's S::NP_DENSITY
// ---------------------------------------------------------------------------
template <class S, class K>
struct DensityT {
  static constexpr int F = S::DENSITY_NEEDS_U ? 11 : 10;
  static constexpr int NS = 8 + S::N_DENSITY_EXTRA, NM = 0;
  static constexpr int NP = 4 + S::NP_DENSITY;
  enum { V0 = 4, H = 7, HINV = 8, M = 9, U = 10 };
  static __device__ __forceinline__ bool in_range(
      const float* si, const float*, float r2, const BodyParams& p) {
    const float h_i = si[H];
    return r2 < p.v[P_GAMMA2] * h_i * h_i;
  }
  static __device__ __forceinline__ float lane_reach2(
      const float* si, const BodyParams& p) {
    return p.v[P_GAMMA2] * si[H] * si[H];
  }
  static __device__ __forceinline__ float row_reach2(const float*,
                                                     const BodyParams&) {
    return 0.f;
  }
  static __device__ __forceinline__ bool eval(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, float* sums, float*) {
    const bool ok = in_range(si, nj, r2, p);
    const float dv0 = si[V0] - nj[V0];
    const float dv1 = si[V0 + 1] - nj[V0 + 1];
    const float dv2 = si[V0 + 2] - nj[V0 + 2];
    const float m_j = nj[M];
    const float r_inv = r_inv_of(r2);
    const float r = r2 * r_inv;
    const float ui = r * si[HINV];
    float wi, wi_dx;
    kernel_deval<K>(ui, p, wi, wi_dx);
    const float faci = m_j * wi_dx * r_inv;
    const float dvdr = dv0 * dx0 + dv1 * dx1 + dv2 * dx2;
    const float curl0 = dv1 * dx2 - dv2 * dx1;
    const float curl1 = dv2 * dx0 - dv0 * dx2;
    const float curl2 = dv0 * dx1 - dv1 * dx0;
    const float kick = FL(3.0) * wi + ui * wi_dx;
    sums[0] = m_j * wi;
    sums[1] = -m_j * kick;
    sums[2] = wi;
    sums[3] = -kick;
    sums[4] = -faci * dvdr;
    sums[5] = faci * curl0;
    sums[6] = faci * curl1;
    sums[7] = faci * curl2;
    if constexpr (S::N_DENSITY_EXTRA > 0) {
      DensityPair q;
      q.m_j = m_j;
      q.u_j = S::DENSITY_NEEDS_U ? nj[F - 1] : 0.f;
      q.wi = wi;
      q.wi_dx = wi_dx;
      q.kick = kick;
      q.faci = faci;
      q.r2 = r2;
      q.dx[0] = dx0;
      q.dx[1] = dx1;
      q.dx[2] = dx2;
      q.dv[0] = dv0;
      q.dv[1] = dv1;
      q.dv[2] = dv2;
      S::density_extra(q, p.v + 4, sums + 8);
    }
    return ok;
  }
};

// ---------------------------------------------------------------------------
// gradient: fields (mask, off0-2, v0-2, h, hinv, m, u, rhoinv, cs, av), then
// the scheme's S::N_GRAD_J_EXTRA (Gasoline: shock_indicator, tensor_norm);
// S::N_GRAD_SUM sums (S::gradient_sums; SPHENIX's laplace_u), 2 maxes
// (v_sig, alpha_visc_max_ngb); parameters: the kernel's 4, the
// cosmology's 2
// ---------------------------------------------------------------------------
enum GradientField { GV0 = 4, GH = 7, GHINV = 8, GM = 9, GU = 10,
                     GRHOINV = 11, GCS = 12, GAV = 13, GEXTRA = 14 };

template <class K>
__device__ __forceinline__ void SchemeDefaults::gradient_sums(
    const float* si, const float* nj, const GradientPair& q,
    const BodyParams& p, float* sums) {
  const float ui = q.r * si[GHINV];
  float wi, wi_dx;
  kernel_deval<K>(ui, p, wi, wi_dx);
  const float delta_u_factor = (si[GU] - nj[GU]) * q.r_inv;
  sums[0] = q.m_j * delta_u_factor * wi_dx * nj[GRHOINV];
}

template <class S, class K>
struct GradientT {
  static constexpr int F = 14 + S::N_GRAD_J_EXTRA, NS = S::N_GRAD_SUM;
  static constexpr int NM = 2, NP = 6;
  static __device__ __forceinline__ bool in_range(
      const float* si, const float*, float r2, const BodyParams& p) {
    const float h_i = si[GH];
    return r2 < p.v[P_GAMMA2] * h_i * h_i;
  }
  static __device__ __forceinline__ float lane_reach2(
      const float* si, const BodyParams& p) {
    return p.v[P_GAMMA2] * si[GH] * si[GH];
  }
  static __device__ __forceinline__ float row_reach2(const float*,
                                                     const BodyParams&) {
    return 0.f;
  }
  static __device__ __forceinline__ bool eval(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, float* sums, float* maxes) {
    const bool ok = in_range(si, nj, r2, p);
    const float dv0 = si[GV0] - nj[GV0];
    const float dv1 = si[GV0 + 1] - nj[GV0 + 1];
    const float dv2 = si[GV0 + 2] - nj[GV0 + 2];
    GradientPair q;
    q.r_inv = r_inv_of(r2);
    q.r = r2 * q.r_inv;
    q.r2 = r2;
    q.m_j = nj[GM];
    const float dvdr = dv0 * dx0 + dv1 * dx1 + dv2 * dx2;
    const float dvdr_Hubble = dvdr + p.v[P_A2H] * r2;
    const float omega_ij = fminf(dvdr_Hubble, 0.f);
    const float mu_ij = p.v[P_FAC_MU] * q.r_inv * omega_ij;
    const float new_v_sig = si[GCS] + nj[GCS] - FL(3.0) * mu_ij;
    S::template gradient_sums<K>(si, nj, q, p, sums);
    maxes[0] = new_v_sig;
    maxes[1] = nj[GAV];
    return ok;
  }
};

// ---------------------------------------------------------------------------
// The force field layout, shared by every scheme's force bodies
// (ops/hydro_flat.py FORCE_FIELDS): (mask, off0-2, v0-2, h, m, u, rho, P,
// cs, fgh, bal, al, ad, tb, hinv, minv, rhoinv, pr2)
// ---------------------------------------------------------------------------
enum ForceField { FV0 = 4, FH = 7, FM = 8, FU = 9, FRHO = 10, FP = 11,
                  FCS = 12, FFGH = 13, FBAL = 14, FAL = 15, FAD = 16,
                  FTB = 17, FHINV = 18, FMINV = 19, FRHOINV = 20,
                  FPR2 = 21 };

struct ForceTerms {
  float a0, a1, a2, u_dt, h_dt, v_sig;
};

__device__ __forceinline__ bool hydro_ok(const float* si, const float* nj,
                                         float r2, const BodyParams& p) {
  const float hm = fmaxf(si[FH], nj[FH]);
  return r2 < p.v[P_GAMMA2] * (hm * hm);
}

// hydro_ok's r2 bound from one side's h
__device__ __forceinline__ float hydro_reach2(const float* s,
                                              const BodyParams& p) {
  return p.v[P_GAMMA2] * s[FH] * s[FH];
}

// What every scheme's force shares: the kernel gradients of both sides,
// the velocity divergence and the signal velocity
struct PairKinematics {
  float r_inv, wi_dr, wj_dr, dvdr, dvdr_Hubble, mu_ij, v_sig;
};

template <class K>
__device__ __forceinline__ PairKinematics pair_kinematics(
    const float* si, const float* nj, float dx0, float dx1, float dx2,
    float r2, const BodyParams& p) {
  PairKinematics k;
  k.r_inv = r_inv_of(r2);
  const float r = r2 * k.r_inv;

  const float hinv_i = si[FHINV], hinv_j = nj[FHINV];
  const float hid_inv = (hinv_i * hinv_i) * (hinv_i * hinv_i);
  const float xi = r * hinv_i;
  float wi, wi_dx;
  kernel_deval<K>(xi, p, wi, wi_dx);
  k.wi_dr = hid_inv * wi_dx;

  const float hjd_inv = (hinv_j * hinv_j) * (hinv_j * hinv_j);
  const float xj = r * hinv_j;
  float wj, wj_dx;
  kernel_deval<K>(xj, p, wj, wj_dx);
  k.wj_dr = hjd_inv * wj_dx;

  const float dv0 = si[FV0] - nj[FV0];
  const float dv1 = si[FV0 + 1] - nj[FV0 + 1];
  const float dv2 = si[FV0 + 2] - nj[FV0 + 2];
  k.dvdr = dv0 * dx0 + dv1 * dx1 + dv2 * dx2;
  k.dvdr_Hubble = k.dvdr + p.v[P_A2H] * r2;
  const float omega_ij = fminf(k.dvdr_Hubble, 0.f);
  k.mu_ij = p.v[P_FAC_MU] * k.r_inv * omega_ij;
  k.v_sig = si[FCS] + nj[FCS] - FL(3.0) * k.mu_ij;
  return k;
}

// the outputs every scheme's force writes from its acceleration and du/dt
__device__ __forceinline__ ForceTerms force_out(
    const float* nj, const PairKinematics& k, float dx0, float dx1,
    float dx2, float acc, float u_dt) {
  const float m_j = nj[FM];
  ForceTerms t;
  t.a0 = -m_j * acc * dx0;
  t.a1 = -m_j * acc * dx1;
  t.a2 = -m_j * acc * dx2;
  t.u_dt = u_dt;
  t.h_dt = -m_j * k.dvdr * k.r_inv * nj[FRHOINV] * k.wi_dr;
  t.v_sig = k.v_sig;
  return t;
}

// ---------------------------------------------------------------------------
// SPH schemes: each struct holds its force terms and the layout constants
// and hooks where it departs from SchemeDefaults (its density extras, its
// gradient sums and j-side fields); NP_DENSITY, NP_FORCE: the scheme's
// density and force parameters, after the body's own (`sp`).
// ---------------------------------------------------------------------------

// models/sph/sphenix.py force_terms (hydro_iact.h:343-476)
struct Sphenix : SchemeDefaults {
  template <class K>
  static __device__ __forceinline__ ForceTerms force_terms(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, const float*) {
    const PairKinematics k = pair_kinematics<K>(si, nj, dx0, dx1, dx2, r2,
                                                p);
    const float r_inv = k.r_inv, wi_dr = k.wi_dr, wj_dr = k.wj_dr;
    const float f_ij = 1.f - si[FFGH] * nj[FMINV];
    const float f_ji = 1.f - nj[FFGH] * si[FMINV];

    const float P_i = si[FP], P_j = nj[FP];
    const float rho_sum = si[FRHO] + nj[FRHO];
    const float P_sum = P_i + P_j + FL(1e-30);
    const float inv_rhoP = 1.f / (rho_sum * P_sum);
    const float rho_ij_inv = inv_rhoP * P_sum;
    const float P_sum_inv = inv_rhoP * rho_sum;
    const float alpha = si[FAL] + nj[FAL];
    const float visc = FL(-0.25) * alpha * k.v_sig * k.mu_ij
        * (si[FBAL] + nj[FBAL]) * rho_ij_inv;
    const float visc_acc_term = FL(0.5) * visc
        * (wi_dr * f_ij + wj_dr * f_ji) * r_inv;

    const float P_over_rho2_i = si[FPR2] * f_ij;
    const float P_over_rho2_j = nj[FPR2] * f_ji;
    const float sph_acc_term = (P_over_rho2_i * wi_dr
                                + P_over_rho2_j * wj_dr) * r_inv;
    const float acc = sph_acc_term + visc_acc_term;

    const float sph_du_term_i = P_over_rho2_i * k.dvdr * r_inv * wi_dr;
    const float visc_du_term = FL(0.5) * visc_acc_term * k.dvdr_Hubble;

    const float alpha_diff = (P_i * si[FAD] + P_j * nj[FAD]) * P_sum_inv;
    const float v_diff = alpha_diff * FL(0.5) * (
        sqrtf(FL(2.0) * fabsf(P_i - P_j) * rho_ij_inv)
        + fabsf(p.v[P_FAC_MU] * r_inv * k.dvdr_Hubble));
    const float diff_du_term = v_diff * (si[FU] - nj[FU]) * (
        f_ij * wi_dr * si[FRHOINV] + f_ji * wj_dr * nj[FRHOINV]);

    const float du_dt_i = sph_du_term_i + visc_du_term + diff_du_term;
    return force_out(nj, k, dx0, dx1, dx2, acc, du_dt_i * nj[FM]);
  }
};

// models/sph/minimal.py force_terms (hydro_iact.h:370-470): Monaghan
// viscosity, rho_ij = (rho_i + rho_j) / 2, the alpha in the Balsara
// factors, no diffusion
struct Minimal : SchemeDefaults {
  template <class K>
  static __device__ __forceinline__ ForceTerms force_terms(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, const float*) {
    const PairKinematics k = pair_kinematics<K>(si, nj, dx0, dx1, dx2, r2,
                                                p);
    const float r_inv = k.r_inv, wi_dr = k.wi_dr, wj_dr = k.wj_dr;
    const float f_ij = 1.f - si[FFGH] * nj[FMINV];
    const float f_ji = 1.f - nj[FFGH] * si[FMINV];
    const float rho_ij_inv = FL(2.0) / (si[FRHO] + nj[FRHO]);
    const float visc = FL(-0.25) * k.v_sig * (si[FBAL] + nj[FBAL])
        * k.mu_ij * rho_ij_inv;
    const float visc_acc_term = FL(0.5) * visc
        * (wi_dr * f_ij + wj_dr * f_ji) * r_inv;
    const float P_over_rho2_i = si[FPR2] * f_ij;
    const float P_over_rho2_j = nj[FPR2] * f_ji;
    const float sph_acc_term = (P_over_rho2_i * wi_dr
                                + P_over_rho2_j * wj_dr) * r_inv;
    const float acc = sph_acc_term + visc_acc_term;
    const float sph_du_term_i = P_over_rho2_i * k.dvdr * r_inv * wi_dr;
    const float visc_du_term = FL(0.5) * visc_acc_term * k.dvdr_Hubble;
    const float du_dt_i = sph_du_term_i + visc_du_term;
    return force_out(nj, k, dx0, dx1, dx2, acc, du_dt_i * nj[FM]);
  }
};

// models/sph/gadget2.py force_terms (hydro_iact.h:618-712): the entropy
// formulation; u_dt is the raw entropy-generation sum (end_force
// converts it)
struct Gadget2 : SchemeDefaults {
  template <class K>
  static __device__ __forceinline__ ForceTerms force_terms(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, const float*) {
    const PairKinematics k = pair_kinematics<K>(si, nj, dx0, dx1, dx2, r2,
                                                p);
    const float r_inv = k.r_inv, wi_dr = k.wi_dr, wj_dr = k.wj_dr;
    const float rho_ij_inv = FL(2.0) / (si[FRHO] + nj[FRHO]);
    const float visc = FL(-0.25) * k.v_sig * k.mu_ij
        * (si[FBAL] + nj[FBAL]) * rho_ij_inv;
    const float visc_term = FL(0.5) * visc * (wi_dr + wj_dr) * r_inv;
    const float sph_term = (si[FFGH] * si[FPR2] * wi_dr
                            + nj[FFGH] * nj[FPR2] * wj_dr) * r_inv;
    const float acc = visc_term + sph_term;
    return force_out(nj, k, dx0, dx1, dx2, acc,
                     nj[FM] * visc_term * k.dvdr_Hubble);
  }
};

// the P-U equation of motion's pressure terms, shared by PressureEnergy
// and AnarchyPU (hydro_iact.h:238-350); gm1 = gamma - 1
struct PUPressure {
  float sph_acc_term, sph_du_term_i;
};

__device__ __forceinline__ PUPressure pu_pressure(
    const float* si, const float* nj, const PairKinematics& k, float gm1) {
  const float u_i = si[FU], u_j = nj[FU];
  const float f_ij = 1.f - si[FFGH] / fmaxf(nj[FM] * u_j, FL(1e-30));
  const float f_ji = 1.f - nj[FFGH] / fmaxf(si[FM] * u_i, FL(1e-30));
  const float pressure_inverse_i = 1.f / fmaxf(si[FP], FL(1e-30));
  const float pressure_inverse_j = 1.f / fmaxf(nj[FP], FL(1e-30));
  PUPressure q;
  q.sph_acc_term = (u_j * u_i * gm1 * gm1
                    * ((f_ij * pressure_inverse_i) * k.wi_dr
                       + (f_ji * pressure_inverse_j) * k.wj_dr) * k.r_inv);
  q.sph_du_term_i = gm1 * gm1 * u_j * u_i * (f_ij * pressure_inverse_i)
      * k.wi_dr * k.dvdr * k.r_inv;
  return q;
}

// the P-U density extras (models/sph/pressure_energy.py density_terms,
// hydro_iact.h:92): m_j u_j W and its -d/dh kick
struct PUDensity : SchemeDefaults {
  static constexpr bool DENSITY_NEEDS_U = true;
  static constexpr int N_DENSITY_EXTRA = 2;
  static __device__ __forceinline__ void density_extra(
      const DensityPair& q, const float*, float* sums) {
    const float mjuj = q.m_j * q.u_j;
    sums[0] = mjuj * q.wi;
    sums[1] = -mjuj * q.kick;
  }
};

// models/sph/pressure_energy.py force_terms with the Balsara factors
// bal_i, bal_j: Pressure-Energy's (the constant alpha folded in) or
// Pressure-Energy-Monaghan's (scaled by alpha_ij)
template <class K>
__device__ __forceinline__ ForceTerms pressure_energy_force(
    const float* si, const float* nj, float dx0, float dx1, float dx2,
    float r2, const BodyParams& p, float gm1, float bal_i, float bal_j) {
  const PairKinematics k = pair_kinematics<K>(si, nj, dx0, dx1, dx2, r2,
                                              p);
  const float rho_ij_inv = FL(2.0) / (si[FRHO] + nj[FRHO]);
  const float visc = FL(-0.25) * k.v_sig * k.mu_ij * (bal_i + bal_j)
      * rho_ij_inv;
  const float visc_acc_term = FL(0.5) * visc * (k.wi_dr + k.wj_dr)
      * k.r_inv;
  const PUPressure q = pu_pressure(si, nj, k, gm1);
  const float acc = q.sph_acc_term + visc_acc_term;
  const float visc_du_term = FL(0.5) * visc_acc_term * k.dvdr_Hubble;
  const float du_dt_i = q.sph_du_term_i + visc_du_term;
  return force_out(nj, k, dx0, dx1, dx2, acc, du_dt_i * nj[FM]);
}

// models/sph/pressure_energy.py: the smoothed-pressure density extras and
// force_terms, constant alpha in the Balsara factors; parameter gm1
struct PressureEnergy : PUDensity {
  static constexpr int NP_FORCE = 1;
  template <class K>
  static __device__ __forceinline__ ForceTerms force_terms(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, const float* sp) {
    return pressure_energy_force<K>(si, nj, dx0, dx1, dx2, r2, p, sp[0],
                                    si[FBAL], nj[FBAL]);
  }
};

// models/sph/pressure_energy_mm.py force_terms (hydro_iact.h:296-310):
// Pressure-Energy's with alpha_ij = (alpha_i + alpha_j) / 2 on the bare
// Balsara factors; Pressure-Energy's density; parameter gm1
struct PressureEnergyMM : PUDensity {
  static constexpr int NP_FORCE = 1;
  template <class K>
  static __device__ __forceinline__ ForceTerms force_terms(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, const float* sp) {
    const float alpha_ij = FL(0.5) * (si[FAL] + nj[FAL]);
    return pressure_energy_force<K>(si, nj, dx0, dx1, dx2, r2, p, sp[0],
                                    si[FBAL] * alpha_ij,
                                    nj[FBAL] * alpha_ij);
  }
};

// models/sph/anarchy_pu.py force_terms (hydro_iact.h:330-440): the P-U
// equation of motion with summed alphas and the soundspeed-triggered
// diffusion; Pressure-Energy's density; parameter gm1
struct AnarchyPU : PUDensity {
  static constexpr int NP_FORCE = 1;
  template <class K>
  static __device__ __forceinline__ ForceTerms force_terms(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, const float* sp) {
    const PairKinematics k = pair_kinematics<K>(si, nj, dx0, dx1, dx2, r2,
                                                p);
    const float rho_ij_inv = 1.f / (si[FRHO] + nj[FRHO]);
    const float alpha = si[FAL] + nj[FAL];
    const float visc = FL(-0.25) * alpha * k.v_sig * k.mu_ij
        * (si[FBAL] + nj[FBAL]) * rho_ij_inv;
    const float visc_acc_term = FL(0.5) * visc * (k.wi_dr + k.wj_dr)
        * k.r_inv;
    const PUPressure q = pu_pressure(si, nj, k, sp[0]);
    const float acc = q.sph_acc_term + visc_acc_term;
    const float visc_du_term = FL(0.5) * visc_acc_term * k.dvdr_Hubble;
    const float v_diff = fmaxf(si[FCS] + nj[FCS] + k.mu_ij, 0.f);
    const float alpha_diff = FL(0.5) * (si[FAD] + nj[FAD]);
    const float diff_du_term = alpha_diff * p.v[P_FAC_MU] * v_diff
        * (si[FU] - nj[FU]) * (k.wi_dr + k.wj_dr) * rho_ij_inv;
    const float du_dt_i = q.sph_du_term_i + visc_du_term + diff_du_term;
    return force_out(nj, k, dx0, dx1, dx2, acc, du_dt_i * nj[FM]);
  }
};

// models/sph/pressure_entropy.py (hydro_iact.h:55-100, :356-444): the
// weighted-density sums m_j A_j^{1/gamma} W and its kick, and the
// Hopkins cross-entropy equation of motion with rho_bar = (P_bar /
// A)^{1/gamma} per pair; u carries the entropic function A, P the
// smoothed pressure; u_dt is the raw viscous entropy generation (end_force
// converts it); parameter 1/gamma in density and force
__device__ __forceinline__ float s_gamma(float A, float g_inv) {
  return powf(fmaxf(A, FL(1e-30)), g_inv);
}

struct PressureEntropy : SchemeDefaults {
  static constexpr bool DENSITY_NEEDS_U = true;
  static constexpr int N_DENSITY_EXTRA = 2, NP_DENSITY = 1, NP_FORCE = 1;
  static __device__ __forceinline__ void density_extra(
      const DensityPair& q, const float* sp, float* sums) {
    const float mSj = q.m_j * s_gamma(q.u_j, sp[0]);
    sums[0] = mSj * q.wi;
    sums[1] = -mSj * q.kick;
  }
  template <class K>
  static __device__ __forceinline__ ForceTerms force_terms(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, const float* sp) {
    const PairKinematics k = pair_kinematics<K>(si, nj, dx0, dx1, dx2, r2,
                                                p);
    const float g_inv = sp[0];
    const float u_i = si[FU], u_j = nj[FU];
    const float P_i = si[FP], P_j = nj[FP];
    const float S_i = s_gamma(u_i, g_inv);
    const float S_j = s_gamma(u_j, g_inv);
    const float rho_bar_i = powf(fmaxf(P_i, FL(1e-30))
                                 / fmaxf(u_i, FL(1e-30)), g_inv);
    const float rho_bar_j = powf(fmaxf(P_j, FL(1e-30))
                                 / fmaxf(u_j, FL(1e-30)), g_inv);
    const float P2_i = P_i / (rho_bar_i * rho_bar_i);
    const float P2_j = P_j / (rho_bar_j * rho_bar_j);
    const float rho_ij_inv = FL(2.0) / (si[FRHO] + nj[FRHO]);
    const float visc = FL(-0.25) * k.v_sig * k.mu_ij
        * (si[FBAL] + nj[FBAL]) * rho_ij_inv;
    const float visc_term = FL(0.5) * visc * (k.wi_dr + k.wj_dr);
    const float sph_term = ((S_j / S_i - si[FFGH] / S_i) * P2_i * k.wi_dr
                            + (S_i / S_j - nj[FFGH] / S_j) * P2_j
                            * k.wj_dr);
    const float acc = (visc_term + sph_term) * k.r_inv;
    return force_out(nj, k, dx0, dx1, dx2, acc,
                     nj[FM] * visc_term * k.r_inv * k.dvdr_Hubble);
  }
};

// models/sph/phantom.py (hydro_iact.h:240, :330-400): a gradient that
// keeps only the maxes (laplace_u = 0); the force with the viscosity
// convolved per particle density (the alpha in the Balsara factors) and
// Price's diffusion with constant alphas
struct Phantom : SchemeDefaults {
  template <class K>
  static __device__ __forceinline__ void gradient_sums(
      const float*, const float*, const GradientPair&, const BodyParams&,
      float* sums) {
    sums[0] = 0.f;
  }
  template <class K>
  static __device__ __forceinline__ ForceTerms force_terms(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, const float*) {
    const PairKinematics k = pair_kinematics<K>(si, nj, dx0, dx1, dx2, r2,
                                                p);
    const float r_inv = k.r_inv, wi_dr = k.wi_dr, wj_dr = k.wj_dr;
    const float f_ij = 1.f - si[FFGH] * nj[FMINV];
    const float f_ji = 1.f - nj[FFGH] * si[FMINV];
    const float visc = FL(-0.125) * k.v_sig * k.mu_ij
        * (si[FBAL] + nj[FBAL]);
    const float kernel_mean = (wi_dr * f_ij * si[FRHOINV]
                               + wj_dr * f_ji * nj[FRHOINV]);
    const float visc_acc_term = FL(0.5) * visc * kernel_mean * r_inv;
    const float P_over_rho2_i = si[FPR2] * f_ij;
    const float P_over_rho2_j = nj[FPR2] * f_ji;
    const float sph_acc_term = (P_over_rho2_i * wi_dr
                                + P_over_rho2_j * wj_dr) * r_inv;
    const float acc = sph_acc_term + visc_acc_term;
    const float sph_du_term_i = P_over_rho2_i * k.dvdr * r_inv * wi_dr;
    const float visc_du_term = FL(0.5) * visc_acc_term * k.dvdr_Hubble;
    const float v_diff = sqrtf(FL(2.0) * fabsf(si[FP] - nj[FP])
                               / (si[FRHO] + nj[FRHO]))
        + k.dvdr_Hubble * r_inv;
    const float alpha_diff = FL(0.5) * (si[FAD] + nj[FAD]);
    const float diff_du_term = alpha_diff * v_diff * (si[FU] - nj[FU])
        * FL(0.5) * kernel_mean;
    const float du_dt_i = sph_du_term_i + visc_du_term + diff_du_term;
    return force_out(nj, k, dx0, dx1, dx2, acc, du_dt_i * nj[FM]);
  }
};

// models/sph/gasoline.py (hydro_iact.h:128-173, :273-339, :460-559): the
// density's 13 extras (grad_P0-2, vgrad00-22, weighted_wcount), the
// gradient's shock-limiter and correction-weight sums over the
// neighbours' shock_indicator and tensor_norm (its two j-side fields),
// and the geometric-density force with the kernel correction f
struct Gasoline : SchemeDefaults {
  static constexpr bool DENSITY_NEEDS_U = true;
  static constexpr int N_DENSITY_EXTRA = 13;
  static constexpr int N_GRAD_J_EXTRA = 2, N_GRAD_SUM = 2;
  static __device__ __forceinline__ void density_extra(
      const DensityPair& q, const float*, float* sums) {
    const float fac = q.faci;
#pragma unroll
    for (int k = 0; k < 3; ++k) sums[k] = fac * q.u_j * q.dx[k];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) sums[3 + 3 * i + j] = fac * q.dv[i]
          * q.dx[j];
    sums[12] = fac * q.r2;
  }
  template <class K>
  static __device__ __forceinline__ void gradient_sums(
      const float* si, const float* nj, const GradientPair& q,
      const BodyParams& p, float* sums) {
    const float ui = q.r * si[GHINV];
    float wi, wi_dx;
    kernel_deval<K>(ui, p, wi, wi_dx);
    const float shock_j = nj[GEXTRA], tensor_j = nj[GEXTRA + 1];
    const float shock_ratio_j = tensor_j > 0.f
        ? shock_j / fmaxf(tensor_j, FL(1e-30)) : 0.f;
    sums[0] = q.m_j * shock_ratio_j * wi;
    sums[1] = q.m_j * q.r2 * wi_dx * nj[GRHOINV] * q.r_inv;
  }
  template <class K>
  static __device__ __forceinline__ ForceTerms force_terms(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, const float*) {
    const PairKinematics k = pair_kinematics<K>(si, nj, dx0, dx1, dx2, r2,
                                                p);
    const float r_inv = k.r_inv;
    const float kernel_gradient = FL(0.5) * (k.wi_dr * si[FFGH]
                                             + k.wj_dr * nj[FFGH]);
    const float rho_ij = si[FRHO] + nj[FRHO];
    const float alpha = si[FAL] + nj[FAL];
    const float omega_ij = fminf(k.dvdr_Hubble, 0.f);
    const float visc = omega_ij < 0.f
        ? (FL(-0.25) * alpha * (si[FCS] + nj[FCS]) * k.mu_ij
           + FL(3.0) * k.mu_ij * k.mu_ij) / (FL(0.5) * rho_ij)
        : 0.f;
    const float visc_acc_term = visc * kernel_gradient * r_inv;
    const float rr_inv = si[FRHOINV] * nj[FRHOINV];
    const float sph_acc_term = (si[FP] + nj[FP]) * r_inv * kernel_gradient
        * rr_inv;
    const float acc = sph_acc_term + visc_acc_term;
    const float sph_du_term_i = si[FP] * k.dvdr * r_inv * kernel_gradient
        * rr_inv;
    const float visc_du_term = FL(0.5) * visc_acc_term * k.dvdr_Hubble;
    const float diff_du_term = FL(2.0) * (si[FAD] + nj[FAD])
        * (si[FU] - nj[FU]) * kernel_gradient / rho_ij;
    const float du_dt_i = sph_du_term_i + visc_du_term + diff_du_term;
    return force_out(nj, k, dx0, dx1, dx2, acc, du_dt_i * nj[FM]);
  }
};

// models/sph/none.py: no hydro force, every sum and the signal velocity 0
struct NoneScheme : SchemeDefaults {
  template <class K>
  static __device__ __forceinline__ ForceTerms force_terms(
      const float*, const float*, float, float, float, float,
      const BodyParams&, const float*) {
    return ForceTerms{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }
};

// ---------------------------------------------------------------------------
// force: 5 sums (a_hydro0-2, u_dt, h_dt), 2 maxes (v_sig, -neighbour bin);
// parameters: the kernel's 4, the cosmology's 2, then the scheme's
// ---------------------------------------------------------------------------
template <class S, class K>
struct ForceT {
  static constexpr int F = 22, NS = 5, NM = 2, NP = 6 + S::NP_FORCE;
  static __device__ __forceinline__ bool in_range(
      const float* si, const float* nj, float r2, const BodyParams& p) {
    return hydro_ok(si, nj, r2, p);
  }
  static __device__ __forceinline__ float lane_reach2(
      const float* si, const BodyParams& p) {
    return hydro_reach2(si, p);
  }
  static __device__ __forceinline__ float row_reach2(const float* nj,
                                                     const BodyParams& p) {
    return hydro_reach2(nj, p);
  }
  static __device__ __forceinline__ bool eval(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, float* sums, float* maxes) {
    const bool ok = in_range(si, nj, r2, p);
    const ForceTerms t = S::template force_terms<K>(si, nj, dx0, dx1, dx2,
                                                    r2, p, p.v + 6);
    sums[0] = t.a0;
    sums[1] = t.a1;
    sums[2] = t.a2;
    sums[3] = t.u_dt;
    sums[4] = t.h_dt;
    const float tb = nj[FTB];
    maxes[0] = t.v_sig;
    maxes[1] = tb > 0.f ? -tb : FL(-64.0);
    return ok;
  }
};

// gravity parameters after the hydro ones:
// (r_cut2, H_inv, H3_inv, r_s_inv, G)
constexpr int P_RCUT2 = 6, P_HINV = 7, P_H3INV = 8, P_RSINV = 9, P_G = 10;

// ---------------------------------------------------------------------------
// force + short-range gravity, fused: 9 sums (hydro 5 masked by the hydro
// range, a_grav0-2 and pot masked by r_cut), 2 maxes; force fields + gm;
// parameters: the kernel's 4, the cosmology's 2, the gravity's 5, then
// the scheme's
// ---------------------------------------------------------------------------
template <class S, class K>
struct ForceGravityT {
  static constexpr int F = 23, NS = 9, NM = 2, NP = 11 + S::NP_FORCE;
  enum { GM = 22 };
  static __device__ __forceinline__ bool in_range(
      const float* si, const float* nj, float r2, const BodyParams& p) {
    return hydro_ok(si, nj, r2, p) || r2 < p.v[P_RCUT2];
  }
  static __device__ __forceinline__ float lane_reach2(
      const float* si, const BodyParams& p) {
    return hydro_reach2(si, p);
  }
  static __device__ __forceinline__ float row_reach2(const float* nj,
                                                     const BodyParams& p) {
    return fmaxf(hydro_reach2(nj, p), p.v[P_RCUT2]);
  }
  static __device__ __forceinline__ bool eval(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, float* sums, float* maxes) {
    const bool ok_h = hydro_ok(si, nj, r2, p);
    const ForceTerms t = S::template force_terms<K>(si, nj, dx0, dx1, dx2,
                                                    r2, p, p.v + 11);
    const float wh = ok_h ? 1.f : 0.f;
    const bool ok_g = r2 < p.v[P_RCUT2];
    float Fg, Pg;
    force_pot_factors(r2, p.v[P_HINV], p.v[P_H3INV], p.v[P_RSINV], Fg,
                      Pg);
    const float gm = (p.v[P_G] * (ok_g ? 1.f : 0.f)) * nj[GM];
    const float gmF = gm * Fg;
    sums[0] = t.a0 * wh;
    sums[1] = t.a1 * wh;
    sums[2] = t.a2 * wh;
    sums[3] = t.u_dt * wh;
    sums[4] = t.h_dt * wh;
    sums[5] = -gmF * dx0;
    sums[6] = -gmF * dx1;
    sums[7] = -gmF * dx2;
    sums[8] = -gm * Pg;
    const float tb = nj[FTB];
    maxes[0] = ok_h ? t.v_sig : -INFINITY;
    maxes[1] = (ok_h && tb > 0.f) ? -tb : FL(-64.0);
    return ok_h || ok_g;
  }
};

// the packed and ring kernels' bodies, and the flat kernel's default
// library: SPHENIX with the cubic spline
using Density = DensityT<Sphenix, CubicSpline>;
using Gradient = GradientT<Sphenix, CubicSpline>;
using Force = ForceT<Sphenix, CubicSpline>;
using ForceGravity = ForceGravityT<Sphenix, CubicSpline>;

// ---------------------------------------------------------------------------
// P2P gravity: fields (mask, off0-2, h, m); 4 sums (acc0-2, pot);
// parameters (r_cut2, H_inv, H3_inv, r_s_inv, G)
// ---------------------------------------------------------------------------
struct P2PGravity {
  static constexpr int F = 6, NS = 4, NM = 0, NP = 5;
  enum { M = 5 };
  static __device__ __forceinline__ bool in_range(
      const float*, const float*, float r2, const BodyParams& p) {
    return r2 < p.v[0];
  }
  static __device__ __forceinline__ float lane_reach2(const float*,
                                                      const BodyParams&) {
    return 0.f;
  }
  static __device__ __forceinline__ float row_reach2(const float*,
                                                     const BodyParams& p) {
    return p.v[0];
  }
  static __device__ __forceinline__ bool eval(
      const float* si, const float* nj, float dx0, float dx1, float dx2,
      float r2, const BodyParams& p, float* sums, float*) {
    const bool ok = in_range(si, nj, r2, p);
    float Fg, Pg;
    force_pot_factors(r2, p.v[1], p.v[2], p.v[3], Fg, Pg);
    const float gm = p.v[4] * nj[M];
    const float gmF = gm * Fg;
    sums[0] = -gmF * dx0;
    sums[1] = -gmF * dx1;
    sums[2] = -gmF * dx2;
    sums[3] = -gm * Pg;
    return ok;
  }
};

// ---------------------------------------------------------------------------
// timebin (the limiter's wake scan): fields (mask, off0-2, h, tb, act);
// 1 max (-neighbour bin of ACTIVE j whose own kernel reaches i);
// parameter gamma2
// ---------------------------------------------------------------------------
struct Timebin {
  static constexpr int F = 7, NS = 0, NM = 1, NP = 1;
  enum { H = 4, TB = 5, ACT = 6 };
  static __device__ __forceinline__ bool in_range(
      const float*, const float* nj, float r2, const BodyParams& p) {
    const float h_j = nj[H];
    return (nj[ACT] > 0.f) && (r2 < p.v[P_GAMMA2] * h_j * h_j)
        && (nj[TB] > 0.f);
  }
  static __device__ __forceinline__ float lane_reach2(const float*,
                                                      const BodyParams&) {
    return 0.f;
  }
  // rows of inactive or binless j are accepted by no slot
  static __device__ __forceinline__ float row_reach2(const float* nj,
                                                     const BodyParams& p) {
    return (nj[ACT] > 0.f && nj[TB] > 0.f)
        ? p.v[P_GAMMA2] * nj[H] * nj[H] : -1.f;
  }
  static __device__ __forceinline__ bool eval(
      const float* si, const float* nj, float, float, float, float r2,
      const BodyParams& p, float*, float* maxes) {
    const float tb = nj[TB];
    maxes[0] = tb > 0.f ? -tb : FL(-64.0);
    return in_range(si, nj, r2, p);
  }
};

// ---------------------------------------------------------------------------
// chemistry smoothing (chemistry/EAGLE/chemistry_iact.h; the reference's
// XLA ops/stencil.py:597 chemistry_smooth_loop): fields (mask, off0-2, h,
// hinv, m, Z, e0-e8); 10 sums, m_j W(r, h_i) times Z_j and each element
// fraction e_j[k], over the pairs with (r hinv_i)^2 < gamma2 (the
// reference's u2 test; ops/stencil.py and ops/hydro_flat.py compute the
// same)
// ---------------------------------------------------------------------------
struct ChemSmooth {
  static constexpr int F = 17, NS = 10, NM = 0, NP = 4;
  enum { H = 4, HINV = 5, M = 6, Z = 7, E0 = 8 };
  static __device__ __forceinline__ bool in_range(
      const float* si, const float*, float r2, const BodyParams& p) {
    const float u2 = r2 * si[HINV] * si[HINV];
    return u2 < p.v[P_GAMMA2];
  }
  // u2 < gamma2 bounds r2 by gamma2 h^2 up to the rounding of hinv, which
  // the warp filter's slack covers
  static __device__ __forceinline__ float lane_reach2(
      const float* si, const BodyParams& p) {
    return p.v[P_GAMMA2] * si[H] * si[H];
  }
  static __device__ __forceinline__ float row_reach2(const float*,
                                                     const BodyParams&) {
    return 0.f;
  }
  static __device__ __forceinline__ bool eval(
      const float* si, const float* nj, float, float, float, float r2,
      const BodyParams& p, float* sums, float*) {
    const float u2 = r2 * si[HINV] * si[HINV];
    float w, dw;
    kernel_deval<CubicSpline>(sqrtf(u2), p, w, dw);
    const float mw = nj[M] * w;
    sums[0] = mw * nj[Z];
#pragma unroll
    for (int k = 0; k < 9; ++k) sums[1 + k] = mw * nj[E0 + k];
    return u2 < p.v[P_GAMMA2];
  }
};

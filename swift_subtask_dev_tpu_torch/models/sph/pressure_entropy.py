"""Pressure-Entropy (P-A) SPH in torch: the smoothed-pressure formulation
that evolves the entropic function.

Port of the reference's ``models/sph/pressure_entropy.py`` (SWIFT's
src/hydro/PressureEntropy/, Hopkins 2013).  The evolved variable is the
entropic function A = P / rho^gamma in the engine's ``u`` slots (as
Gadget2's), and the density loop also sums the weighted density
rho_bar_i = (1 / A_i^{1/gamma}) sum_j m_j A_j^{1/gamma} W_ij
(hydro_iact.h:79, hydro.h:522-526), so that the smoothed pressure is
P_bar = A rho_bar^gamma.  The equation of motion is the Hopkins
cross-entropy form (S_j / S_i - f_i / S_i) P_bar_i / rho_bar_i^2 grad W
(hydro_iact.h:398-441) with the two-factor grad-h term f
(hydro.h:684-705); constant-alpha Monaghan viscosity with the Balsara
switch; no gradient loop; end_force converts the raw viscous entropy
generation to dA/dt (hydro.h:825-833).

``DENSITY_NEEDS_U`` puts A_j in the density body's fields and
``DENSITY_EXTRA_KEYS`` adds the two weighted-density sums; the density
and force bodies take 1/gamma (``density_params``, ``force_params``).
The pair terms are ``PressureEntropy`` in ``csrc/pair_bodies.cuh``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from . import gadget2, sphenix
from .eos import IdealGas
from .kernels import CUBIC_SPLINE, SPHKernel
from .sphenix import (CONST_VISCOSITY_BETA, HYDRO_DIM, HYDRO_DIM_INV,
                      CosmoFactors, _cube, _safe_h)

NAME = "pressure-entropy"
CUDA_STRUCT = "PressureEntropy"
HAS_GRADIENT_LOOP = False
DENSITY_NEEDS_U = True                      # u_j = A_j for the rho_bar sum
DENSITY_EXTRA_KEYS = ("rho_bar", "rho_bar_dh")
EXTRA_STATE_KEYS = ("rho_bar", "rho_bar_dh")
EXTRA_STATE_INT_KEYS = ()
GRADIENT_SUM_KEYS = sphenix.GRADIENT_SUM_KEYS
GRADIENT_J_EXTRA = ()
PREPARE_GRADIENT_KEYS = sphenix.PREPARE_GRADIENT_KEYS
GRADIENT_END_KEYS = sphenix.GRADIENT_END_KEYS
PREPARE_FORCE_KEYS = sphenix.PREPARE_FORCE_KEYS

ghost_h_update = sphenix.ghost_h_update
reset_acceleration = sphenix.reset_acceleration
compute_timestep = sphenix.compute_timestep
timestep_h_change_limit = sphenix.timestep_h_change_limit
init_part = sphenix.init_part
# the entropy kick is Gadget2's (the 0.5x floor and the minimal-energy
# bound, hydro.h:848-880)
kick_extra = gadget2.kick_extra
# IC conversions (hydro_convert_quantities, hydro.h:887-915): at IC time
# rho_bar ~ rho for a near-uniform entropy
entropy_from_internal_energy = gadget2.entropy_from_internal_energy
internal_energy_from_entropy = gadget2.internal_energy_from_entropy
_f32 = gadget2._f32


@dataclass(frozen=True)
class PressureEntropyParams:
    """SPH: YAML section for the P-A scheme (hydro_parameters.h)."""

    kernel: SPHKernel = CUBIC_SPLINE
    eos: IdealGas = field(default_factory=IdealGas)
    eta_neighbours: float = 1.2348
    h_tolerance: float = 1e-4
    CFL: float = 0.1
    h_max: float = 1e30
    h_min: float = 0.0
    minimal_internal_energy: float = 0.0
    log_max_h_change: float = 0.0953101798  # ln(1.1)
    viscosity_alpha: float = 0.8            # constant (no evolution)
    diffusion_alpha: float = 0.0

    @property
    def eta_dim(self) -> float:
        return self.eta_neighbours ** 3

    @property
    def mod(self):
        return _THIS_MODULE


def _g_inv(p) -> float:
    """1/gamma as the reference takes it: jnp.float32(1.0 / gamma)."""
    return _f32(1.0 / p.eos.gamma)


def density_params(p) -> tuple:
    """The density body's own parameters: 1/gamma (A_j^{1/gamma})."""
    return (_g_inv(p),)


def force_params(p) -> tuple:
    """The force body's own parameters: 1/gamma (S and rho_bar)."""
    return (_g_inv(p),)


def _s_gamma(p, A):
    """A^{1/gamma} (pow_one_over_gamma) with the padded-slot guard."""
    return torch.clamp_min(A, 1e-30) ** _g_inv(p)


def density_terms(p: PressureEntropyParams, dx, r2, hinv_i, m_j, dv, u_j):
    """Density + weighted-density contributions (hydro_iact.h:55-100):
    rho_bar sums m_j A_j^{1/gamma} W, rho_bar_dh its -d/dh kick."""
    base = sphenix.density_terms(p, dx, r2, hinv_i, m_j, dv)
    r_inv = sphenix._r_inv(r2)
    r = r2 * r_inv
    ui = r * hinv_i
    wi, wi_dx = p.kernel.deval(ui)
    kick = HYDRO_DIM * wi + ui * wi_dx
    mSj = m_j * _s_gamma(p, u_j)
    return {**base, "rho_bar": mSj * wi, "rho_bar_dh": -mSj * kick}


def end_density(p: PressureEntropyParams, s, cosmo: CosmoFactors):
    """Self terms + h factors + the 1/S_i normalisation of rho_bar
    (hydro_end_density, hydro.h:493-533)."""
    out = sphenix.end_density(p, s, cosmo)
    h_inv = 1.0 / _safe_h(s)
    h_inv_dim = _cube(h_inv)
    S_i = _s_gamma(p, s["u"])
    mS = s["m"] * S_i
    kroot = p.kernel.root
    rho_bar = (s["rho_bar"] + mS * kroot) * h_inv_dim / S_i
    rho_bar_dh = (s["rho_bar_dh"] - HYDRO_DIM * mS * kroot) \
        * h_inv_dim * h_inv
    return {**out, "rho_bar": rho_bar, "rho_bar_dh": rho_bar_dh}


def no_neighbours_fallback(p: PressureEntropyParams, s):
    """hydro_part_has_no_neighbours (hydro.h:581-609)."""
    out = sphenix.no_neighbours_fallback(p, s)
    h_inv_dim = _cube(1.0 / _safe_h(s))
    none = s["wcount"] * _cube(s["h"]) < 1e-5 * p.eta_dim
    rho_bar = torch.where(none, s["m"] * p.kernel.root * h_inv_dim,
                          s["rho_bar"])
    rho_bar_dh = torch.where(none, 0.0, s["rho_bar_dh"])
    return {**out, "rho_bar": rho_bar, "rho_bar_dh": rho_bar_dh}


def _pressure_soundspeed(p, A, rho_bar):
    """P_bar = A rho_bar^gamma and the sound speed from it."""
    g = _f32(p.eos.gamma)
    rb = torch.clamp_min(rho_bar, 1e-30)
    pressure = A * rb ** g
    return pressure, torch.sqrt(g * torch.clamp_min(pressure, 0.0) / rb)


def prepare_gradient(p: PressureEntropyParams, s, cosmo: CosmoFactors):
    """P_bar, its sound speed, the Balsara switch with the constant alpha
    folded in, and the two-factor grad-h term
    f = [1 / (1 + h rho_dh / (3 rho))] [rho_bar_dh h / (3 rho)]
    (hydro_prepare_force, hydro.h:626-705)."""
    rho = torch.clamp_min(s["rho"], 1e-30)
    pressure, soundspeed = _pressure_soundspeed(
        p, torch.clamp_min(s["u"], 0.0), s["rho_bar"])

    rv = s["rot_v"]
    curl_v = torch.sqrt(torch.sum(rv * rv, dim=-1))
    abs_div_v = torch.abs(s["div_v"])
    balsara = p.viscosity_alpha * abs_div_v / (
        abs_div_v + curl_v + 1e-30
        + 0.0001 * soundspeed * cosmo.a_factor_Balsara_eps
        / torch.clamp_min(s["h"], 1e-30))

    rho_dh = torch.where(s["h"] > 0.9999 * p.h_max, 0.0, s["rho_dh"])
    common = HYDRO_DIM_INV * s["h"] / rho
    grad_rho_term = common * rho_dh
    rho_dh_term = torch.where(grad_rho_term < -0.9999, 1.0,
                              1.0 / (1.0 + grad_rho_term))
    pressure_dh_term = s["rho_bar_dh"] * common
    return {**s, "f_gradh": rho_dh_term * pressure_dh_term,
            "pressure": pressure, "soundspeed": soundspeed,
            "balsara": balsara}


def reset_gradient(s):
    return {**s, "v_sig": 2.0 * s["soundspeed"],
            "alpha_visc_max_ngb": s["alpha_visc"]}


def gradient_terms(*args, **kw):  # pragma: no cover - scheme has no loop
    raise RuntimeError("PressureEntropy scheme has no gradient loop")


def end_gradient(s):
    return s


def prepare_force(p: PressureEntropyParams, s, cosmo: CosmoFactors,
                  dt_alpha):
    """Constant alpha: nothing evolves."""
    return s


def force_terms(p: PressureEntropyParams, dx, r2, hinv_i, hinv_j, m_i, m_j,
                minv_i, minv_j, dv,
                rho_i, rho_j, rhoinv_i, rhoinv_j, pr2_i, pr2_j,
                P_i, P_j, cs_i, cs_j, f_i, f_j,
                balsara_i, balsara_j, alpha_i, alpha_j,
                alpha_diff_i, alpha_diff_j, u_i, u_j,
                cosmo: CosmoFactors):
    """P-A equation of motion (runner_iact_nonsym_force,
    hydro_iact.h:356-444).  P_i/P_j carry P_bar; rho_bar is recovered per
    pair as (P_bar / A)^{1/gamma}, so P_bar / rho_bar^2 needs no state
    slot of its own; u_i/u_j carry A.  u_dt is the raw viscous entropy
    generation (end_force converts it)."""
    r_inv = sphenix._r_inv(r2)
    r = r2 * r_inv

    hid_inv = (hinv_i * hinv_i) * (hinv_i * hinv_i)
    xi = r * hinv_i
    wi, wi_dx = p.kernel.deval(xi)
    wi_dr = hid_inv * wi_dx

    hjd_inv = (hinv_j * hinv_j) * (hinv_j * hinv_j)
    xj = r * hinv_j
    wj, wj_dx = p.kernel.deval(xj)
    wj_dr = hjd_inv * wj_dx

    dvdr = dv[0] * dx[0] + dv[1] * dx[1] + dv[2] * dx[2]
    dvdr_Hubble = dvdr + cosmo.a * cosmo.a * cosmo.H * r2
    omega_ij = torch.clamp_max(dvdr_Hubble, 0.0)
    mu_ij = cosmo.fac_mu * r_inv * omega_ij

    v_sig = cs_i + cs_j - CONST_VISCOSITY_BETA * mu_ij

    S_i = _s_gamma(p, u_i)
    S_j = _s_gamma(p, u_j)
    g_inv = _g_inv(p)
    rho_bar_i = (torch.clamp_min(P_i, 1e-30)
                 / torch.clamp_min(u_i, 1e-30)) ** g_inv
    rho_bar_j = (torch.clamp_min(P_j, 1e-30)
                 / torch.clamp_min(u_j, 1e-30)) ** g_inv
    P2_i = P_i / (rho_bar_i * rho_bar_i)
    P2_j = P_j / (rho_bar_j * rho_bar_j)

    rho_ij_inv = 2.0 / (rho_i + rho_j)
    visc = -0.25 * v_sig * mu_ij * (balsara_i + balsara_j) * rho_ij_inv
    visc_term = 0.5 * visc * (wi_dr + wj_dr)
    sph_term = ((S_j / S_i - f_i / S_i) * P2_i * wi_dr
                + (S_i / S_j - f_j / S_j) * P2_j * wj_dr)
    acc = (visc_term + sph_term) * r_inv

    return {
        "sum": {
            "a_hydro0": -m_j * acc * dx[0],
            "a_hydro1": -m_j * acc * dx[1],
            "a_hydro2": -m_j * acc * dx[2],
            "u_dt": m_j * visc_term * r_inv * dvdr_Hubble,
            "h_dt": -m_j * dvdr * r_inv * rhoinv_j * wi_dr,
        },
        "max": {"v_sig": v_sig},
    }


def end_force(p: PressureEntropyParams, s):
    """hydro_end_force (hydro.h:825-833): the h_dt dimension factor, and
    dA/dt = 0.5 (gamma - 1) rho_bar^(1 - gamma) times the raw sum."""
    g = _f32(p.eos.gamma)
    rb = torch.clamp_min(s["rho_bar"], 1e-30)
    return {**s,
            "h_dt": s["h_dt"] * s["h"] * HYDRO_DIM_INV,
            "u_dt": 0.5 * (g - 1.0) * s["u_dt"] * rb ** (1.0 - g)}


def predict_extra(p: PressureEntropyParams, s, cosmo: CosmoFactors,
                  dt_drift, dt_therm):
    """Drift A, h, rho and rho_bar (hydro_predict_extra,
    hydro.h:761-815); P_bar and c_s from the drifted (rho_bar, A)."""
    A = torch.clamp_min(s["u"] + s["u_dt"] * dt_therm, 0.0)
    h_inv = 1.0 / _safe_h(s)
    w1 = s["h_dt"] * h_inv * dt_drift
    h = torch.clamp(s["h"] * torch.exp(w1), 0.0, p.h_max)
    volume_fac = torch.exp(-HYDRO_DIM * w1)
    rho = s["rho"] * volume_fac
    rho_bar = s["rho_bar"] * volume_fac
    min_u = p.minimal_internal_energy / cosmo.a_factor_internal_energy
    A = torch.maximum(A, gadget2._entropy_from_u(p, rho, min_u))
    pressure, soundspeed = _pressure_soundspeed(p, A, rho_bar)
    v_sig = torch.maximum(s["v_sig"], 2.0 * soundspeed)
    return {**s, "u": A, "h": h, "rho": rho, "rho_bar": rho_bar,
            "pressure": pressure, "soundspeed": soundspeed, "v_sig": v_sig}


def reset_predicted_values(p: PressureEntropyParams, s):
    """hydro_reset_predicted_values (hydro.h:720-747), the pressure from
    rho_bar and A_full (the reference's deliberate deviation: rho_bar is
    the P-A pressure density)."""
    pressure, soundspeed = _pressure_soundspeed(
        p, torch.clamp_min(s["u_full"], 0.0), s["rho_bar"])
    return {**s, "v": s["v_full"], "u": s["u_full"],
            "pressure": pressure, "soundspeed": soundspeed,
            "v_sig": torch.maximum(s["v_sig"], 2.0 * soundspeed)}


PARAMS = PressureEntropyParams
_THIS_MODULE = sys.modules[__name__]

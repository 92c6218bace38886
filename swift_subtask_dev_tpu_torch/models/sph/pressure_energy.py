"""Pressure-Energy (P-U) SPH in torch.

Port of the reference's ``models/sph/pressure_energy.py`` (SWIFT's
src/hydro/PressureEnergy/, Hopkins 2013): the density loop also smooths
the pressure P̄_i = (γ-1) Σ_j m_j u_j W_ij (hydro_iact.h:92, hydro.h:
588-597), the equation of motion uses u_i u_j (γ-1)² / P̄ with its own
grad-h term (hydro.h:761), and the sound speed comes from the smoothed
pressure.  Constant-alpha viscosity folded into the Balsara factor; no
gradient loop, no diffusion.

The density extras ride the scheme protocol: ``DENSITY_NEEDS_U`` puts u_j
in the density body's fields, ``DENSITY_EXTRA_KEYS`` adds its two sums
(10 where SPHENIX has 8) and ``EXTRA_STATE_KEYS`` carries them in the
state.  The pair terms are ``PressureEnergy`` in ``csrc/pair_bodies.cuh``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from . import sphenix
from .eos import IdealGas
from .kernels import CUBIC_SPLINE, SPHKernel
from .sphenix import (CONST_VISCOSITY_BETA, HYDRO_DIM, HYDRO_DIM_INV,
                      CosmoFactors, _cube, _safe_h)

NAME = "pressure-energy"
CUDA_STRUCT = "PressureEnergy"
HAS_GRADIENT_LOOP = False
DENSITY_NEEDS_U = True
DENSITY_EXTRA_KEYS = ("pressure_bar", "pressure_bar_dh")
EXTRA_STATE_KEYS = ("pressure_bar", "pressure_bar_dh")
EXTRA_STATE_INT_KEYS = ()
GRADIENT_SUM_KEYS = sphenix.GRADIENT_SUM_KEYS
GRADIENT_J_EXTRA = ()
PREPARE_GRADIENT_KEYS = sphenix.PREPARE_GRADIENT_KEYS
GRADIENT_END_KEYS = sphenix.GRADIENT_END_KEYS
PREPARE_FORCE_KEYS = sphenix.PREPARE_FORCE_KEYS

# scheme-generic lifecycle shared with the other density-energy schemes
ghost_h_update = sphenix.ghost_h_update
reset_acceleration = sphenix.reset_acceleration
end_force = sphenix.end_force
compute_timestep = sphenix.compute_timestep
timestep_h_change_limit = sphenix.timestep_h_change_limit
init_part = sphenix.init_part
density_params = sphenix.density_params


@dataclass(frozen=True)
class PressureEnergyParams:
    """SPH: YAML section for the P-U scheme (hydro_parameters.h)."""

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


def _gm1(p) -> float:
    """gamma - 1 as the reference takes it: jnp.float32(gamma - 1.0)."""
    return torch.tensor(p.eos.gamma - 1.0, dtype=torch.float32).item()


def force_params(p) -> tuple:
    """The force body's own parameters: gamma - 1 (its pressure terms)."""
    return (_gm1(p),)


def density_terms(p: PressureEnergyParams, dx, r2, hinv_i, m_j, dv, u_j):
    """Density + smoothed-pressure contributions (hydro_iact.h:52-130)."""
    base = sphenix.density_terms(p, dx, r2, hinv_i, m_j, dv)
    r_inv = sphenix._r_inv(r2)
    r = r2 * r_inv
    ui = r * hinv_i
    wi, wi_dx = p.kernel.deval(ui)
    kick = HYDRO_DIM * wi + ui * wi_dx
    mjuj = m_j * u_j
    return {**base,
            "pressure_bar": mjuj * wi,
            "pressure_bar_dh": -mjuj * kick}


def end_density(p: PressureEnergyParams, s, cosmo: CosmoFactors):
    """Self terms + h factors incl. P̄ (hydro_end_density, hydro.h:577)."""
    out = sphenix.end_density(p, s, cosmo)
    h_inv = 1.0 / _safe_h(s)
    h_inv_dim = _cube(h_inv)
    gm1 = _gm1(p)
    kroot = p.kernel.root
    mu = s["m"] * s["u"]
    pb = (s["pressure_bar"] + mu * kroot) * h_inv_dim * gm1
    pb_dh = (s["pressure_bar_dh"] - HYDRO_DIM * mu * kroot) \
        * h_inv_dim * h_inv * gm1
    return {**out, "pressure_bar": pb, "pressure_bar_dh": pb_dh}


def no_neighbours_fallback(p: PressureEnergyParams, s):
    """hydro_part_has_no_neighbours (hydro.h:668-686)."""
    out = sphenix.no_neighbours_fallback(p, s)
    h_inv_dim = _cube(1.0 / _safe_h(s))
    gm1 = _gm1(p)
    kroot = p.kernel.root
    none = s["wcount"] * _cube(s["h"]) < 1e-5 * p.eta_dim
    pb = torch.where(none, gm1 * s["m"] * s["u"] * kroot * h_inv_dim,
                     s["pressure_bar"])
    pb_dh = torch.where(none, 0.0, s["pressure_bar_dh"])
    return {**out, "pressure_bar": pb, "pressure_bar_dh": pb_dh}


def prepare_gradient(p: PressureEnergyParams, s, cosmo: CosmoFactors,
                     fold_alpha: bool = True):
    """Balsara (constant alpha folded when ``fold_alpha``), P̄-based
    grad-h term, soundspeed (hydro_prepare_force, hydro.h:714-776).
    AnarchyPU shares everything but keeps the Balsara bare (its force
    loop sums the evolved alphas instead)."""
    rv = s["rot_v"]
    curl_v = torch.sqrt(torch.sum(rv * rv, dim=-1))
    abs_div_v = torch.abs(s["div_v"])
    pressure = s["pressure_bar"]
    soundspeed = p.eos.soundspeed_from_pressure(
        torch.clamp_min(s["rho"], 1e-30), torch.clamp_min(pressure, 0.0))
    balsara = abs_div_v / (
        abs_div_v + curl_v + 1e-30
        + 0.0001 * soundspeed * cosmo.a_factor_Balsara_eps
        / torch.clamp_min(s["h"], 1e-30))
    if fold_alpha:
        balsara = balsara * p.viscosity_alpha

    common = s["h"] * HYDRO_DIM_INV / torch.clamp_min(s["wcount"], 1e-30)
    grad_W_term = common * s["wcount_dh"]
    one_over_gm1 = 1.0 / (p.eos.gamma - 1.0)
    grad_h_term = torch.where(
        grad_W_term < -0.9999, 0.0,
        s["pressure_bar_dh"] * common * one_over_gm1
        / (1.0 + grad_W_term))
    grad_h_term = torch.where(s["h"] > 0.9999 * p.h_max, 0.0, grad_h_term)
    return {**s, "f_gradh": grad_h_term, "pressure": pressure,
            "soundspeed": soundspeed, "balsara": balsara}


def reset_gradient(s):
    return {**s, "v_sig": 2.0 * s["soundspeed"],
            "alpha_visc_max_ngb": s["alpha_visc"]}


def gradient_terms(*args, **kw):  # pragma: no cover - scheme has no loop
    raise RuntimeError("PressureEnergy scheme has no gradient loop")


def end_gradient(s):
    return s


def prepare_force(p: PressureEnergyParams, s, cosmo: CosmoFactors,
                  dt_alpha):
    """Constant alpha: nothing evolves."""
    return s


def force_terms(p: PressureEnergyParams, dx, r2, hinv_i, hinv_j, m_i, m_j,
                minv_i, minv_j, dv,
                rho_i, rho_j, rhoinv_i, rhoinv_j, pr2_i, pr2_j,
                P_i, P_j, cs_i, cs_j, f_i, f_j,
                balsara_i, balsara_j, alpha_i, alpha_j,
                alpha_diff_i, alpha_diff_j, u_i, u_j,
                cosmo: CosmoFactors):
    """P-U equation of motion (runner_iact_nonsym_force,
    hydro_iact.h:238-350).  P_i/P_j carry the smoothed pressure P̄; without
    a pressure floor, P̄_floor/P̄² = 1/P̄."""
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
    omega_ij = dvdr_Hubble.clamp_max(0.0)
    mu_ij = cosmo.fac_mu * r_inv * omega_ij

    v_sig = cs_i + cs_j - CONST_VISCOSITY_BETA * mu_ij

    # grad-h factors f_ij = 1 - f_i / (m_j u_j) (hydro_iact.h:263); the
    # guard keeps padded slots finite (masked out anyway)
    f_ij = 1.0 - f_i / torch.clamp_min(m_j * u_j, 1e-30)
    f_ji = 1.0 - f_j / torch.clamp_min(m_i * u_i, 1e-30)

    rho_ij_inv = 2.0 / (rho_i + rho_j)
    visc = -0.25 * v_sig * mu_ij * (balsara_i + balsara_j) * rho_ij_inv
    visc_acc_term = 0.5 * visc * (wi_dr + wj_dr) * r_inv

    pressure_inverse_i = 1.0 / torch.clamp_min(P_i, 1e-30)
    pressure_inverse_j = 1.0 / torch.clamp_min(P_j, 1e-30)
    gm1 = _gm1(p)
    sph_acc_term = (u_j * u_i * gm1 * gm1
                    * ((f_ij * pressure_inverse_i) * wi_dr
                       + (f_ji * pressure_inverse_j) * wj_dr) * r_inv)
    acc = sph_acc_term + visc_acc_term

    sph_du_term_i = gm1 * gm1 * u_j * u_i \
        * (f_ij * pressure_inverse_i) * wi_dr * dvdr * r_inv
    visc_du_term = 0.5 * visc_acc_term * dvdr_Hubble
    du_dt_i = sph_du_term_i + visc_du_term

    return {
        "sum": {
            "a_hydro0": -m_j * acc * dx[0],
            "a_hydro1": -m_j * acc * dx[1],
            "a_hydro2": -m_j * acc * dx[2],
            "u_dt": du_dt_i * m_j,
            "h_dt": -m_j * dvdr * r_inv * rhoinv_j * wi_dr,
        },
        "max": {"v_sig": v_sig},
    }


def predict_extra(p: PressureEnergyParams, s, cosmo: CosmoFactors,
                  dt_drift, dt_therm):
    """Drift u, h, rho and the smoothed pressure (hydro_predict_extra,
    hydro.h:845-910): P̄ scales with exp(-d w1) like rho and with the
    ratio of new to old internal energy."""
    u_old = torch.clamp_min(s["u"], 1e-30)
    u = s["u"] + s["u_dt"] * dt_therm
    h_inv = 1.0 / _safe_h(s)
    w1 = s["h_dt"] * h_inv * dt_drift
    h = torch.clamp(s["h"] * torch.exp(w1), 0.0, p.h_max)
    volume_fac = torch.exp(-HYDRO_DIM * w1)
    rho = s["rho"] * volume_fac
    min_u = p.minimal_internal_energy / cosmo.a_factor_internal_energy
    u = torch.clamp_min(u, min_u)
    pb = s["pressure_bar"] * volume_fac * (u / u_old)
    soundspeed = p.eos.soundspeed_from_pressure(
        torch.clamp_min(rho, 1e-30), torch.clamp_min(pb, 0.0))
    v_sig = torch.maximum(s["v_sig"], 2.0 * soundspeed)
    return {**s, "u": u, "h": h, "rho": rho, "pressure_bar": pb,
            "pressure": pb, "soundspeed": soundspeed, "v_sig": v_sig}


def reset_predicted_values(p: PressureEnergyParams, s):
    """hydro_reset_predicted_values: P̄ re-anchored to u_full
    (hydro.h:407-431 internal_energy_ratio rescale)."""
    ratio = s["u_full"] / torch.clamp_min(s["u"], 1e-30)
    pb = s["pressure_bar"] * ratio
    soundspeed = p.eos.soundspeed_from_pressure(
        torch.clamp_min(s["rho"], 1e-30), torch.clamp_min(pb, 0.0))
    return {**s, "v": s["v_full"], "u": s["u_full"], "pressure_bar": pb,
            "pressure": pb, "soundspeed": soundspeed,
            "v_sig": torch.maximum(s["v_sig"], 2.0 * soundspeed)}


def kick_extra(p: PressureEnergyParams, s, cosmo: CosmoFactors, dt_therm):
    """Thermal kick with the 0.5x floor (hydro_kick_extra, hydro.h:946)."""
    return sphenix.kick_extra(p, s, cosmo, dt_therm)


PARAMS = PressureEnergyParams
_THIS_MODULE = sys.modules[__name__]

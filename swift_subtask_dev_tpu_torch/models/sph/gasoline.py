"""Gasoline-2 ("GDF") SPH in torch: density-energy SPH with the Wadsley
et al. (2017) physics.

Port of the reference's ``models/sph/gasoline.py`` (SWIFT's
src/hydro/Gasoline/).  The density loop also sums a smoothed pressure
gradient, the full 3 x 3 velocity-gradient tensor and its normalisation
weight (hydro_iact.h:128-173): 13 sums after the eight.  prepare_gradient
turns the tensor into a shock indicator (compression along the pressure
gradient), a shear norm and a shear-based conduction rate
(hydro.h:599-664); the gradient loop smooths the shock indicator of the
neighbours (``GRADIENT_J_EXTRA``: their shock_indicator and tensor_norm)
into a shock limiter and sums the geometric kernel-gradient correction's
weight (hydro_iact.h:191-273); prepare_force evolves the viscosity alpha
toward the shock detector (hydro.h:765-827); the force loop takes the
geometric-density form (P_i + P_j) / (rho_i rho_j) with the explicit
f = ww / (ww_ngb rho) correction (hydro_iact.h:460-559).  The pair terms
are ``Gasoline`` in ``csrc/pair_bodies.cuh``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from . import gadget2, sphenix
from .eos import IdealGas
from .kernels import CUBIC_SPLINE, SPHKernel
from .sphenix import (CONST_VISCOSITY_BETA, HYDRO_DIM, CosmoFactors,
                      _cube, _safe_h)

NAME = "gasoline"
CUDA_STRUCT = "Gasoline"
HAS_GRADIENT_LOOP = True
DENSITY_NEEDS_U = True                       # u_j feeds grad P
_VGRAD = tuple(f"vgrad{i}{j}" for i in range(3) for j in range(3))
DENSITY_EXTRA_KEYS = (("grad_P0", "grad_P1", "grad_P2")
                      + _VGRAD + ("weighted_wcount",))
GRADIENT_J_EXTRA = ("shock_indicator", "tensor_norm")
GRADIENT_SUM_KEYS = ("shock_limiter", "wncount_ngb")
GRADIENT_END_KEYS = ("f_gradh", "shock_limiter")
PREPARE_GRADIENT_KEYS = ("pressure", "soundspeed", "shock_indicator",
                         "tensor_norm", "alpha_diff")
PREPARE_FORCE_KEYS = ("alpha_visc", "shock_indicator_prev")
EXTRA_STATE_KEYS = DENSITY_EXTRA_KEYS + GRADIENT_SUM_KEYS \
    + GRADIENT_J_EXTRA + ("shock_indicator_prev",)
EXTRA_STATE_INT_KEYS = ()

# the density-energy lifecycle Minimal and SPHENIX share
density_params = sphenix.density_params
force_params = sphenix.force_params
ghost_h_update = sphenix.ghost_h_update
reset_acceleration = sphenix.reset_acceleration
end_force = sphenix.end_force
predict_extra = sphenix.predict_extra
reset_predicted_values = sphenix.reset_predicted_values
kick_extra = sphenix.kick_extra
compute_timestep = sphenix.compute_timestep
timestep_h_change_limit = sphenix.timestep_h_change_limit
init_part = sphenix.init_part
_f32 = gadget2._f32


@dataclass(frozen=True)
class GasolineParams:
    """SPH: YAML section (Gasoline hydro_parameters.h:53-87 defaults)."""

    kernel: SPHKernel = CUBIC_SPLINE
    eos: IdealGas = field(default_factory=IdealGas)
    eta_neighbours: float = 1.2348
    h_tolerance: float = 1e-4
    CFL: float = 0.1
    h_max: float = 1e30
    h_min: float = 0.0
    minimal_internal_energy: float = 0.0
    log_max_h_change: float = 0.0953101798  # ln(1.1)
    viscosity_alpha: float = 0.1            # initial (evolved)
    viscosity_alpha_max: float = 2.0
    viscosity_alpha_min: float = 0.0
    viscosity_length: float = 0.2
    diffusion_alpha: float = 0.03           # conduction coefficient C

    @property
    def eta_dim(self) -> float:
        return self.eta_neighbours ** 3

    @property
    def mod(self):
        return _THIS_MODULE


def density_terms(p: GasolineParams, dx, r2, hinv_i, m_j, dv, u_j):
    """Density + pressure gradient + velocity-gradient tensor + its
    normalisation weight (runner_iact_nonsym_density,
    hydro_iact.h:128-173)."""
    base = sphenix.density_terms(p, dx, r2, hinv_i, m_j, dv)
    r_inv = sphenix._r_inv(r2)
    r = r2 * r_inv
    ui = r * hinv_i
    _, wi_dx = p.kernel.deval(ui)
    fac = m_j * wi_dx * r_inv
    out = {**base,
           "grad_P0": fac * u_j * dx[0],
           "grad_P1": fac * u_j * dx[1],
           "grad_P2": fac * u_j * dx[2],
           "weighted_wcount": fac * r2}
    for i in range(3):
        for j in range(3):
            out[f"vgrad{i}{j}"] = fac * dv[i] * dx[j]
    return out


def end_density(p: GasolineParams, s, cosmo: CosmoFactors):
    """Self terms + h factors; the tensor normalised by 3 a^-2 / ww with
    the Hubble flow on its diagonal (hydro_end_density,
    hydro.h:540-581)."""
    out = sphenix.end_density(p, s, cosmo)
    h_inv = 1.0 / _safe_h(s)
    h_inv_dim_plus_one = (h_inv * h_inv) * (h_inv * h_inv)
    gm1 = _f32(p.eos.gamma - 1.0)
    for k in ("grad_P0", "grad_P1", "grad_P2"):
        out[k] = s[k] * gm1 * h_inv_dim_plus_one
    ww = s["weighted_wcount"]
    norm = torch.where(ww == 0.0, 0.0, 3.0 * cosmo.a_inv2
                       / torch.where(ww == 0.0, 1.0, ww))
    for i in range(3):
        for j in range(3):
            hubble = HYDRO_DIM * cosmo.H if i == j else 0.0
            out[f"vgrad{i}{j}"] = s[f"vgrad{i}{j}"] * norm + hubble
    out["weighted_wcount"] = ww
    return out


def no_neighbours_fallback(p: GasolineParams, s):
    """hydro_part_has_no_neighbours (hydro.h:716-753): ww set to 1 so the
    f correction stays finite; the tensor zeroed."""
    out = sphenix.no_neighbours_fallback(p, s)
    none = s["wcount"] * _cube(s["h"]) < 1e-5 * p.eta_dim
    out["weighted_wcount"] = torch.where(none, 1.0, s["weighted_wcount"])
    for k in ("grad_P0", "grad_P1", "grad_P2") + _VGRAD:
        out[k] = torch.where(none, 0.0, s[k])
    return out


def prepare_gradient(p: GasolineParams, s, cosmo: CosmoFactors):
    """Shock indicator (compression along the unit pressure gradient),
    shear norms, conduction rate (hydro_prepare_gradient,
    hydro.h:599-664)."""
    rho = torch.clamp_min(s["rho"], 1e-30)
    pressure = _f32(p.eos.gamma - 1.0) * rho * s["u"]
    soundspeed = p.eos.soundspeed_from_pressure(
        rho, torch.clamp_min(pressure, 0.0))

    gP = [s["grad_P0"], s["grad_P1"], s["grad_P2"]]
    mod = torch.sqrt(gP[0] * gP[0] + gP[1] * gP[1] + gP[2] * gP[2])
    mod_safe = torch.clamp_min(mod, 1e-30)
    unit = [g / mod_safe for g in gP]

    vg = [[s[f"vgrad{i}{j}"] for j in range(3)] for i in range(3)]
    dv_dn = 0.0
    shear_norm2 = 0.0
    traceless_norm2 = 0.0
    div_v = 0.0
    for i in range(3):
        for j in range(3):
            dv_dn = dv_dn + unit[i] * vg[i][j] * unit[j]
            shear = 0.5 * (vg[i][j] + vg[j][i])
            shear2 = shear * shear
            shear_norm2 = shear_norm2 + shear2
            if i != j:
                traceless_norm2 = traceless_norm2 + shear2
            else:
                div_v = div_v + vg[i][j] / 3.0
    shock = 1.5 * (dv_dn + torch.clamp_min(-div_v / 3.0, 0.0))

    h_phys = s["h"] * cosmo.a
    diff_rate = _f32(p.diffusion_alpha) \
        * torch.sqrt(traceless_norm2) * h_phys * h_phys
    return {**s, "pressure": pressure, "soundspeed": soundspeed,
            "shock_indicator": shock,
            "tensor_norm": torch.sqrt(shear_norm2),
            "alpha_diff": diff_rate}


def reset_gradient(s):
    """hydro_reset_gradient (hydro.h:676): v_sig seeded with c_s."""
    return {**s, "v_sig": s["soundspeed"],
            "alpha_visc_max_ngb": s["alpha_visc"]}


def gradient_terms(p: GasolineParams, dx, r2, hinv_i, m_j, dv,
                   u_i, u_j, rhoinv_j, cs_i, cs_j, av_j,
                   shock_i, shock_j, tensor_i, tensor_j,
                   cosmo: CosmoFactors):
    """Shock-limiter smoothing + the kernel correction's weight + the
    v_sig max (runner_iact_nonsym_gradient, hydro_iact.h:273-339)."""
    r_inv = sphenix._r_inv(r2)
    r = r2 * r_inv
    ui = r * hinv_i
    wi, wi_dx = p.kernel.deval(ui)

    dvdr = dv[0] * dx[0] + dv[1] * dx[1] + dv[2] * dx[2]
    dvdr_Hubble = dvdr + cosmo.a * cosmo.a * cosmo.H * r2
    omega_ij = torch.clamp_max(dvdr_Hubble, 0.0)
    mu_ij = cosmo.fac_mu * r_inv * omega_ij
    v_sig = cs_i + cs_j - CONST_VISCOSITY_BETA * mu_ij

    shock_ratio_j = torch.where(
        tensor_j > 0.0, shock_j / torch.clamp_min(tensor_j, 1e-30), 0.0)
    return {
        "sum": {
            "shock_limiter": m_j * shock_ratio_j * wi,
            "wncount_ngb": m_j * r2 * wi_dx * rhoinv_j * r_inv,
        },
        "max": {
            "v_sig": v_sig,
            "alpha_visc_max_ngb": av_j,
        },
    }


def end_gradient(s):
    """hydro_end_gradient (hydro.h:691): the explicit f = ww / (ww_ngb
    rho) and the shock limiter's h normalisation."""
    h_inv_dim = _cube(1.0 / _safe_h(s))
    denom = s["wncount_ngb"] * torch.clamp_min(s["rho"], 1e-30)
    big = torch.abs(denom) > 1e-20
    f = torch.where(big, s["weighted_wcount"]
                    / torch.where(big, denom, 1.0), 1.0)
    return {**s, "f_gradh": f,
            "shock_limiter": s["shock_limiter"] * h_inv_dim}


def prepare_force(p: GasolineParams, s, cosmo: CosmoFactors, dt_alpha):
    """The alpha evolution toward the shock detector, with the smoothed
    limiter (hydro_prepare_force, hydro.h:765-827)."""
    dt_alpha = torch.as_tensor(dt_alpha, dtype=torch.float32,
                               device=s["h"].device)
    d_shock_dt = torch.where(
        dt_alpha == 0.0, 0.0,
        (s["shock_indicator"] - s["shock_indicator_prev"])
        / torch.where(dt_alpha == 0.0, 1.0, dt_alpha))
    v_sig_phys = s["v_sig"] * cosmo.a_factor_sound_speed
    cs_phys = s["soundspeed"] * cosmo.a_factor_sound_speed
    h_phys = torch.clamp_min(s["h"], 1e-30) * cosmo.a

    core = 0.5 * (1.0 - s["shock_limiter"]
                  / torch.clamp_min(s["rho"], 1e-30))
    core2 = core * core
    limiter = core2 * core2
    detector = (2.0 * h_phys * h_phys * _f32(p.kernel.gamma2)
                * limiter * torch.clamp_min(-d_shock_dt, 0.0))
    alpha_loc = _f32(p.viscosity_alpha_max) * detector \
        / torch.clamp_min(detector + v_sig_phys * v_sig_phys, 1e-30)
    d_alpha_dt = (alpha_loc - s["alpha_visc"]) \
        * _f32(p.viscosity_length) * cs_phys / h_phys
    new_alpha = torch.where(s["alpha_visc"] < alpha_loc, alpha_loc,
                            s["alpha_visc"] + d_alpha_dt * dt_alpha)
    new_alpha = torch.clamp(new_alpha, p.viscosity_alpha_min,
                            p.viscosity_alpha_max)
    return {**s, "alpha_visc": new_alpha,
            "shock_indicator_prev": s["shock_indicator"]}


def force_terms(p: GasolineParams, dx, r2, hinv_i, hinv_j, m_i, m_j,
                minv_i, minv_j, dv,
                rho_i, rho_j, rhoinv_i, rhoinv_j, pr2_i, pr2_j,
                P_i, P_j, cs_i, cs_j, f_i, f_j,
                balsara_i, balsara_j, alpha_i, alpha_j,
                alpha_diff_i, alpha_diff_j, u_i, u_j,
                cosmo: CosmoFactors):
    """Gasoline's GDF equation of motion (runner_iact_nonsym_force,
    hydro_iact.h:460-559): (P_i + P_j) / (rho_i rho_j) with the kernel
    correction f in a symmetrised kernel gradient; alpha_diff_i/j carry
    the shear conduction rates."""
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

    kernel_gradient = 0.5 * (wi_dr * f_i + wj_dr * f_j)

    rho_ij = rho_i + rho_j
    alpha = alpha_i + alpha_j
    visc = torch.where(
        omega_ij < 0.0,
        (-0.25 * alpha * (cs_i + cs_j) * mu_ij
         + CONST_VISCOSITY_BETA * mu_ij * mu_ij) / (0.5 * rho_ij),
        0.0)
    visc_acc_term = visc * kernel_gradient * r_inv

    rr_inv = rhoinv_i * rhoinv_j
    sph_acc_term = (P_i + P_j) * r_inv * kernel_gradient * rr_inv
    acc = sph_acc_term + visc_acc_term

    sph_du_term_i = P_i * dvdr * r_inv * kernel_gradient * rr_inv
    visc_du_term = 0.5 * visc_acc_term * dvdr_Hubble
    diff_du_term = 2.0 * (alpha_diff_i + alpha_diff_j) \
        * (u_i - u_j) * kernel_gradient / rho_ij
    du_dt_i = sph_du_term_i + visc_du_term + diff_du_term

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


PARAMS = GasolineParams
_THIS_MODULE = sys.modules[__name__]

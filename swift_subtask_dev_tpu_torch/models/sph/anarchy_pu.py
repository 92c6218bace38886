"""ANARCHY-PU SPH in torch: Pressure-Energy with the ANARCHY variable
viscosity and thermal diffusion (the EAGLE-era flavour).

Port of the reference's ``models/sph/anarchy_pu.py`` (SWIFT's
src/hydro/AnarchyPU/): Pressure-Energy's smoothed-pressure density loop,
SPHENIX's gradient loop (laplace(u), the signal velocity and the
neighbours' alpha max), the ANARCHY alpha evolution
(``phantom.anarchy_alpha_evolution``) every step in prepare_force, and a
force of its own: the P-U equation of motion with summed alphas and a
soundspeed-triggered diffusion v_diff = max(cs_i + cs_j + mu_ij, 0)
(hydro_iact.h:419-425).  The force terms are ``AnarchyPU`` in
``csrc/pair_bodies.cuh``; the gradient body is SPHENIX's.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from . import phantom
from . import pressure_energy as pe
from . import sphenix
from .eos import IdealGas
from .kernels import CUBIC_SPLINE, SPHKernel
from .sphenix import CONST_VISCOSITY_BETA, CosmoFactors, _safe_h

NAME = "anarchy-pu"
CUDA_STRUCT = "AnarchyPU"
HAS_GRADIENT_LOOP = True
DENSITY_NEEDS_U = True
DENSITY_EXTRA_KEYS = pe.DENSITY_EXTRA_KEYS
EXTRA_STATE_KEYS = pe.EXTRA_STATE_KEYS
EXTRA_STATE_INT_KEYS = ()
GRADIENT_SUM_KEYS = sphenix.GRADIENT_SUM_KEYS
GRADIENT_J_EXTRA = ()
PREPARE_GRADIENT_KEYS = sphenix.PREPARE_GRADIENT_KEYS
GRADIENT_END_KEYS = sphenix.GRADIENT_END_KEYS
PREPARE_FORCE_KEYS = sphenix.PREPARE_FORCE_KEYS

# P-U density / pressure machinery
density_terms = pe.density_terms
density_params = pe.density_params
force_params = pe.force_params
end_density = pe.end_density
no_neighbours_fallback = pe.no_neighbours_fallback
predict_extra = pe.predict_extra
reset_predicted_values = pe.reset_predicted_values
kick_extra = pe.kick_extra
ghost_h_update = sphenix.ghost_h_update
reset_acceleration = sphenix.reset_acceleration
end_force = sphenix.end_force
compute_timestep = sphenix.compute_timestep
timestep_h_change_limit = sphenix.timestep_h_change_limit
init_part = sphenix.init_part
reset_gradient = sphenix.reset_gradient
end_gradient = sphenix.end_gradient
gradient_terms = sphenix.gradient_terms   # laplace_u + v_sig + alpha max


@dataclass(frozen=True)
class AnarchyPUParams:
    """SPH: YAML section for the ANARCHY-PU scheme."""

    kernel: SPHKernel = CUBIC_SPLINE
    eos: IdealGas = field(default_factory=IdealGas)
    eta_neighbours: float = 1.2348
    h_tolerance: float = 1e-4
    CFL: float = 0.1
    h_max: float = 1e30
    h_min: float = 0.0
    minimal_internal_energy: float = 0.0
    log_max_h_change: float = 0.0953101798
    viscosity_alpha: float = 0.1
    viscosity_alpha_min: float = 0.0
    viscosity_alpha_max: float = 2.0
    viscosity_length: float = 0.25      # ANARCHY ell (0.25 of crossing)
    diffusion_alpha: float = 0.0
    diffusion_beta: float = 0.01
    diffusion_alpha_max: float = 1.0
    diffusion_alpha_min: float = 0.0

    @property
    def eta_dim(self) -> float:
        return self.eta_neighbours ** 3

    @property
    def mod(self):
        return _THIS_MODULE


def prepare_gradient(p: AnarchyPUParams, s, cosmo: CosmoFactors):
    """P-U pressure/soundspeed/grad-h + the bare Balsara (the force loop
    sums the evolved alphas like SPHENIX)."""
    return pe.prepare_gradient(p, s, cosmo, fold_alpha=False)


def prepare_force(p: AnarchyPUParams, s, cosmo: CosmoFactors, dt_alpha):
    """ANARCHY viscosity evolution + SPHENIX-style diffusion-alpha
    evolution (AnarchyPU hydro.h prepare_force, every step)."""
    alpha = phantom.anarchy_alpha_evolution(p, s, cosmo, dt_alpha)
    dt_alpha = torch.as_tensor(dt_alpha, dtype=torch.float32,
                               device=s["h"].device)

    kern_supp = _safe_h(s) * cosmo.a * p.kernel.gamma
    kern_supp_inv = 1.0 / kern_supp
    v_sig_phys = s["v_sig"] * cosmo.a_factor_sound_speed
    diff_timescale_inv = v_sig_phys * kern_supp_inv
    sqrt_u_inv = 1.0 / torch.sqrt(torch.clamp_min(s["u"], 1e-30))
    alpha_diff_dt = (p.diffusion_beta * kern_supp * s["laplace_u"]
                     * cosmo.a_factor_sound_speed * sqrt_u_inv
                     * cosmo.a_inv2)
    alpha_diff_dt = alpha_diff_dt - (s["alpha_diff"]
                                     - p.diffusion_alpha_min) \
        * diff_timescale_inv
    new_alpha_diff = s["alpha_diff"] + alpha_diff_dt * dt_alpha
    new_alpha_diff = torch.clamp(new_alpha_diff, p.diffusion_alpha_min,
                                 p.diffusion_alpha_max)
    return {**s, "alpha_visc": alpha, "div_v_prev": s["div_v"],
            "alpha_diff": new_alpha_diff}


def force_terms(p: AnarchyPUParams, dx, r2, hinv_i, hinv_j, m_i, m_j,
                minv_i, minv_j, dv,
                rho_i, rho_j, rhoinv_i, rhoinv_j, pr2_i, pr2_j,
                P_i, P_j, cs_i, cs_j, f_i, f_j,
                balsara_i, balsara_j, alpha_i, alpha_j,
                alpha_diff_i, alpha_diff_j, u_i, u_j,
                cosmo: CosmoFactors):
    """AnarchyPU force loop (hydro_iact.h:330-440): P-U pressure equation
    of motion with summed-alpha viscosity and cs-triggered diffusion."""
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

    f_ij = 1.0 - f_i / torch.clamp_min(m_j * u_j, 1e-30)
    f_ji = 1.0 - f_j / torch.clamp_min(m_i * u_i, 1e-30)

    rho_ij_inv = 1.0 / (rho_i + rho_j)
    alpha = alpha_i + alpha_j
    visc = -0.25 * alpha * v_sig * mu_ij * (balsara_i + balsara_j) \
        * rho_ij_inv
    visc_acc_term = 0.5 * visc * (wi_dr + wj_dr) * r_inv

    pressure_inverse_i = 1.0 / torch.clamp_min(P_i, 1e-30)
    pressure_inverse_j = 1.0 / torch.clamp_min(P_j, 1e-30)
    gm1 = pe._gm1(p)
    sph_acc_term = (u_j * u_i * gm1 * gm1
                    * ((f_ij * pressure_inverse_i) * wi_dr
                       + (f_ji * pressure_inverse_j) * wj_dr) * r_inv)
    acc = sph_acc_term + visc_acc_term

    sph_du_term_i = gm1 * gm1 * u_j * u_i \
        * (f_ij * pressure_inverse_i) * wi_dr * dvdr * r_inv
    visc_du_term = 0.5 * visc_acc_term * dvdr_Hubble

    # diffusion (hydro_iact.h:419): cs-based trigger
    v_diff = torch.clamp_min(cs_i + cs_j + mu_ij, 0.0)
    alpha_diff = 0.5 * (alpha_diff_i + alpha_diff_j)
    diff_du_term = alpha_diff * cosmo.fac_mu * v_diff * (u_i - u_j) \
        * (wi_dr + wj_dr) * rho_ij_inv

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


PARAMS = AnarchyPUParams
_THIS_MODULE = sys.modules[__name__]

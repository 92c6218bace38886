"""Phantom-flavoured SPH in torch: density-energy SPH with the ANARCHY
variable viscosity and a constant Price (2017) thermal diffusion.

Port of the reference's ``models/sph/phantom.py`` (SWIFT's
src/hydro/Phantom/): a reduced SPHENIX, with the ANARCHY viscosity
evolution (alpha_loc = alpha_max S / (v_sig^2 / 4 + S), an exponential
decay over the sound-crossing time, hydro.h:752-801) folded into the
Balsara factor (hydro.h:807), a gradient loop that only tracks the
signal velocity and the neighbours' alpha (hydro_iact.h:240), and a
constant diffusion alpha with v_diff = sqrt(2 |P_i - P_j| / (rho_i +
rho_j)) + dv.r / r (hydro_iact.h:384).  ``anarchy_alpha_evolution`` is
AnarchyPU's prepare_force too (``models/sph/anarchy_pu.py``).  The force
and gradient terms are ``Phantom`` in ``csrc/pair_bodies.cuh``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from . import sphenix
from .eos import IdealGas
from .kernels import CUBIC_SPLINE, SPHKernel
from .sphenix import CONST_VISCOSITY_BETA, CosmoFactors, _safe_h

NAME = "phantom"
CUDA_STRUCT = "Phantom"
HAS_GRADIENT_LOOP = True
DENSITY_NEEDS_U = False
DENSITY_EXTRA_KEYS = ()
EXTRA_STATE_KEYS = ()
EXTRA_STATE_INT_KEYS = ()
GRADIENT_SUM_KEYS = sphenix.GRADIENT_SUM_KEYS   # laplace_u, always 0
GRADIENT_J_EXTRA = ()
PREPARE_GRADIENT_KEYS = sphenix.PREPARE_GRADIENT_KEYS
GRADIENT_END_KEYS = sphenix.GRADIENT_END_KEYS
PREPARE_FORCE_KEYS = ("alpha_visc", "div_v_prev", "balsara")

# the density-energy machinery SPHENIX shares with it
density_terms = sphenix.density_terms
density_params = sphenix.density_params
force_params = sphenix.force_params
end_density = sphenix.end_density
ghost_h_update = sphenix.ghost_h_update
no_neighbours_fallback = sphenix.no_neighbours_fallback
reset_acceleration = sphenix.reset_acceleration
end_force = sphenix.end_force
predict_extra = sphenix.predict_extra
reset_predicted_values = sphenix.reset_predicted_values
kick_extra = sphenix.kick_extra
compute_timestep = sphenix.compute_timestep
timestep_h_change_limit = sphenix.timestep_h_change_limit
init_part = sphenix.init_part
prepare_gradient = sphenix.prepare_gradient
reset_gradient = sphenix.reset_gradient
end_gradient = sphenix.end_gradient


@dataclass(frozen=True)
class PhantomParams:
    """SPH: YAML section for the Phantom scheme (hydro_parameters.h)."""

    kernel: SPHKernel = CUBIC_SPLINE
    eos: IdealGas = field(default_factory=IdealGas)
    eta_neighbours: float = 1.2348
    h_tolerance: float = 1e-4
    CFL: float = 0.1
    h_max: float = 1e30
    h_min: float = 0.0
    minimal_internal_energy: float = 0.0
    log_max_h_change: float = 0.0953101798
    viscosity_alpha: float = 0.1          # initial value
    viscosity_alpha_min: float = 0.0
    viscosity_alpha_max: float = 2.0
    viscosity_length: float = 0.05
    diffusion_alpha: float = 1.0          # constant (Price 2017)

    @property
    def eta_dim(self) -> float:
        return self.eta_neighbours ** 3

    @property
    def mod(self):
        return _THIS_MODULE


def gradient_terms(p: PhantomParams, dx, r2, hinv_i, m_j, dv,
                   u_i, u_j, rhoinv_j, cs_i, cs_j, alpha_visc_j,
                   cosmo: CosmoFactors):
    """Phantom's gradient loop: the v_sig and neighbour-alpha maxes only
    (runner_iact_nonsym_gradient, hydro_iact.h:240); laplace_u is 0."""
    r_inv = sphenix._r_inv(r2)
    dvdr = dv[0] * dx[0] + dv[1] * dx[1] + dv[2] * dx[2]
    dvdr_Hubble = dvdr + cosmo.a * cosmo.a * cosmo.H * r2
    omega_ij = torch.clamp_max(dvdr_Hubble, 0.0)
    mu_ij = cosmo.fac_mu * r_inv * omega_ij
    new_v_sig = cs_i + cs_j - CONST_VISCOSITY_BETA * mu_ij
    return {
        "sum": {"laplace_u": torch.zeros_like(r2)},
        "max": {"v_sig": new_v_sig,
                "alpha_visc_max_ngb": alpha_visc_j},
    }


def anarchy_alpha_evolution(p, s, cosmo: CosmoFactors, dt_alpha):
    """Shared ANARCHY viscosity-alpha update: source from -d(div v)/dt,
    trigger on v_sig²/4, exponential decay over the sound-crossing time.
    ``dt_alpha``: a python float or a tensor broadcast against the state."""
    kern_supp = _safe_h(s) * cosmo.a * p.kernel.gamma
    kern_supp_inv = 1.0 / kern_supp
    v_sig_phys = s["v_sig"] * cosmo.a_factor_sound_speed
    soundspeed_phys = s["soundspeed"] * cosmo.a_factor_sound_speed
    sound_crossing_inv = soundspeed_phys * kern_supp_inv

    dt_alpha = torch.as_tensor(dt_alpha, dtype=torch.float32,
                               device=s["h"].device)
    div_v_dt = torch.where(dt_alpha == 0.0, 0.0,
                           (s["div_v"] - s["div_v_prev"])
                           / torch.clamp_min(dt_alpha, 1e-30))
    S = kern_supp * kern_supp * torch.clamp_min(-div_v_dt, 0.0)
    v_sig2 = 0.25 * v_sig_phys * v_sig_phys
    alpha_loc = p.viscosity_alpha_max * S / (v_sig2 + S + 1e-30)

    alpha_decayed = alpha_loc + (s["alpha_visc"] - alpha_loc) * torch.exp(
        -dt_alpha * sound_crossing_inv * p.viscosity_length)
    alpha = torch.where(alpha_loc > s["alpha_visc"], alpha_loc,
                        alpha_decayed)
    return torch.clamp_min(alpha, p.viscosity_alpha_min)


def prepare_force(p: PhantomParams, s, cosmo: CosmoFactors, dt_alpha):
    """The alpha evolution, folded into the Balsara factor
    (hydro.h:752-810)."""
    alpha = anarchy_alpha_evolution(p, s, cosmo, dt_alpha)
    return {**s, "alpha_visc": alpha, "div_v_prev": s["div_v"],
            "balsara": s["balsara"] * alpha}


def force_terms(p: PhantomParams, dx, r2, hinv_i, hinv_j, m_i, m_j,
                minv_i, minv_j, dv,
                rho_i, rho_j, rhoinv_i, rhoinv_j, pr2_i, pr2_j,
                P_i, P_j, cs_i, cs_j, f_i, f_j,
                balsara_i, balsara_j, alpha_i, alpha_j,
                alpha_diff_i, alpha_diff_j, u_i, u_j,
                cosmo: CosmoFactors):
    """Phantom's force loop (runner_iact_force, hydro_iact.h:330-400): the
    viscosity convolved per particle density, and Price's diffusion with
    constant alphas.  balsara_i/j carry the evolved alphas; alpha_diff_i/j
    the constant p.diffusion_alpha."""
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

    f_ij = 1.0 - f_i * minv_j
    f_ji = 1.0 - f_j * minv_i

    # the viscosity convolved per particle (hydro_iact.h:352): the 1/8
    # and the f / rho weights inside the kernel mean
    visc = -0.125 * v_sig * mu_ij * (balsara_i + balsara_j)
    kernel_mean = (wi_dr * f_ij * rhoinv_i + wj_dr * f_ji * rhoinv_j)
    visc_acc_term = 0.5 * visc * kernel_mean * r_inv

    P_over_rho2_i = pr2_i * f_ij
    P_over_rho2_j = pr2_j * f_ji
    sph_acc_term = (P_over_rho2_i * wi_dr + P_over_rho2_j * wj_dr) * r_inv
    acc = sph_acc_term + visc_acc_term

    sph_du_term_i = P_over_rho2_i * dvdr * r_inv * wi_dr
    visc_du_term = 0.5 * visc_acc_term * dvdr_Hubble

    # Price (2017) diffusion with constant alphas (hydro_iact.h:384)
    v_diff = torch.sqrt(2.0 * torch.abs(P_i - P_j) / (rho_i + rho_j)) \
        + dvdr_Hubble * r_inv
    alpha_diff = 0.5 * (alpha_diff_i + alpha_diff_j)
    diff_du_term = alpha_diff * v_diff * (u_i - u_j) * 0.5 * kernel_mean

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


PARAMS = PhantomParams
_THIS_MODULE = sys.modules[__name__]

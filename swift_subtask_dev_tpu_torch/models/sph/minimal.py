"""Minimal SPH scheme in torch.

Port of the reference's ``models/sph/minimal.py`` (SWIFT's
src/hydro/Minimal/): density-energy SPH with the Balsara-switched
constant-alpha viscosity (the alpha folded into the Balsara factor), no
gradient loop, no thermal diffusion.  The lifecycle SPHENIX shares with
it (density sums, ghost, drift, kicks, CFL) is SPHENIX's own functions;
the force terms are ``Minimal`` in ``csrc/pair_bodies.cuh``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from . import sphenix
from .eos import IdealGas
from .kernels import CUBIC_SPLINE, SPHKernel
from .sphenix import CONST_VISCOSITY_BETA, CosmoFactors

NAME = "minimal"
CUDA_STRUCT = "Minimal"
HAS_GRADIENT_LOOP = False
DENSITY_NEEDS_U = False
DENSITY_EXTRA_KEYS = ()
EXTRA_STATE_KEYS = ()
EXTRA_STATE_INT_KEYS = ()
GRADIENT_SUM_KEYS = sphenix.GRADIENT_SUM_KEYS
GRADIENT_J_EXTRA = ()
PREPARE_GRADIENT_KEYS = sphenix.PREPARE_GRADIENT_KEYS
GRADIENT_END_KEYS = sphenix.GRADIENT_END_KEYS
PREPARE_FORCE_KEYS = sphenix.PREPARE_FORCE_KEYS

# scheme-generic lifecycle (identical formulas in SWIFT's Minimal hydro.h)
density_terms = sphenix.density_terms
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
density_params = sphenix.density_params
force_params = sphenix.force_params


@dataclass(frozen=True)
class MinimalParams:
    """SPH: YAML section for the Minimal scheme (hydro_parameters.h)."""

    kernel: SPHKernel = CUBIC_SPLINE
    eos: IdealGas = field(default_factory=IdealGas)
    eta_neighbours: float = 1.2348
    h_tolerance: float = 1e-4
    CFL: float = 0.1
    h_max: float = 1e30
    h_min: float = 0.0
    minimal_internal_energy: float = 0.0
    log_max_h_change: float = 0.0953101798  # ln(1.1)
    viscosity_alpha: float = 0.8   # hydro_props_default_viscosity_alpha
    diffusion_alpha: float = 0.0   # no thermal diffusion in Minimal

    @property
    def eta_dim(self) -> float:
        return self.eta_neighbours ** 3

    @property
    def mod(self):
        return _THIS_MODULE


def prepare_gradient(p: MinimalParams, s, cosmo: CosmoFactors):
    """Pressure, soundspeed, grad-h term and the alpha-folded Balsara
    switch (Minimal hydro_prepare_force, hydro.h:754)."""
    out = sphenix.prepare_gradient(p, s, cosmo)
    return {**out, "balsara": out["balsara"] * p.viscosity_alpha}


def reset_gradient(s):
    return {**s, "v_sig": 2.0 * s["soundspeed"],
            "alpha_visc_max_ngb": s["alpha_visc"]}


def gradient_terms(*args, **kw):  # pragma: no cover - scheme has no loop
    raise RuntimeError("Minimal scheme has no gradient loop")


def end_gradient(s):
    return s


def prepare_force(p: MinimalParams, s, cosmo: CosmoFactors, dt_alpha):
    """No alpha evolution in Minimal: alphas stay constant."""
    return s


def force_terms(p: MinimalParams, dx, r2, hinv_i, hinv_j, m_i, m_j,
                minv_i, minv_j, dv,
                rho_i, rho_j, rhoinv_i, rhoinv_j, pr2_i, pr2_j,
                P_i, P_j, cs_i, cs_j, f_i, f_j,
                balsara_i, balsara_j, alpha_i, alpha_j,
                alpha_diff_i, alpha_diff_j, u_i, u_j,
                cosmo: CosmoFactors):
    """Minimal force loop (hydro_iact.h:370-470): Monaghan viscosity with
    rho_ij = (rho_i+rho_j)/2 and the alpha folded into the Balsara
    factors; no diffusion term (the SPHENIX signature; the diffusion
    arguments are ignored)."""
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

    f_ij = 1.0 - f_i * minv_j
    f_ji = 1.0 - f_j * minv_i

    # rho_ij = 0.5 (rho_i + rho_j) (hydro_iact.h:441)
    rho_ij_inv = 2.0 / (rho_i + rho_j)
    visc = -0.25 * v_sig * (balsara_i + balsara_j) * mu_ij * rho_ij_inv
    visc_acc_term = 0.5 * visc * (wi_dr * f_ij + wj_dr * f_ji) * r_inv

    P_over_rho2_i = pr2_i * f_ij
    P_over_rho2_j = pr2_j * f_ji
    sph_acc_term = (P_over_rho2_i * wi_dr + P_over_rho2_j * wj_dr) * r_inv
    acc = sph_acc_term + visc_acc_term

    sph_du_term_i = P_over_rho2_i * dvdr * r_inv * wi_dr
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


PARAMS = MinimalParams
_THIS_MODULE = sys.modules[__name__]

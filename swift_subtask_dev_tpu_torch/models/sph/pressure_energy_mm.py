"""Pressure-Energy SPH with the Morris & Monaghan (1997) viscosity, in torch.

Port of the reference's ``models/sph/pressure_energy_mm.py`` (SWIFT's
src/hydro/PressureEnergyMorrisMonaghanAV/): Pressure-Energy's smoothed
pressure (its density loop, P-U equation of motion and lifecycle) with a
per-particle evolved viscosity alpha,

    dalpha/dt = -min(div_v, 0) + (alpha_min - alpha) / tau,
    1/tau = ell c_s,phys / h_phys                      (hydro.h:745-765),

and a force loop that takes alpha_ij = (alpha_i + alpha_j) / 2 on the
bare Balsara switch (hydro_iact.h:301-303).  The force terms are
``PressureEnergyMM`` in ``csrc/pair_bodies.cuh``; the density body is
Pressure-Energy's.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from . import pressure_energy as pe
from . import sphenix
from .eos import IdealGas
from .kernels import CUBIC_SPLINE, SPHKernel
from .sphenix import CosmoFactors

NAME = "pressure-energy-monaghan"
CUDA_STRUCT = "PressureEnergyMM"
HAS_GRADIENT_LOOP = False
DENSITY_NEEDS_U = True
DENSITY_EXTRA_KEYS = pe.DENSITY_EXTRA_KEYS
EXTRA_STATE_KEYS = pe.EXTRA_STATE_KEYS
EXTRA_STATE_INT_KEYS = ()
GRADIENT_SUM_KEYS = sphenix.GRADIENT_SUM_KEYS
GRADIENT_J_EXTRA = ()
PREPARE_GRADIENT_KEYS = sphenix.PREPARE_GRADIENT_KEYS
GRADIENT_END_KEYS = sphenix.GRADIENT_END_KEYS
PREPARE_FORCE_KEYS = ("alpha_visc",)

# the P-U machinery is the fixed-alpha scheme's
density_terms = pe.density_terms
density_params = pe.density_params
force_params = pe.force_params
end_density = pe.end_density
no_neighbours_fallback = pe.no_neighbours_fallback
reset_gradient = pe.reset_gradient
gradient_terms = pe.gradient_terms
end_gradient = pe.end_gradient
predict_extra = pe.predict_extra
reset_predicted_values = pe.reset_predicted_values
kick_extra = pe.kick_extra
ghost_h_update = sphenix.ghost_h_update
reset_acceleration = sphenix.reset_acceleration
end_force = pe.end_force
compute_timestep = sphenix.compute_timestep
timestep_h_change_limit = sphenix.timestep_h_change_limit
init_part = sphenix.init_part


@dataclass(frozen=True)
class PressureEnergyMMParams:
    """SPH: YAML section (hydro_parameters.h:63-74 defaults)."""

    kernel: SPHKernel = CUBIC_SPLINE
    eos: IdealGas = field(default_factory=IdealGas)
    eta_neighbours: float = 1.2348
    h_tolerance: float = 1e-4
    CFL: float = 0.1
    h_max: float = 1e30
    h_min: float = 0.0
    minimal_internal_energy: float = 0.0
    log_max_h_change: float = 0.0953101798  # ln(1.1)
    viscosity_alpha: float = 0.8            # initial (evolved)
    viscosity_alpha_min: float = 0.1
    viscosity_alpha_max: float = 2.0
    viscosity_length: float = 0.1           # ell in 1/tau
    diffusion_alpha: float = 0.0

    @property
    def eta_dim(self) -> float:
        return self.eta_neighbours ** 3

    @property
    def mod(self):
        return _THIS_MODULE


def prepare_gradient(p: PressureEnergyMMParams, s, cosmo: CosmoFactors):
    """P-U prepare with the Balsara switch left bare: the force loop
    applies the evolved alpha_ij (hydro.h:712)."""
    return pe.prepare_gradient(p, s, cosmo, fold_alpha=False)


def prepare_force(p: PressureEnergyMMParams, s, cosmo: CosmoFactors,
                  dt_alpha):
    """Morris & Monaghan alpha evolution (hydro.h:745-765): the source
    -min(div_v, 0) and a decay toward alpha_min over ell sound
    crossings."""
    h_inv_phys = 1.0 / (torch.clamp_min(s["h"], 1e-30) * cosmo.a)
    cs_phys = s["soundspeed"] * cosmo.a_factor_sound_speed
    inverse_tau = p.viscosity_length * cs_phys * h_inv_phys
    source = -torch.clamp_max(s["div_v"], 0.0)
    dalpha_dt = source + (p.viscosity_alpha_min - s["alpha_visc"]) \
        * inverse_tau
    alpha = torch.clamp(s["alpha_visc"] + dalpha_dt * dt_alpha,
                        p.viscosity_alpha_min, p.viscosity_alpha_max)
    return {**s, "alpha_visc": alpha}


def force_terms(p: PressureEnergyMMParams, dx, r2, hinv_i, hinv_j,
                m_i, m_j, minv_i, minv_j, dv,
                rho_i, rho_j, rhoinv_i, rhoinv_j, pr2_i, pr2_j,
                P_i, P_j, cs_i, cs_j, f_i, f_j,
                balsara_i, balsara_j, alpha_i, alpha_j,
                alpha_diff_i, alpha_diff_j, u_i, u_j,
                cosmo: CosmoFactors):
    """The P-U equation of motion with alpha_ij = (alpha_i + alpha_j) / 2
    on the bare-Balsara viscosity (hydro_iact.h:296-310): Pressure-Energy's
    terms with each Balsara factor scaled by alpha_ij."""
    alpha_ij = 0.5 * (alpha_i + alpha_j)
    return pe.force_terms(
        p, dx, r2, hinv_i, hinv_j, m_i, m_j, minv_i, minv_j, dv,
        rho_i, rho_j, rhoinv_i, rhoinv_j, pr2_i, pr2_j,
        P_i, P_j, cs_i, cs_j, f_i, f_j,
        balsara_i * alpha_ij, balsara_j * alpha_ij, alpha_i, alpha_j,
        alpha_diff_i, alpha_diff_j, u_i, u_j, cosmo)


PARAMS = PressureEnergyMMParams
_THIS_MODULE = sys.modules[__name__]

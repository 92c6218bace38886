"""The 'None' hydro scheme in torch: neighbour densities, no hydrodynamics.

Port of the reference's ``models/sph/none.py`` (SWIFT's src/hydro/None/):
gas particles still find their neighbours and measure rho and h (so the
subgrid models and the outputs work) but feel no hydro force, evolve no
internal energy and impose no CFL limit: gravity-only runs that carry gas
properties.  The force terms are all zero (``NoneScheme`` in
``csrc/pair_bodies.cuh``); the density is SPHENIX's.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from . import sphenix
from .eos import IdealGas
from .kernels import CUBIC_SPLINE, SPHKernel
from .sphenix import CosmoFactors

NAME = "none"
CUDA_STRUCT = "NoneScheme"
HAS_GRADIENT_LOOP = False
DENSITY_NEEDS_U = False
DENSITY_EXTRA_KEYS = ()
EXTRA_STATE_KEYS = ()
EXTRA_STATE_INT_KEYS = ()
GRADIENT_J_EXTRA = ()
GRADIENT_SUM_KEYS = sphenix.GRADIENT_SUM_KEYS
PREPARE_GRADIENT_KEYS = sphenix.PREPARE_GRADIENT_KEYS
GRADIENT_END_KEYS = sphenix.GRADIENT_END_KEYS
PREPARE_FORCE_KEYS = sphenix.PREPARE_FORCE_KEYS

density_terms = sphenix.density_terms
density_params = sphenix.density_params
force_params = sphenix.force_params
end_density = sphenix.end_density
ghost_h_update = sphenix.ghost_h_update
no_neighbours_fallback = sphenix.no_neighbours_fallback
init_part = sphenix.init_part
prepare_gradient = sphenix.prepare_gradient
reset_predicted_values = sphenix.reset_predicted_values


@dataclass(frozen=True)
class NoneParams:
    """SPH: YAML section for the None scheme."""

    kernel: SPHKernel = CUBIC_SPLINE
    eos: IdealGas = field(default_factory=IdealGas)
    eta_neighbours: float = 1.2348
    h_tolerance: float = 1e-4
    CFL: float = 0.1
    h_max: float = 1e30
    h_min: float = 0.0
    minimal_internal_energy: float = 0.0
    log_max_h_change: float = 0.0953101798
    viscosity_alpha: float = 0.0
    diffusion_alpha: float = 0.0

    @property
    def eta_dim(self) -> float:
        return self.eta_neighbours ** 3

    @property
    def mod(self):
        return _THIS_MODULE


def reset_gradient(s):
    return {**s, "v_sig": torch.zeros_like(s["v_sig"]),
            "alpha_visc_max_ngb": s["alpha_visc"]}


def gradient_terms(*args, **kw):  # pragma: no cover - scheme has no loop
    raise RuntimeError("None scheme has no gradient loop")


def end_gradient(s):
    return s


def prepare_force(p: NoneParams, s, cosmo: CosmoFactors, dt_alpha):
    return s


def reset_acceleration(s):
    return {**s, "a_hydro": torch.zeros_like(s["a_hydro"]),
            "u_dt": torch.zeros_like(s["u_dt"]),
            "h_dt": torch.zeros_like(s["h_dt"])}


def force_terms(p: NoneParams, dx, r2, hinv_i, hinv_j, m_i, m_j,
                minv_i, minv_j, dv,
                rho_i, rho_j, rhoinv_i, rhoinv_j, pr2_i, pr2_j,
                P_i, P_j, cs_i, cs_j, f_i, f_j,
                balsara_i, balsara_j, alpha_i, alpha_j,
                alpha_diff_i, alpha_diff_j, u_i, u_j,
                cosmo: CosmoFactors):
    """No hydro force: every sum and the signal velocity are zero."""
    z = torch.zeros_like(r2)
    return {"sum": {"a_hydro0": z, "a_hydro1": z, "a_hydro2": z,
                    "u_dt": z, "h_dt": z},
            "max": {"v_sig": z}}


def end_force(p, s):
    return s


def predict_extra(p: NoneParams, s, cosmo: CosmoFactors, dt_drift,
                  dt_therm):
    return s


def kick_extra(p: NoneParams, s, cosmo: CosmoFactors, dt_therm):
    return s


def compute_timestep(p: NoneParams, s, cosmo: CosmoFactors):
    """No CFL limit (the None scheme's timestep is FLT_MAX)."""
    return torch.full_like(s["h"], 1e30)


def timestep_h_change_limit(p: NoneParams, s):
    return torch.full_like(s["h"], 1e30)


PARAMS = NoneParams
_THIS_MODULE = sys.modules[__name__]

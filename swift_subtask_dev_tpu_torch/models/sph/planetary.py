"""The Planetary SPH scheme in torch: Minimal's density-energy SPH with
multi-material equations of state.

Port of the reference's ``models/sph/planetary.py`` (SWIFT's
src/hydro/Planetary/: its force loop is Minimal's Price-2012 form, and
its lifecycle calls the planetary EOS with each particle's material id,
hydro.h:132, 692-696, 793-797).  The scheme carries an integer ``mat_id``
per particle (the ICs' PartType0/MaterialIDs) through the tiled state
(``EXTRA_STATE_INT_KEYS``: int32 through loading, rebucket and re-grid)
and takes pressure and sound speed from
``planetary_eos.PlanetaryEOS``.  Its pair bodies are Minimal's
(``CUDA_STRUCT``): its modes run Minimal's libraries of the flat kernel.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from . import minimal, sphenix
from .kernels import CUBIC_SPLINE, SPHKernel
from .planetary_eos import ID_IDG_DEF, PlanetaryEOS
from .sphenix import HYDRO_DIM_INV, CosmoFactors, _safe_h

NAME = "planetary"
CUDA_STRUCT = minimal.CUDA_STRUCT
HAS_GRADIENT_LOOP = False
DENSITY_NEEDS_U = False
DENSITY_EXTRA_KEYS = ()
# the material id rides the tiled state through rebuilds and rebuckets
EXTRA_STATE_KEYS = ("mat_id",)
EXTRA_STATE_INT_KEYS = ("mat_id",)
GRADIENT_SUM_KEYS = sphenix.GRADIENT_SUM_KEYS
GRADIENT_J_EXTRA = ()
PREPARE_GRADIENT_KEYS = sphenix.PREPARE_GRADIENT_KEYS
GRADIENT_END_KEYS = sphenix.GRADIENT_END_KEYS
PREPARE_FORCE_KEYS = sphenix.PREPARE_FORCE_KEYS

density_terms = sphenix.density_terms
density_params = sphenix.density_params
force_params = minimal.force_params
end_density = sphenix.end_density
ghost_h_update = sphenix.ghost_h_update
no_neighbours_fallback = sphenix.no_neighbours_fallback
reset_acceleration = sphenix.reset_acceleration
end_force = sphenix.end_force
kick_extra = sphenix.kick_extra
compute_timestep = sphenix.compute_timestep
timestep_h_change_limit = sphenix.timestep_h_change_limit
init_part = sphenix.init_part
reset_gradient = minimal.reset_gradient
gradient_terms = minimal.gradient_terms
end_gradient = minimal.end_gradient
force_terms = minimal.force_terms  # Price-2012 form (hydro_iact.h:307-342)


@dataclass(frozen=True)
class PlanetaryParams:
    """SPH: YAML section for the Planetary scheme (hydro_parameters.h);
    ``eos`` is the run's PlanetaryEOS."""

    kernel: SPHKernel = CUBIC_SPLINE
    eos: PlanetaryEOS = field(
        default_factory=lambda: PlanetaryEOS(materials=(ID_IDG_DEF,)))
    eta_neighbours: float = 1.2348
    h_tolerance: float = 1e-4
    CFL: float = 0.1
    h_max: float = 1e30
    h_min: float = 0.0
    minimal_internal_energy: float = 0.0
    log_max_h_change: float = 0.0953101798  # ln(1.1)
    viscosity_alpha: float = 1.5   # planetary hydro_parameters.h default
    diffusion_alpha: float = 0.0

    @property
    def eta_dim(self) -> float:
        return self.eta_neighbours ** 3

    @property
    def mod(self):
        return _THIS_MODULE


def _P_cs(p: PlanetaryParams, rho, u, mat_id):
    rho_s = torch.clamp_min(rho, 1e-30)
    P = p.eos.pressure_from_internal_energy(rho_s, u, mat_id)
    cs = p.eos.soundspeed_from_internal_energy(rho_s, u, mat_id)
    return P, cs


def prepare_gradient(p: PlanetaryParams, s, cosmo: CosmoFactors):
    """Balsara + grad-h + the EOS by material (planetary hydro.h:676-712);
    the constant viscosity alpha folds into the Balsara factor as
    Minimal's (hydro.h:754)."""
    P, cs = _P_cs(p, s["rho"], s["u"], s["mat_id"])
    rv = s["rot_v"]
    curl_v = torch.sqrt(torch.sum(rv * rv, dim=-1))
    abs_div_v = torch.abs(s["div_v"])
    balsara = abs_div_v / (
        abs_div_v + curl_v + 1e-30
        + 0.0001 * cs * cosmo.a_factor_Balsara_eps
        / torch.clamp_min(s["h"], 1e-30))

    common = s["h"] * HYDRO_DIM_INV / torch.clamp_min(s["wcount"], 1e-30)
    grad_W_term = common * s["wcount_dh"]
    grad_h_term = torch.where(
        grad_W_term < -0.9999, 0.0,
        common * s["rho_dh"] / (1.0 + grad_W_term))
    grad_h_term = torch.where(s["h"] > 0.9999 * p.h_max, 0.0, grad_h_term)
    return {**s, "f_gradh": grad_h_term, "pressure": P, "soundspeed": cs,
            "balsara": balsara * p.viscosity_alpha}


def prepare_force(p: PlanetaryParams, s, cosmo: CosmoFactors, dt_alpha):
    """Constant viscosity alpha: nothing evolves (hydro.h:838)."""
    return s


def predict_extra(p: PlanetaryParams, s, cosmo: CosmoFactors, dt_drift,
                  dt_therm):
    """Drift extrapolation with the material EOS (hydro_predict_extra,
    planetary hydro.h:760-800)."""
    u = s["u"] + s["u_dt"] * dt_therm
    h_inv = 1.0 / _safe_h(s)
    w1 = s["h_dt"] * h_inv * dt_drift
    h = torch.clamp(s["h"] * torch.exp(w1), 0.0, p.h_max)
    rho = s["rho"] * torch.exp(-3.0 * w1)
    min_u = p.minimal_internal_energy / cosmo.a_factor_internal_energy
    u = torch.clamp_min(u, min_u)
    P, cs = _P_cs(p, rho, u, s["mat_id"])
    v_sig = torch.maximum(s["v_sig"], 2.0 * cs)
    return {**s, "u": u, "h": h, "rho": rho, "pressure": P,
            "soundspeed": cs, "v_sig": v_sig}


def reset_predicted_values(p: PlanetaryParams, s):
    """hydro_reset_predicted_values (planetary hydro.h:820-860)."""
    P, cs = _P_cs(p, s["rho"], s["u_full"], s["mat_id"])
    return {**s, "v": s["v_full"], "u": s["u_full"], "pressure": P,
            "soundspeed": cs,
            "v_sig": torch.maximum(s["v_sig"], 2.0 * cs)}


PARAMS = PlanetaryParams
_THIS_MODULE = sys.modules[__name__]

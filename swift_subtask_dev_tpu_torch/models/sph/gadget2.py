"""Gadget2 SPH scheme (entropy formulation) in torch.

Port of the reference's ``models/sph/gadget2.py`` (SWIFT's
src/hydro/Gadget2/).  The evolved thermodynamic variable is the entropic
function A = P / rho^gamma, which rides in the engine's ``u`` /
``u_full`` / ``u_dt`` slots; the lifecycle functions below make every
A <-> P conversion, so the engine and the loops stay scheme-agnostic.
No gradient loop; constant alpha folded into the Balsara factor.  The
force terms are ``Gadget2`` in ``csrc/pair_bodies.cuh``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from . import sphenix
from .eos import IdealGas
from .kernels import CUBIC_SPLINE, SPHKernel
from .sphenix import (CONST_VISCOSITY_BETA, HYDRO_DIM,
                      HYDRO_DIM_INV, CosmoFactors, _safe_h)

NAME = "gadget2"
CUDA_STRUCT = "Gadget2"
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

# scheme-generic pieces shared with SPHENIX (identical formulas in SWIFT's
# Gadget2 files: density sums, h iteration, CFL)
density_terms = sphenix.density_terms
end_density = sphenix.end_density
ghost_h_update = sphenix.ghost_h_update
no_neighbours_fallback = sphenix.no_neighbours_fallback
reset_acceleration = sphenix.reset_acceleration
compute_timestep = sphenix.compute_timestep
timestep_h_change_limit = sphenix.timestep_h_change_limit
init_part = sphenix.init_part
density_params = sphenix.density_params
force_params = sphenix.force_params


@dataclass(frozen=True)
class Gadget2Params:
    """SPH: YAML section for the Gadget2 scheme (hydro_parameters.h)."""

    kernel: SPHKernel = CUBIC_SPLINE
    eos: IdealGas = field(default_factory=IdealGas)
    eta_neighbours: float = 1.2348
    h_tolerance: float = 1e-4
    CFL: float = 0.1
    h_max: float = 1e30
    h_min: float = 0.0
    minimal_internal_energy: float = 0.0
    log_max_h_change: float = 0.0953101798  # ln(1.1)
    viscosity_alpha: float = 0.8
    diffusion_alpha: float = 0.0            # no diffusion in Gadget2

    @property
    def eta_dim(self) -> float:
        return self.eta_neighbours ** 3

    @property
    def mod(self):
        return _THIS_MODULE


# --- entropy EOS helpers (src/equation_of_state/ideal_gas/) ---------------

def _pressure_from_entropy(p, rho, A):
    return A * torch.clamp_min(rho, 1e-30) ** _f32(p.eos.gamma)


def _soundspeed_from_pressure(p, rho, P):
    return torch.sqrt(_f32(p.eos.gamma) * torch.clamp_min(P, 0.0)
                      / torch.clamp_min(rho, 1e-30))


def _entropy_from_u(p, rho, u):
    g = _f32(p.eos.gamma)
    return (g - 1.0) * u * torch.clamp_min(rho, 1e-30) ** (1.0 - g)


def _f32(x: float) -> float:
    """A python float rounded to f32 (the reference's jnp.float32(x))."""
    return torch.tensor(x, dtype=torch.float32).item()


def entropy_from_internal_energy(p: Gadget2Params, rho, u):
    """A from (rho, u): converts internal-energy ICs into the entropy
    variable this scheme evolves (numpy or torch in, torch out)."""
    return _entropy_from_u(p, torch.as_tensor(rho, dtype=torch.float32),
                           torch.as_tensor(u, dtype=torch.float32))


def internal_energy_from_entropy(p: Gadget2Params, rho, A):
    g = _f32(p.eos.gamma)
    rho = torch.as_tensor(rho, dtype=torch.float32)
    A = torch.as_tensor(A, dtype=torch.float32, device=rho.device)
    return A * torch.clamp_min(rho, 1e-30) ** (g - 1.0) / (g - 1.0)


# --- lifecycle -------------------------------------------------------------

def prepare_gradient(p: Gadget2Params, s, cosmo: CosmoFactors):
    """Pressure/soundspeed from entropy, Balsara with the constant alpha
    folded in, and Gadget2's grad-h factor f = 1/(1 + h rho_dh/(3 rho))
    (hydro_prepare_force, hydro.h:648-710)."""
    rho = torch.clamp_min(s["rho"], 1e-30)
    pressure = _pressure_from_entropy(p, rho, s["u"])
    soundspeed = _soundspeed_from_pressure(p, rho, pressure)

    rv = s["rot_v"]
    curl_v = torch.sqrt(torch.sum(rv * rv, dim=-1))
    abs_div_v = torch.abs(s["div_v"])
    balsara = p.viscosity_alpha * abs_div_v / (
        abs_div_v + curl_v + 1e-30
        + 0.0001 * soundspeed * cosmo.a_factor_Balsara_eps
        / torch.clamp_min(s["h"], 1e-30))

    rho_dh = torch.where(s["h"] > 0.9999 * p.h_max, 0.0, s["rho_dh"])
    grad_rho_term = HYDRO_DIM_INV * s["h"] * rho_dh / rho
    omega_inv = torch.where(grad_rho_term < -0.9999, 1.0,
                            1.0 / (1.0 + grad_rho_term))
    return {**s, "f_gradh": omega_inv, "pressure": pressure,
            "soundspeed": soundspeed, "balsara": balsara}


def reset_gradient(s):
    return {**s, "v_sig": 2.0 * s["soundspeed"],
            "alpha_visc_max_ngb": s["alpha_visc"]}


def gradient_terms(*args, **kw):  # pragma: no cover - scheme has no loop
    raise RuntimeError("Gadget2 scheme has no gradient loop")


def end_gradient(s):
    return s


def prepare_force(p: Gadget2Params, s, cosmo: CosmoFactors, dt_alpha):
    """No alpha evolution in Gadget2: alpha is folded into balsara."""
    return s


def force_terms(p: Gadget2Params, dx, r2, hinv_i, hinv_j, m_i, m_j,
                minv_i, minv_j, dv,
                rho_i, rho_j, rhoinv_i, rhoinv_j, pr2_i, pr2_j,
                P_i, P_j, cs_i, cs_j, f_i, f_j,
                balsara_i, balsara_j, alpha_i, alpha_j,
                alpha_diff_i, alpha_diff_j, u_i, u_j,
                cosmo: CosmoFactors):
    """Gadget2 force loop (hydro_iact.h:618-712): sph term f_i P2_i wi' +
    f_j P2_j wj', Monaghan viscosity with rho_ij = (rho_i+rho_j)/2; u_dt
    carries the raw entropy-generation sum sum_j m_j visc_term dvdr_H
    (converted to dA/dt in end_force)."""
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

    rho_ij_inv = 2.0 / (rho_i + rho_j)
    visc = -0.25 * v_sig * mu_ij * (balsara_i + balsara_j) * rho_ij_inv
    visc_term = 0.5 * visc * (wi_dr + wj_dr) * r_inv
    sph_term = (f_i * pr2_i * wi_dr + f_j * pr2_j * wj_dr) * r_inv
    acc = visc_term + sph_term

    return {
        "sum": {
            "a_hydro0": -m_j * acc * dx[0],
            "a_hydro1": -m_j * acc * dx[1],
            "a_hydro2": -m_j * acc * dx[2],
            "u_dt": m_j * visc_term * dvdr_Hubble,
            "h_dt": -m_j * dvdr * r_inv * rhoinv_j * wi_dr,
        },
        "max": {"v_sig": v_sig},
    }


def end_force(p: Gadget2Params, s):
    """hydro_end_force (hydro.h:868): h_dt dimension factor + raw entropy
    generation -> dA/dt = 0.5 (gamma-1) rho^(1-gamma) * raw sum."""
    return {**s,
            "h_dt": s["h_dt"] * s["h"] * HYDRO_DIM_INV,
            "u_dt": 0.5 * _entropy_from_u(p, s["rho"], s["u_dt"])}


def predict_extra(p: Gadget2Params, s, cosmo: CosmoFactors, dt_drift,
                  dt_therm):
    """Drift extrapolation (hydro_predict_extra, hydro.h:798): entropy
    drifts by entropy_dt; h/rho like the generic scheme; P/cs refreshed
    from the drifted entropy."""
    A = torch.clamp_min(s["u"] + s["u_dt"] * dt_therm, 0.0)
    h_inv = 1.0 / _safe_h(s)
    w1 = s["h_dt"] * h_inv * dt_drift
    h = torch.clamp(s["h"] * torch.exp(w1), 0.0, p.h_max)
    rho = s["rho"] * torch.exp(-HYDRO_DIM * w1)
    pressure = _pressure_from_entropy(p, rho, A)
    soundspeed = _soundspeed_from_pressure(p, rho, pressure)
    v_sig = torch.maximum(s["v_sig"], 2.0 * soundspeed)
    return {**s, "u": A, "h": h, "rho": rho, "pressure": pressure,
            "soundspeed": soundspeed, "v_sig": v_sig}


def reset_predicted_values(p: Gadget2Params, s):
    """hydro_reset_predicted_values (hydro.h:829, entropy variant)."""
    pressure = _pressure_from_entropy(p, s["rho"], s["u_full"])
    soundspeed = _soundspeed_from_pressure(p, s["rho"], pressure)
    return {**s, "v": s["v_full"], "u": s["u_full"],
            "pressure": pressure, "soundspeed": soundspeed,
            "v_sig": torch.maximum(s["v_sig"], 2.0 * soundspeed)}


def kick_extra(p: Gadget2Params, s, cosmo: CosmoFactors, dt_therm):
    """Entropy kick with the 0.5x floor and the minimal-energy floor
    expressed as an entropy bound (hydro_kick_extra, hydro.h:891)."""
    delta_A = s["u_dt"] * dt_therm
    A_full = torch.maximum(s["u_full"] + delta_A, 0.5 * s["u_full"])
    min_u = p.minimal_internal_energy / cosmo.a_factor_internal_energy
    A_min = _entropy_from_u(p, s["rho"], min_u)
    hit_floor = A_full < A_min
    A_full = torch.maximum(A_full, A_min)
    u_dt = torch.where(hit_floor, 0.0, s["u_dt"])
    return {**s, "u_full": A_full, "u_dt": u_dt}


PARAMS = Gadget2Params
_THIS_MODULE = sys.modules[__name__]

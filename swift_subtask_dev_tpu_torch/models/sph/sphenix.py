"""SPHENIX SPH scheme (Borrow+ 2020) in torch.

Port of the reference's ``models/sph/sphenix.py`` with the same formulas
in the same f32 operation order:

* the **pairwise terms** (``density_terms``, ``gradient_terms``,
  ``force_terms``) are the plain-torch pair bodies of the flat engine;
  ``csrc/pair_bodies.cuh`` evaluates the same expressions per pair;
* the **per-particle lifecycle** functions mirror hydro.h: end_density ->
  prepare_gradient/reset_gradient -> [gradient] -> end_gradient ->
  prepare_force/reset_acceleration -> [force] -> end_force -> kicks.

Everything is nonsym: each particle accumulates its own side of a pair.
State dicts map field names to tensors; functions return new dicts.

``SPHENIXParams.mod`` is this module: the scheme protocol the engine and
the loops dispatch through, which every scheme of ``models/sph``
declares in full: ``NAME`` (its SPH:scheme), ``PARAMS``, ``CUDA_STRUCT``
(its struct in ``csrc/pair_bodies.cuh``), ``HAS_GRADIENT_LOOP``,
``DENSITY_NEEDS_U`` (u_j in the density body's fields),
``DENSITY_EXTRA_KEYS`` (its sums after the eight), ``EXTRA_STATE_KEYS``
(``EXTRA_STATE_INT_KEYS`` among them are int32, such as Planetary's
``mat_id``), the gradient body's ``GRADIENT_SUM_KEYS`` and
``GRADIENT_J_EXTRA`` (state fields its pair terms read on both sides,
after the common ones), the keys each lifecycle hook writes back on the
active particles (``PREPARE_GRADIENT_KEYS``, ``GRADIENT_END_KEYS``,
``PREPARE_FORCE_KEYS``: the reference engine's), ``density_params(p)`` and
``force_params(p)`` (the density and force bodies' parameters after the
common ones), the term functions and the lifecycle hooks.  A scheme whose
u slot holds the entropic function A also defines
``entropy_from_internal_energy`` and ``internal_energy_from_entropy``
(``models.sph.u_is_entropy``).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .eos import IdealGas
from .kernels import CUBIC_SPLINE, SPHKernel

NAME = "sphenix"
CUDA_STRUCT = "Sphenix"
HAS_GRADIENT_LOOP = True
DENSITY_NEEDS_U = False
DENSITY_EXTRA_KEYS = ()
EXTRA_STATE_KEYS = ()
EXTRA_STATE_INT_KEYS = ()
GRADIENT_SUM_KEYS = ("laplace_u",)
GRADIENT_J_EXTRA = ()
# the keys the engine writes back after each hook (the reference engine's
# defaults, engine.py:505-523); v_sig and alpha_visc_max_ngb follow
# prepare_gradient too, reset_gradient's
PREPARE_GRADIENT_KEYS = ("f_gradh", "pressure", "soundspeed", "balsara")
GRADIENT_END_KEYS = ("laplace_u",)
PREPARE_FORCE_KEYS = ("alpha_visc", "div_v_prev", "alpha_diff")

HYDRO_DIM = 3.0
HYDRO_DIM_INV = 1.0 / 3.0

# reference hydro/SPHENIX/hydro_parameters.h:53-101
CONST_VISCOSITY_BETA = 3.0
DEFAULT_VISCOSITY_ALPHA = 0.1
DEFAULT_VISCOSITY_ALPHA_MIN = 0.0
DEFAULT_VISCOSITY_ALPHA_MAX = 2.0
DEFAULT_VISCOSITY_LENGTH = 0.05
DEFAULT_DIFFUSION_ALPHA = 0.0
DEFAULT_DIFFUSION_BETA = 1.0
DEFAULT_DIFFUSION_ALPHA_MAX = 1.0
DEFAULT_DIFFUSION_ALPHA_MIN = 0.0


@dataclass(frozen=True)
class SPHENIXParams:
    """Static scheme parameters (reference struct hydro_props)."""

    kernel: SPHKernel = CUBIC_SPLINE
    eos: IdealGas = IdealGas(5.0 / 3.0)
    eta_neighbours: float = 1.2348        # SPH:resolution_eta
    h_tolerance: float = 1e-4             # SPH:h_tolerance
    h_max: float = 1e30                   # SPH:h_max
    h_min: float = 0.0
    CFL: float = 0.1                      # SPH:CFL_condition
    minimal_internal_energy: float = 0.0
    viscosity_alpha: float = DEFAULT_VISCOSITY_ALPHA
    viscosity_alpha_min: float = DEFAULT_VISCOSITY_ALPHA_MIN
    viscosity_alpha_max: float = DEFAULT_VISCOSITY_ALPHA_MAX
    viscosity_length: float = DEFAULT_VISCOSITY_LENGTH
    diffusion_alpha: float = DEFAULT_DIFFUSION_ALPHA
    diffusion_beta: float = DEFAULT_DIFFUSION_BETA
    diffusion_alpha_max: float = DEFAULT_DIFFUSION_ALPHA_MAX
    diffusion_alpha_min: float = DEFAULT_DIFFUSION_ALPHA_MIN
    max_volume_change: float = 1.4

    @property
    def eta_dim(self) -> float:
        """eta^3, the n_target of the h iteration (runner_ghost.c:1205)."""
        return self.eta_neighbours ** 3

    @property
    def log_max_h_change(self) -> float:
        return math.log(self.max_volume_change ** HYDRO_DIM_INV)

    @property
    def mod(self):
        """The scheme module implementing this params object: the engine
        and the loops dispatch every scheme hook through it (the
        reference's compile-time scheme selection, hydro.h:32-80)."""
        return _THIS_MODULE


class CosmoFactors(NamedTuple):
    """Scale-factor-dependent factors entering the SPH equations.

    Python floats, each rounded to f32: the identity a=1, H=0 of
    ``no_cosmo``, or ``models.cosmology.Cosmology.factors_at(ti)``, which
    the engine takes anew every step.  The torch code multiplies them in;
    the CUDA pair bodies take theirs (``hydro_flat._cosmo_params``) as
    launch arguments, so a new step's factors need no rebuild.
    """

    a: float
    H: float
    a_inv2: float                 # 1/a^2
    fac_mu: float                 # a^{3(gamma-1)/2 - 1}
    a_factor_sound_speed: float
    a_factor_Balsara_eps: float
    a_factor_internal_energy: float

    @classmethod
    def no_cosmo(cls) -> "CosmoFactors":
        return cls(a=1.0, H=0.0, a_inv2=1.0, fac_mu=1.0,
                   a_factor_sound_speed=1.0, a_factor_Balsara_eps=1.0,
                   a_factor_internal_energy=1.0)


def _cube(x):
    return x * x * x


def _r_inv(r2):
    return torch.where(r2 > 0, torch.rsqrt(torch.clamp_min(r2, 1e-38)), 0.0)


# ---------------------------------------------------------------------------
# Pairwise terms (broadcast-ready component tensors in, contribution dicts
# out; the caller masks and reduces).
# ---------------------------------------------------------------------------

def density_terms(p: SPHENIXParams, dx, r2, hinv_i, m_j, dv):
    """Nonsym density contributions to i (hydro_iact.h:131-180)."""
    r_inv = _r_inv(r2)
    r = r2 * r_inv
    ui = r * hinv_i
    wi, wi_dx = p.kernel.deval(ui)
    faci = m_j * wi_dx * r_inv
    dvdr = dv[0] * dx[0] + dv[1] * dx[1] + dv[2] * dx[2]
    curl0 = dv[1] * dx[2] - dv[2] * dx[1]
    curl1 = dv[2] * dx[0] - dv[0] * dx[2]
    curl2 = dv[0] * dx[1] - dv[1] * dx[0]
    kick = HYDRO_DIM * wi + ui * wi_dx
    return {
        "rho": m_j * wi,
        "rho_dh": -m_j * kick,
        "wcount": wi,
        "wcount_dh": -kick,
        "div_v": -faci * dvdr,
        "rot_v0": faci * curl0,
        "rot_v1": faci * curl1,
        "rot_v2": faci * curl2,
    }


def gradient_terms(p: SPHENIXParams, dx, r2, hinv_i, m_j, dv,
                   u_i, u_j, rhoinv_j, cs_i, cs_j, alpha_visc_j,
                   cosmo: CosmoFactors):
    """Nonsym gradient-loop contributions to i (hydro_iact.h:196-343)."""
    r_inv = _r_inv(r2)
    r = r2 * r_inv
    dvdr = dv[0] * dx[0] + dv[1] * dx[1] + dv[2] * dx[2]
    dvdr_Hubble = dvdr + cosmo.a * cosmo.a * cosmo.H * r2
    omega_ij = torch.clamp_max(dvdr_Hubble, 0.0)
    mu_ij = cosmo.fac_mu * r_inv * omega_ij
    new_v_sig = cs_i + cs_j - CONST_VISCOSITY_BETA * mu_ij
    ui = r * hinv_i
    wi, wi_dx = p.kernel.deval(ui)
    delta_u_factor = (u_i - u_j) * r_inv
    return {
        "sum": {"laplace_u": m_j * delta_u_factor * wi_dx * rhoinv_j},
        "max": {"v_sig": new_v_sig,
                "alpha_visc_max_ngb": alpha_visc_j},
    }


def force_terms(p: SPHENIXParams, dx, r2, hinv_i, hinv_j, m_i, m_j,
                minv_i, minv_j, dv,
                rho_i, rho_j, rhoinv_i, rhoinv_j, pr2_i, pr2_j,
                P_i, P_j, cs_i, cs_j, f_i, f_j,
                balsara_i, balsara_j, alpha_i, alpha_j,
                alpha_diff_i, alpha_diff_j, u_i, u_j,
                cosmo: CosmoFactors):
    """Nonsym force contributions to i (hydro_iact.h:343-476); the caller
    applies the symmetric range r2 < gamma^2*max(h_i,h_j)^2."""
    r_inv = _r_inv(r2)
    r = r2 * r_inv

    hid_inv = (hinv_i * hinv_i) * (hinv_i * hinv_i)  # 1/h^(d+1)
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

    # one fused reciprocal for both per-pair denominators
    rho_sum = rho_i + rho_j
    P_sum = P_i + P_j + 1e-30
    inv_rhoP = 1.0 / (rho_sum * P_sum)
    rho_ij_inv = inv_rhoP * P_sum
    P_sum_inv = inv_rhoP * rho_sum
    alpha = alpha_i + alpha_j
    visc = -0.25 * alpha * v_sig * mu_ij * (balsara_i + balsara_j) \
        * rho_ij_inv
    visc_acc_term = 0.5 * visc * (wi_dr * f_ij + wj_dr * f_ji) * r_inv

    P_over_rho2_i = pr2_i * f_ij
    P_over_rho2_j = pr2_j * f_ji
    sph_acc_term = (P_over_rho2_i * wi_dr + P_over_rho2_j * wj_dr) * r_inv
    acc = sph_acc_term + visc_acc_term

    sph_du_term_i = P_over_rho2_i * dvdr * r_inv * wi_dr
    visc_du_term = 0.5 * visc_acc_term * dvdr_Hubble

    alpha_diff = (P_i * alpha_diff_i + P_j * alpha_diff_j) * P_sum_inv
    v_diff = alpha_diff * 0.5 * (
        torch.sqrt(2.0 * torch.abs(P_i - P_j) * rho_ij_inv)
        + torch.abs(cosmo.fac_mu * r_inv * dvdr_Hubble))
    diff_du_term = v_diff * (u_i - u_j) * (
        f_ij * wi_dr * rhoinv_i + f_ji * wj_dr * rhoinv_j)

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


# ---------------------------------------------------------------------------
# Per-particle lifecycle (reference hydro.h).
# ---------------------------------------------------------------------------

def _safe_h(s):
    """h with empty slots replaced by 1 (division-safe)."""
    h = s["h"]
    if "mask" in s:
        h = torch.where(s["mask"] > 0, h, 1.0)
    return torch.clamp_min(h, 1e-30)


def init_part(s):
    """Zero density-loop accumulators (hydro_init_part, hydro.h:553)."""
    z = torch.zeros_like(s["rho"])
    return {**s, "wcount": z, "wcount_dh": z, "rho": z, "rho_dh": z,
            "rot_v": torch.zeros_like(s["rot_v"]), "div_v": z,
            "laplace_u": z}


def end_density(p: SPHENIXParams, s, cosmo: CosmoFactors):
    """Self-contribution + h-factors (hydro_end_density, hydro.h:599)."""
    h = _safe_h(s)
    h_inv = 1.0 / h
    h_inv_dim = _cube(h_inv)
    h_inv_dim_p1 = h_inv_dim * h_inv
    kroot = p.kernel.root

    rho = (s["rho"] + s["m"] * kroot) * h_inv_dim
    rho_dh = (s["rho_dh"] - HYDRO_DIM * s["m"] * kroot) * h_inv_dim_p1
    wcount = (s["wcount"] + kroot) * h_inv_dim
    wcount_dh = (s["wcount_dh"] - HYDRO_DIM * kroot) * h_inv_dim_p1

    rho_safe = torch.clamp_min(rho, 1e-30)
    rho_inv = 1.0 / rho_safe
    fac = h_inv_dim_p1 * cosmo.a_inv2 * rho_inv
    rot_v = s["rot_v"] * fac[..., None]
    div_v = s["div_v"] * fac + cosmo.H * HYDRO_DIM
    return {**s, "rho": rho, "rho_dh": rho_dh, "wcount": wcount,
            "wcount_dh": wcount_dh, "rot_v": rot_v, "div_v": div_v}


def prepare_gradient(p: SPHENIXParams, s, cosmo: CosmoFactors):
    """Balsara switch, grad-h term, pressure, soundspeed (hydro.h:654)."""
    rv = s["rot_v"]
    curl_v = torch.sqrt(rv[..., 0] * rv[..., 0] + rv[..., 1] * rv[..., 1]
                        + rv[..., 2] * rv[..., 2])
    abs_div_v = torch.abs(s["div_v"])
    pressure = p.eos.pressure_from_internal_energy(s["rho"], s["u"])
    soundspeed = p.eos.soundspeed_from_pressure(
        torch.clamp_min(s["rho"], 1e-30), pressure)
    balsara = abs_div_v / (
        abs_div_v + curl_v + 1e-30
        + 0.0001 * soundspeed * cosmo.a_factor_Balsara_eps
        / torch.clamp_min(s["h"], 1e-30))

    common = s["h"] * HYDRO_DIM_INV / torch.clamp_min(s["wcount"], 1e-30)
    grad_W_term = common * s["wcount_dh"]
    grad_h_term = torch.where(
        grad_W_term < -0.9999, 0.0,
        common * s["rho_dh"] / (1.0 + grad_W_term))
    # h ~ h_max guard (hydro.h:700): drop changing-kernel terms.
    grad_h_term = torch.where(s["h"] > 0.9999 * p.h_max, 0.0, grad_h_term)
    return {**s, "f_gradh": grad_h_term, "pressure": pressure,
            "soundspeed": soundspeed, "balsara": balsara}


def reset_gradient(s):
    """hydro_reset_gradient (hydro.h:736)."""
    return {**s, "v_sig": 2.0 * s["soundspeed"],
            "alpha_visc_max_ngb": s["alpha_visc"]}


def end_gradient(s):
    """hydro_end_gradient (hydro.h:745)."""
    h_inv = 1.0 / _safe_h(s)
    h_inv2 = h_inv * h_inv
    return {**s, "laplace_u": s["laplace_u"] * 2.0 * (h_inv2 * h_inv2)}


def prepare_force(p: SPHENIXParams, s, cosmo: CosmoFactors, dt_alpha):
    """Artificial viscosity & diffusion alpha evolution (hydro.h:823)."""
    kern_supp = _safe_h(s) * cosmo.a * p.kernel.gamma
    kern_supp_inv = 1.0 / kern_supp
    v_sig_phys = s["v_sig"] * cosmo.a_factor_sound_speed
    pressure = p.eos.pressure_from_internal_energy(s["rho"], s["u"])
    soundspeed_phys = p.eos.soundspeed_from_pressure(
        torch.clamp_min(s["rho"], 1e-30), pressure) \
        * cosmo.a_factor_sound_speed
    sound_crossing_inv = soundspeed_phys * kern_supp_inv

    dt_alpha = torch.as_tensor(dt_alpha, dtype=torch.float32,
                               device=s["h"].device)
    div_v_dt = torch.where(dt_alpha == 0.0, 0.0,
                           (s["div_v"] - s["div_v_prev"])
                           / torch.clamp_min(dt_alpha, 1e-30))
    S = torch.where(s["div_v"] < 0.0,
                    kern_supp * kern_supp * torch.clamp_min(-div_v_dt, 0.0),
                    0.0)
    cs2 = soundspeed_phys * soundspeed_phys
    alpha_loc = p.viscosity_alpha_max * S / (cs2 + S + 1e-30)

    timescale_ratio = dt_alpha * sound_crossing_inv * p.viscosity_length
    alpha_decayed = (s["alpha_visc"] + alpha_loc * timescale_ratio) \
        / (1.0 + timescale_ratio)
    alpha_visc = torch.where(alpha_loc > s["alpha_visc"], alpha_loc,
                             alpha_decayed)
    alpha_visc = torch.clamp_min(alpha_visc, p.viscosity_alpha_min)

    # Diffusion alpha (hydro.h:900-940)
    diff_timescale_inv = v_sig_phys * kern_supp_inv
    sqrt_u_inv = 1.0 / torch.sqrt(torch.clamp_min(s["u"], 1e-30))
    alpha_diff_dt = (p.diffusion_beta * kern_supp * s["laplace_u"]
                     * cosmo.a_factor_sound_speed * sqrt_u_inv
                     * cosmo.a_inv2)
    alpha_diff_dt = alpha_diff_dt - (s["alpha_diff"]
                                     - p.diffusion_alpha_min) \
        * diff_timescale_inv
    new_alpha_diff = s["alpha_diff"] + alpha_diff_dt * dt_alpha
    new_alpha_diff = torch.clamp_min(new_alpha_diff, p.diffusion_alpha_min)
    visc_diff_limit = p.diffusion_alpha_max * (
        1.0 - s["alpha_visc_max_ngb"] / p.viscosity_alpha_max)
    new_alpha_diff = torch.minimum(new_alpha_diff, visc_diff_limit)

    return {**s, "alpha_visc": alpha_visc, "div_v_prev": s["div_v"],
            "alpha_diff": new_alpha_diff}


def reset_acceleration(s):
    """hydro_reset_acceleration (hydro.h:944)."""
    return {**s, "a_hydro": torch.zeros_like(s["a_hydro"]),
            "u_dt": torch.zeros_like(s["u_dt"]),
            "h_dt": torch.zeros_like(s["h_dt"])}


def end_force(p, s):
    """hydro_end_force (hydro.h:1080)."""
    return {**s, "h_dt": s["h_dt"] * s["h"] * HYDRO_DIM_INV}


def predict_extra(p: SPHENIXParams, s, cosmo: CosmoFactors, dt_drift,
                  dt_therm):
    """Drift-time extrapolation of u, h, rho (hydro_predict_extra, :1012)."""
    u = s["u"] + s["u_dt"] * dt_therm
    h_inv = 1.0 / _safe_h(s)
    w1 = s["h_dt"] * h_inv * dt_drift
    # cap at h_max, the ceiling the ghost enforces
    h = torch.clamp(s["h"] * torch.exp(w1), 0.0, p.h_max)
    rho = s["rho"] * torch.exp(-HYDRO_DIM * w1)
    min_u = p.minimal_internal_energy / cosmo.a_factor_internal_energy
    u = torch.clamp_min(u, min_u)
    pressure = p.eos.pressure_from_internal_energy(rho, u)
    soundspeed = p.eos.soundspeed_from_pressure(
        torch.clamp_min(rho, 1e-30), pressure)
    v_sig = torch.maximum(s["v_sig"], 2.0 * soundspeed)
    return {**s, "u": u, "h": h, "rho": rho, "pressure": pressure,
            "soundspeed": soundspeed, "v_sig": v_sig}


def reset_predicted_values(p: SPHENIXParams, s):
    """hydro_reset_predicted_values (hydro.h:966)."""
    pressure = p.eos.pressure_from_internal_energy(s["rho"], s["u_full"])
    soundspeed = p.eos.soundspeed_from_pressure(
        torch.clamp_min(s["rho"], 1e-30), pressure)
    return {**s, "v": s["v_full"], "u": s["u_full"], "pressure": pressure,
            "soundspeed": soundspeed,
            "v_sig": torch.maximum(s["v_sig"], 2.0 * soundspeed)}


def kick_extra(p: SPHENIXParams, s, cosmo: CosmoFactors, dt_therm):
    """Thermal kick with the 0.5x floor (hydro_kick_extra, hydro.h:1103)."""
    delta_u = s["u_dt"] * dt_therm
    u_full = torch.maximum(s["u_full"] + delta_u, 0.5 * s["u_full"])
    min_u = p.minimal_internal_energy / cosmo.a_factor_internal_energy
    hit_floor = u_full < min_u
    u_full = torch.clamp_min(u_full, min_u)
    u_dt = torch.where(hit_floor, 0.0, s["u_dt"])
    return {**s, "u_full": u_full, "u_dt": u_dt}


def compute_timestep(p: SPHENIXParams, s, cosmo: CosmoFactors):
    """CFL condition (hydro_compute_timestep, hydro.h:464)."""
    v_sig = torch.clamp_min(s["v_sig"], 1e-30)
    return (2.0 * p.kernel.gamma * p.CFL * cosmo.a * _safe_h(s)
            / (cosmo.a_factor_sound_speed * v_sig))


def timestep_h_change_limit(p: SPHENIXParams, s):
    """dt limit from dh/dt (timestep.h:175)."""
    return torch.where(
        s["h_dt"] != 0.0,
        torch.abs(p.log_max_h_change * s["h"] / torch.where(
            s["h_dt"] == 0.0, 1.0, s["h_dt"])),
        1e30)


# ---------------------------------------------------------------------------
# Ghost: one Newton/bisection h update (runner_ghost.c:1085-1420).
# ---------------------------------------------------------------------------

def ghost_h_update(p: SPHENIXParams, h_old, wcount, wcount_dh, left, right,
                   has_neighbours):
    """One smoothing-length iteration for all particles at once.

    Returns (h_new, left, right, converged); wcount/wcount_dh are
    post-end_density values.
    """
    h_old_dim = _cube(h_old)
    h_old_dim_m1 = h_old * h_old
    n_sum = wcount * h_old_dim
    n_target = p.eta_dim
    f = n_sum - n_target
    f_prime = wcount_dh * h_old_dim + HYDRO_DIM * wcount * h_old_dim_m1

    left = torch.where(has_neighbours & (n_sum < n_target),
                       torch.maximum(left, h_old), left)
    right = torch.where(has_neighbours & (n_sum > n_target),
                        torch.minimum(right, h_old), right)

    h_newton = h_old - f / torch.where(torch.abs(f_prime) < 1e-30,
                                       1e-30, f_prime)
    h_newton = torch.clamp(h_newton, 0.5 * h_old, 2.0 * h_old)
    h_newton = torch.clamp(h_newton, left, right)
    # No neighbours at all: double h (runner_ghost.c:1178).
    h_new = torch.where(has_neighbours, h_newton, 2.0 * h_old)

    converged = torch.abs(h_new - h_old) <= p.h_tolerance * h_old

    # Bisection fallback when ping-ponging between the brackets.
    pingpong = ((h_new == left) & (h_old == right)) | \
               ((h_old == left) & (h_new == right))
    h_bisect = (0.5 * (_cube(left) + _cube(right))) ** HYDRO_DIM_INV
    h_new = torch.where(pingpong & ~converged, h_bisect, h_new)

    # Clamp to the allowed range; clamped particles count as converged.
    hit_max = h_new >= p.h_max
    hit_min = h_new <= p.h_min
    h_new = torch.clamp(h_new, p.h_min, p.h_max)
    converged = converged | hit_max | hit_min
    return h_new, left, right, converged


def no_neighbours_fallback(p: SPHENIXParams, s):
    """hydro_part_has_no_neighbours (hydro.h:793)."""
    h_inv_dim = _cube(1.0 / _safe_h(s))
    kroot = p.kernel.root
    none = s["wcount"] * _cube(s["h"]) < 1e-5 * p.eta_dim

    def w(field, val):
        return torch.where(none, val, s[field])
    return {**s,
            "rho": w("rho", s["m"] * kroot * h_inv_dim),
            "v_sig": w("v_sig", 0.0),
            "wcount": w("wcount", kroot * h_inv_dim),
            "rho_dh": w("rho_dh", 0.0),
            "wcount_dh": w("wcount_dh", 0.0),
            "div_v": w("div_v", 0.0),
            "laplace_u": w("laplace_u", 0.0),
            "rot_v": torch.where(none[..., None], 0.0, s["rot_v"])}


def density_params(p) -> tuple:
    """The density body's own parameters: none."""
    return ()


def force_params(p) -> tuple:
    """The force body's own parameters: none."""
    return ()


PARAMS = SPHENIXParams
_THIS_MODULE = sys.modules[__name__]

"""EAGLE black holes: Bondi accretion, gas swallowing, AGN heating.

Port of the reference's ``subgrid/black_holes.py`` (SWIFT's
src/black_holes/EAGLE/black_holes.h and black_holes_iact.h):

* Bondi-Hoyle accretion mdot = 4 pi G^2 M^2 rho / (cs^2 + v^2)^(3/2) with
  a boost factor and the Eddington ceiling (black_holes_properties.h);
* the subgrid mass grows by (1 - eps_r) mdot dt; the dynamical mass only
  grows by swallowing gas particles, each gas neighbour with probability
  (M_subgrid - M_dyn) / (sum of the neighbour masses);
* AGN: the reservoir gains eps_f eps_r mdot c^2 dt and fires stochastic
  Delta_T heating events (``ops.stencil.feedback_apply_loop``) once it can
  heat ``n_heat`` mean neighbour masses.

``DefaultBlackHoles`` is the passive model (density pass only);
``seed_from_fof`` places seeds in FOF groups on the host.  The
reference's spin-jet model is not ported (ROADMAP.md).  ``kind`` is what
``engine_multi.multi_step`` branches on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MSUN_CGS = 1.98841e33


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class EagleBlackHoles:
    """The EAGLEAGN section in internal units."""

    G: float = 1.0
    c_light: float = 1.0                 # speed of light (internal)
    eps_r: float = 0.1                   # radiative efficiency
    eps_f: float = 0.15                  # coupling efficiency
    boost_alpha: float = 1.0             # Bondi boost
    f_edd_max: float = 1.0               # Eddington ceiling fraction
    edd_pref: float = 0.0                # 4 pi G m_p / (sigma_T c eps_r)
    delta_u: float = 0.0                 # AGN heating jump (Delta_T)
    n_heat: float = 1.0                  # reservoir threshold (particles)
    seed_mass: float = 0.0
    seed_halo_mass: float = 0.0
    # repositioning to the potential minimum (black_holes_iact.h:290);
    # ratios in units of the baryon softening, 0 = off
    reposition_ratio: float = 0.0
    repos_vel_ratio: float = 0.0         # x cs_gas; 0 = no velocity cut
    repos_vel_min: float = 0.0
    # BH-BH mergers (black_holes_iact.h bh_bh_swallow; 0 = off)
    merging_ratio: float = 0.0
    merger_threshold: str = "escape_velocity"

    kind = "eagle"

    @staticmethod
    def from_params(params, units, phys_const, G_newton: float
                    ) -> "EagleBlackHoles":
        """The constants folded in float64 as the reference folds them;
        repositioning and mergers are on unless the section turns them
        off."""
        sec = "EAGLEAGN"
        kB = phys_const.const_boltzmann_k
        m_p = phys_const.const_proton_mass
        c = 2.99792458e10 * units.from_cgs("velocity")
        sigma_T = 6.6524587e-25 * units.from_cgs("length") ** 2
        dT = params.opt_float(sec, "AGN_delta_T_K", 10.0 ** 8.5)
        mu_ion = 0.5954
        gamma = 5.0 / 3.0
        eps_r = params.opt_float(sec, "radiative_efficiency", 0.1)
        msun = MSUN_CGS * units.from_cgs("mass")
        return EagleBlackHoles(
            G=G_newton, c_light=c, eps_r=eps_r,
            eps_f=params.opt_float(sec, "coupling_efficiency", 0.15),
            boost_alpha=params.opt_float(sec, "boost_alpha", 1.0),
            f_edd_max=params.opt_float(sec, "max_eddington_fraction", 1.0),
            edd_pref=4.0 * np.pi * G_newton * m_p / (sigma_T * c * eps_r),
            delta_u=kB * dT / ((gamma - 1.0) * mu_ion * m_p),
            n_heat=params.opt_float(sec, "AGN_num_ngb_to_heat", 1.0),
            seed_mass=params.opt_float(sec, "subgrid_seed_mass_Msun", 1e5)
            * msun,
            seed_halo_mass=params.opt_float(sec, "seed_halo_mass_Msun",
                                            1e10) * msun,
            reposition_ratio=params.opt_float(
                sec, "max_reposition_distance_ratio", 3.0),
            repos_vel_ratio=(params.opt_float(
                sec, "max_reposition_velocity_ratio", 0.5)
                if params.opt_int(
                    sec, "with_reposition_velocity_threshold", 1)
                else 0.0),
            repos_vel_min=max(0.0, params.opt_float(
                sec, "min_reposition_velocity_threshold_km_p_s", -1.0))
            * 1.0e5 * units.from_cgs("velocity"),
            merging_ratio=params.opt_float(
                sec, "max_merging_distance_ratio", 3.0),
            merger_threshold=params.opt_string(
                sec, "merger_threshold_type", "escape_velocity").lower())

    def bondi_rate(self, m_subgrid, rho_phys, cs_phys, v_rel2_phys):
        """mdot = min(alpha 4 pi G^2 M^2 rho / (cs^2 + v^2)^1.5,
        f_edd mdot_edd) (black_holes.h compute_accretion_rate)."""
        denom = torch.clamp_min(cs_phys ** 2 + v_rel2_phys, 1e-30) ** 1.5
        # the reference's scalar chain, each product rounded to f32
        f = np.float32
        pref = float(f(f(f(self.boost_alpha) * f(4.0)) * f(np.pi))
                     * f(f(self.G) ** 2))
        mdot = pref * m_subgrid ** 2 * rho_phys / denom
        mdot_edd = _f32(self.edd_pref) * m_subgrid
        return torch.minimum(mdot, _f32(self.f_edd_max) * mdot_edd)

    def accrete(self, bh, dens, cosmo, dt):
        """Grow the subgrid mass and the reservoir; the per-neighbour
        swallow probability of the mass deficit.  ``dens`` comes from
        ``ops.black_holes.bh_gas_density_loop``.  Returns the updated bh
        dict."""
        live = bh["mask"] > 0
        # empty slots at h = 1 (the reference's h of 0 gives them NaN)
        h = torch.where(live, torch.clamp_min(bh["h"], 1e-30), 1.0)
        h_inv_dim = (1.0 / h) ** 3
        rho_com = dens["rho"] * h_inv_dim
        rho_phys = rho_com * _f32(cosmo.a_inv2) / _f32(cosmo.a)
        rho_safe = torch.clamp_min(dens["rho"], 1e-30)
        v_gas = torch.stack([dens["mom0"], dens["mom1"], dens["mom2"]],
                            -1) / rho_safe[..., None]
        cs = dens["cs_w"] / rho_safe * _f32(cosmo.a_factor_sound_speed)
        dv = (v_gas - bh["v_full"]) / _f32(cosmo.a)
        v_rel2 = torch.sum(dv * dv, -1)

        mdot = self.bondi_rate(bh["m_subgrid"], rho_phys, cs, v_rel2)
        mdot = torch.where(live & (dens["ngb_mass"] > 0), mdot, 0.0)
        m_sub = bh["m_subgrid"] + _f32(1.0 - self.eps_r) * mdot * dt
        c2 = float(np.float32(self.c_light) ** 2)
        resv = bh["energy_reservoir"] \
            + _f32(self.eps_f * self.eps_r) * mdot * dt * c2
        # the deficit shared over the neighbour masses
        deficit = torch.clamp_min(m_sub - bh["m"], 0.0)
        prob = torch.where(live, deficit / torch.clamp_min(
            dens["ngb_mass"], 1e-30), 0.0)
        return {**bh, "m_subgrid": m_sub, "energy_reservoir": resv,
                "swallow_prob": torch.clamp_max(prob, 1.0), "mdot": mdot,
                "rho_gas": rho_com, "ngb_mass": dens["ngb_mass"]}

    def agn_fire(self, bh):
        """(fb_energy, new_reservoir): the reservoir is released once it
        can heat n_heat mean neighbour masses by delta_u (black_holes.h
        AGN feedback criterion)."""
        live = bh["mask"] > 0
        mean_ngb = bh["ngb_mass"] / 48.0
        e_crit = float(np.float32(self.n_heat) * np.float32(self.delta_u)) \
            * torch.clamp_min(mean_ngb, 1e-30)
        fire = live & (bh["energy_reservoir"] >= e_crit) \
            & (bh["ngb_mass"] > 0)
        fb_energy = torch.where(fire, bh["energy_reservoir"], 0.0)
        resv = torch.where(fire, 0.0, bh["energy_reservoir"])
        return fb_energy, resv


@dataclass(frozen=True)
class DefaultBlackHoles:
    """Passive black holes (black_holes/Default/black_holes.h): carried
    through gravity with their gas density and neighbour mass, and no
    accretion, swallowing or feedback."""

    kind = "default"

    @staticmethod
    def from_params(params, units, phys_const, G_newton: float
                    ) -> "DefaultBlackHoles":
        return DefaultBlackHoles()


def seed_from_fof(catalogue, gas_pos, gas_rho, bh_model,
                  gas_group_ids=None, existing_bh_pos=None,
                  min_dist: float = 0.0):
    """Host-side BH seeding (engine_fof.c): for every FOF group above
    seed_halo_mass without a BH nearby, a seed at the group's densest gas
    particle.  ``gas_group_ids`` (per gas particle, -1 = ungrouped) gives
    the membership; without it the 5% of the gas nearest the group's
    centre stand in.  Returns (seed_positions (n, 3), n_seeded)."""
    seeds = []
    masses = np.asarray(catalogue["group_mass"])
    coms = np.asarray(catalogue["group_com"])
    for gid in range(len(masses)):
        if masses[gid] < bh_model.seed_halo_mass:
            continue
        if existing_bh_pos is not None and len(existing_bh_pos):
            d = np.linalg.norm(existing_bh_pos - coms[gid], axis=1)
            if (d < max(min_dist, 1e-10)).any():
                continue
        if gas_group_ids is not None:
            members = np.asarray(gas_group_ids) == gid
            if not members.any():
                continue
        else:
            d = np.linalg.norm(gas_pos - coms[gid], axis=1)
            members = d <= np.quantile(d, 0.05) + 1e-12
        idx = np.argmax(np.where(members, gas_rho, -1.0))
        seeds.append(gas_pos[idx])
    return np.asarray(seeds).reshape(-1, 3), len(seeds)

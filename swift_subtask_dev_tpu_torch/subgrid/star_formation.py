"""EAGLE star formation: the Schaye & Dalla Vecchia (2008) pressure law.

Port of ``EagleStarFormation`` of the reference's
``subgrid/star_formation.py`` (SWIFT's
src/star_formation/EAGLE/star_formation.h): eligibility (the
metallicity-dependent density threshold, the over-density threshold and
an entropy within a margin of the floor's,
star_formation_is_star_forming_Z_dep :201), the specific SFR
A (M_sun/pc^2)^-n (gamma/G f_g P)^((n-1)/2) (:398, init :704) with its
high-density break, and the stochastic gas -> star conversion
prob = SFR dt / m against the reference's counter draw
(star_formation_should_convert :505; ``utils.prng.unit_interval``, bit
for bit).  The reference's GEAR and QLA star formation are not ported
(ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils import prng
from .entropy_floor import EagleEntropyFloor

# the conversion draw's purpose (star_formation.h :505)
SF_PURPOSE = 0x7c4865254aec6996 & 0x7FFFFFFF


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class EagleStarFormation:
    """Pressure-law star formation in internal units."""

    sf_norm: float = 0.0           # SF_normalization (init :704)
    sf_power: float = 0.2          # (n-1)/2 with n = 1.4
    high_den_thresh: float = 1e30  # KS_high_den_thresh (density, internal)
    sf_high_norm: float = 0.0
    sf_high_power: float = 0.5     # (2-1)/2 with n = 2
    density_threshold: float = 0.0  # physical density threshold (internal)
    over_density: float = 57.7
    entropy_margin: float = 10.0 ** 0.5  # 0.5 dex over the floor entropy
    rho_crit_baryon_0: float = 0.0
    hydro_gamma: float = 5.0 / 3.0
    # metallicity-dependent threshold (Schaye 2004; :201):
    # n*(Z) = norm (Z/Z0)^slope, clipped at density_threshold_max
    threshold_Z0: float = 0.002
    threshold_slope: float = 0.0    # 0 disables the Z dependence
    density_threshold_max: float = 1e30

    @staticmethod
    def from_params(params, units, phys_const, G_newton: float,
                    hydrogen_mass_fraction: float = 0.755,
                    rho_crit_baryon_0: float = 0.0,
                    floor: Optional[EagleEntropyFloor] = None
                    ) -> "EagleStarFormation":
        """The EAGLEStarFormation section (star_formation_init
        :650-740)."""
        sec = "EAGLEStarFormation"
        KS_norm_cgs = params.get_float(sec, "KS_normalisation")
        KS_n = params.opt_float(sec, "KS_exponent", 1.4)
        KS_high_n = params.opt_float(sec, "KS_high_density_exponent", 2.0)
        fgas = params.opt_float(sec, "gas_fraction", 1.0)
        nH_thresh = params.get_float(sec, "threshold_norm_H_p_cm3")
        over_density = params.opt_float(sec, "threshold_over_density", 57.7)
        margin_dex = params.opt_float(sec, "EOS_entropy_margin_dex", 0.5)
        thr_Z0 = params.opt_float(sec, "threshold_Z0", 0.002)
        thr_slope = params.opt_float(sec, "threshold_slope", 0.0)
        nH_max = params.opt_float(sec, "threshold_max_density_H_p_cm3",
                                  1e30)
        nH_high = params.opt_float(sec, "KS_high_density_threshold_H_p_cm3",
                                   1e30)
        gamma = 5.0 / 3.0

        M_sun = 1.98841e33 * units.from_cgs("mass")
        pc = 3.08567758149e18 * units.from_cgs("length")
        kpc = 1e3 * pc
        yr = 3.15569252e7 * units.from_cgs("time")
        Msun_per_pc2 = M_sun / pc ** 2
        KS_norm = KS_norm_cgs * M_sun / yr / kpc ** 2

        sf_power = (KS_n - 1.0) / 2.0
        sf_norm = (KS_norm * Msun_per_pc2 ** (-KS_n)
                   * (gamma * fgas / G_newton) ** sf_power)
        sf_high_power = (KS_high_n - 1.0) / 2.0

        m_p = phys_const.const_proton_mass
        n_to_rho = m_p / hydrogen_mass_fraction \
            * units.from_cgs("number_density")
        rho_thresh = nH_thresh * n_to_rho
        rho_high = nH_high * n_to_rho

        # continuity of the SFR at the high-density break: the high-density
        # normalisation matches the low-density law at the floor's pressure
        # of the break density (star_formation_init :730-745)
        sf_high_norm = 0.0
        if nH_high < 1e29:
            if floor is None:
                raise NotImplementedError(
                    "KS_high_density_threshold_H_p_cm3 requires an entropy "
                    "floor (EoS) to anchor the break pressure "
                    "(star_formation_init :730)")
            P_break = float(floor.pressure_floor(
                torch.tensor(rho_high, dtype=torch.float32),
                torch.tensor(1e30, dtype=torch.float32)))
            if P_break <= 0.0:
                raise ValueError(
                    "entropy floor gives zero pressure at the high-density "
                    "SF break; cannot anchor the n=%g law" % KS_high_n)
            sf_high_norm = sf_norm * P_break ** (sf_power - sf_high_power)
        return EagleStarFormation(
            sf_norm=sf_norm, sf_power=sf_power,
            high_den_thresh=rho_high, sf_high_norm=sf_high_norm,
            sf_high_power=sf_high_power,
            density_threshold=rho_thresh, over_density=over_density,
            entropy_margin=10.0 ** margin_dex,
            rho_crit_baryon_0=rho_crit_baryon_0, hydro_gamma=gamma,
            threshold_Z0=thr_Z0, threshold_slope=thr_slope,
            density_threshold_max=(nH_max * n_to_rho if nH_max < 1e29
                                   else 1e30))

    # --- device-side pieces -------------------------------------------------
    def is_star_forming(self, rho_phys, rho_com, P_phys,
                        floor: Optional[EagleEntropyFloor], Z=None):
        """Eligibility (star_formation_is_star_forming_Z_dep :201)."""
        thresh = _f32(self.density_threshold)
        if self.threshold_slope != 0.0 and Z is not None:
            # Schaye 2004 metallicity scaling, clipped at the maximum
            zr = torch.clamp_min(Z, 1e-8) / _f32(self.threshold_Z0)
            thresh = torch.clamp_max(
                thresh * zr ** _f32(self.threshold_slope),
                _f32(self.density_threshold_max))
        ok = rho_phys >= thresh
        ok = ok & (rho_com >= _f32(self.rho_crit_baryon_0
                                   * self.over_density))
        if floor is not None:
            gamma = _f32(self.hydro_gamma)
            A = P_phys / torch.clamp_min(rho_phys, 1e-30) ** gamma
            P_fl = floor.pressure_floor(rho_phys, rho_com)
            A_fl = P_fl / torch.clamp_min(rho_phys, 1e-30) ** gamma
            ok = ok & (A < A_fl * _f32(self.entropy_margin))
        return ok

    def sfr_per_mass(self, rho_phys, P_phys):
        """Specific SFR from the pressure law (:416-427)."""
        P = torch.clamp_min(P_phys, 1e-30)
        low = _f32(self.sf_norm) * P ** _f32(self.sf_power)
        high = _f32(self.sf_high_norm) * P ** _f32(self.sf_high_power)
        return torch.where(rho_phys < _f32(self.high_den_thresh), low, high)

    def conversion_mask(self, s, cosmo, dt_star, ti_lo: int, ti_hi: int,
                        floor: Optional[EagleEntropyFloor], active):
        """(should_convert, sfr) of the gas state: prob = SFR dt / m
        against the (id, ti, purpose) counter draw (:505-512)."""
        a = float(np.float32(cosmo.a))
        a_u = float(np.float32(cosmo.a_factor_internal_energy))
        a_inv2 = float(np.float32(cosmo.a_inv2))
        rho_com = torch.clamp_min(s["rho"], 1e-30)
        # physical density a^-3 rho, physical pressure a^-3gamma P
        rho_phys = rho_com * a_inv2 / a
        P_phys = s["pressure"] * a_u * a_inv2 / a
        eligible = active & self.is_star_forming(rho_phys, rho_com, P_phys,
                                                 floor, Z=s.get("Z"))
        sfr_m = self.sfr_per_mass(rho_phys, P_phys)
        sfr = torch.where(eligible, sfr_m * s["m"], 0.0)
        prob = sfr_m * dt_star
        draw = prng.unit_interval(s["pid"], ti_lo, ti_hi, SF_PURPOSE)
        return eligible & (prob > draw), sfr

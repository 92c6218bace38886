"""EAGLE entropy floor: two polytropic pressure floors (Jeans + Cool).

Port of the reference's ``subgrid/entropy_floor.py`` (SWIFT's
src/entropy_floor/EAGLE/entropy_floor.h): pressure floors P = P_norm *
(rho/rho_thresh)^gamma_eff, each active above a physical density threshold
and a baryon over-density threshold, turned into a minimum internal energy
at the particle's density.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class EagleEntropyFloor:
    """Parameters in internal units (the EAGLEEntropyFloor section).

    Pressure norms follow entropy_floor_init (entropy_floor.h:319-328):
    P_norm = kB*T_norm/(m_p*mu_neutral) * rho_threshold.
    """

    jeans_density_threshold: float = 0.0   # physical density, internal units
    jeans_over_density: float = 10.0
    jeans_pressure_norm: float = 0.0       # at the density threshold
    jeans_gamma_eff: float = 4.0 / 3.0
    cool_density_threshold: float = 0.0
    cool_over_density: float = 10.0
    cool_pressure_norm: float = 0.0
    cool_gamma_eff: float = 1.0
    rho_crit_baryon_0: float = 0.0         # Omega_b * rho_crit_0 (comoving);
    # 0 in non-cosmological runs, disabling the over-density condition

    @staticmethod
    def from_params(params, units, phys_const, hydro_gamma: float = 5.0 / 3.0,
                    mu_neutral: float = 1.2195,
                    hydrogen_mass_fraction: float = 0.755,
                    rho_crit_baryon_0: float = 0.0) -> "EagleEntropyFloor":
        """From the EAGLEEntropyFloor section (entropy_floor_init,
        entropy_floor.h:282-329)."""
        sec = "EAGLEEntropyFloor"
        n_J = params.get_float(sec, "Jeans_density_threshold_H_p_cm3")
        T_J = params.get_float(sec, "Jeans_temperature_norm_K")
        g_J = params.get_float(sec, "Jeans_gamma_effective")
        od_J = params.get_float(sec, "Jeans_over_density_threshold")
        n_C = params.get_float(sec, "Cool_density_threshold_H_p_cm3")
        T_C = params.get_float(sec, "Cool_temperature_norm_K")
        g_C = params.get_float(sec, "Cool_gamma_effective")
        od_C = params.get_float(sec, "Cool_over_density_threshold")

        m_p = phys_const.const_proton_mass
        kB = phys_const.const_boltzmann_k
        # number density [cm^-3] -> mass density in internal units
        n_to_rho = m_p / hydrogen_mass_fraction \
            * units.from_cgs("number_density")
        rho_J = n_J * n_to_rho
        rho_C = n_C * n_to_rho
        # temperature [K] -> pressure norm (entropy_floor.h:319)
        P_J = kB * T_J / (m_p * mu_neutral) * rho_J
        P_C = kB * T_C / (m_p * mu_neutral) * rho_C
        return EagleEntropyFloor(
            jeans_density_threshold=rho_J, jeans_over_density=od_J,
            jeans_pressure_norm=P_J, jeans_gamma_eff=g_J,
            cool_density_threshold=rho_C, cool_over_density=od_C,
            cool_pressure_norm=P_C, cool_gamma_eff=g_C,
            rho_crit_baryon_0=rho_crit_baryon_0)

    def pressure_floor(self, rho_phys: torch.Tensor,
                       rho_com: torch.Tensor) -> torch.Tensor:
        """Physical floor pressure at the given densities
        (entropy_floor_gas_pressure, entropy_floor.h:94-135)."""
        P = torch.zeros_like(rho_phys)
        rb = self.rho_crit_baryon_0
        if self.jeans_pressure_norm > 0.0:
            on = ((rho_com >= _f32(rb * self.jeans_over_density))
                  & (rho_phys >= _f32(self.jeans_density_threshold)))
            P_j = _f32(self.jeans_pressure_norm) * (
                rho_phys / _f32(self.jeans_density_threshold)
            ) ** _f32(self.jeans_gamma_eff)
            P = torch.where(on, torch.maximum(P, P_j), P)
        if self.cool_pressure_norm > 0.0:
            on = ((rho_com >= _f32(rb * self.cool_over_density))
                  & (rho_phys >= _f32(self.cool_density_threshold)))
            P_c = _f32(self.cool_pressure_norm) * (
                rho_phys / _f32(self.cool_density_threshold)
            ) ** _f32(self.cool_gamma_eff)
            P = torch.where(on, torch.maximum(P, P_c), P)
        return P

    def u_floor(self, rho_phys: torch.Tensor, rho_com: torch.Tensor,
                hydro_gamma: float = 5.0 / 3.0) -> torch.Tensor:
        """Minimum physical internal energy: u = P/((gamma-1) rho)."""
        P = self.pressure_floor(rho_phys, rho_com)
        return P / (_f32(hydro_gamma - 1.0)
                    * torch.clamp_min(rho_phys, 1e-30))

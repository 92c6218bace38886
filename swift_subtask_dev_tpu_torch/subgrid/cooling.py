"""Constant-Lambda cooling and the cool-part routine, in torch.

Port of ``ConstLambdaCooling`` and ``make_cooling_fn`` of the reference's
``subgrid/cooling.py`` (SWIFT's src/cooling/const_lambda/cooling.h),
without the entropy floor: ``cooling_cool_part`` (cooling.h:77) limits
the total comoving du/dt so that u stays above the minimal energy after
1.5 kicks and above 0 after 2.5, then rewrites the particle's u_dt, which
kick2 integrates.  Every other cooling model of the reference (const-du,
EAGLE, primordial, the entropy floor, rapid cooling) is refused; ROADMAP
queue 1 item 9 lists them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class ConstLambdaCooling:
    """Lambda/n_H^2 = const cooling (const_lambda/cooling.h:46).

    du/dt = -Lambda n_H^2 / rho with n_H = X_H rho / m_p is linear in rho:
    du/dt = -coeff * rho, coeff = Lambda (X_H/m_p)^2.  The coefficient is
    folded in f64 on the host: the intermediates (n_H, m_p in galactic
    internal units) overflow f32.
    """

    coeff: float = 0.0  # Lambda * (X_H/m_p)^2, internal units

    @staticmethod
    def from_cgs(lambda_nH2_cgs: float, units, phys_const,
                 hydrogen_mass_fraction: float = 0.755
                 ) -> "ConstLambdaCooling":
        # Lambda/n_H^2 [erg cm^3 s^-1] -> internal units of
        # (specific-energy rate) * density / number_density^2
        lam = lambda_nH2_cgs * (
            units.from_cgs("energy") / units.from_cgs("mass")
            / units.from_cgs("time")
            * units.from_cgs("density")
            / units.from_cgs("number_density") ** 2)
        x = hydrogen_mass_fraction / phys_const.const_proton_mass
        return ConstLambdaCooling(coeff=lam * x * x)

    def du_dt_physical(self, rho_phys: torch.Tensor) -> torch.Tensor:
        return -_f32(self.coeff) * rho_phys


def make_cooling_fn(model, floor=None, u_minimal: float = 0.0,
                    rapid: bool = False):
    """The engine's cooling hook: (state, cosmo, dt_therm) -> {"u_dt"}.

    Only ``ConstLambdaCooling`` without an entropy floor and without rapid
    cooling is ported; anything else raises."""
    if not isinstance(model, ConstLambdaCooling) or floor is not None \
            or rapid:
        raise NotImplementedError(
            "the port's cooling is constant-Lambda without an entropy "
            "floor or rapid cooling; the other models wait in ROADMAP.md "
            "(queue 1, item 9)")

    def cooling_fn(s, cosmo, dt_therm):
        a_u = cosmo.a_factor_internal_energy
        u_com = s["u_full"]
        rho_com = torch.clamp_min(s["rho"], 1e-30)
        rho_phys = rho_com * cosmo.a_inv2 / cosmo.a  # a^-3 rho_com
        du_dt_phys = model.du_dt_physical(rho_phys)
        # physical -> comoving du/dt (cooling.h:104)
        du_dt_cool = du_dt_phys * cosmo.a * cosmo.a / a_u
        total = s["u_dt"] + du_dt_cool

        # no entropy floor: the limit is the minimal internal energy
        u_limit = torch.clamp_min(torch.zeros_like(u_com),
                                  float(np.float32(u_minimal)
                                        / np.float32(a_u)))
        dt = torch.clamp_min(dt_therm, 1e-30)
        # minimal-energy limit at 1.5 dt (cooling.h:131)
        crosses = u_com + total * 1.5 * dt < u_limit
        total = torch.where(crosses, (u_limit - u_com) / (1.5 * dt), total)
        # zero-energy limit at 2.5 dt (cooling.h:139)
        negative = u_com + total * 2.5 * dt < 0.0
        total = torch.where(negative, -u_com / (2.5001 * dt), total)
        zero_dt = dt_therm <= 0.0
        return {"u_dt": torch.where(zero_dt, s["u_dt"], total)}

    return cooling_fn

"""EAGLE thermal (SNII) stellar feedback.

Port of ``EagleThermalFeedback`` of the reference's ``subgrid/feedback.py``
(SWIFT's src/feedback/EAGLE_thermal/feedback_iact.h and
src/feedback/EAGLE/feedback.h): a star past the SNII delay injects E = f_E
E_SNII m_star by heating each gas neighbour by a fixed temperature jump
Delta_T with probability E / (Delta_u sum m_ngb) (Dalla Vecchia & Schaye
2012 eq. 7; the heating itself is ``ops.stencil.feedback_apply_loop``).
Heated inactive particles join the current step (runner_do_sync) through
the limiter's wake tables.  The reference's kinetic and GEAR feedback are
not ported (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class EagleThermalFeedback:
    """SNII thermal feedback parameters (internal units)."""

    delta_u: float = 0.0        # heating jump per unit mass
    e_per_mass: float = 0.0     # f_E * E_SNII per unit stellar mass
    snii_delay: float = 0.0     # age at which the star fires (in the
    # units of the engine's birth-time stamp: a scale-factor interval in
    # cosmological runs)

    @staticmethod
    def from_physical(units, phys_const, delta_T_K: float = 10 ** 7.5,
                      f_E: float = 1.0,
                      num_SNII_per_Msun: float = 1.73621e-2,
                      E_SNII_cgs: float = 1.0e51,
                      snii_delay: float = 0.0,
                      mu_ionised: float = 0.5954,
                      hydro_gamma: float = 5.0 / 3.0
                      ) -> "EagleThermalFeedback":
        """Defaults as the reference's EAGLE parameters (feedback_props.c:
        SNII_delta_T_K = 10^7.5, 1.736e-2 SNII per Msun, 10^51 erg)."""
        kB = phys_const.const_boltzmann_k
        m_p = phys_const.const_proton_mass
        du = kB * delta_T_K / ((hydro_gamma - 1.0) * mu_ionised * m_p)
        M_sun = 1.98841e33 * units.from_cgs("mass")
        E_int = E_SNII_cgs * units.from_cgs("energy")
        return EagleThermalFeedback(
            delta_u=du,
            e_per_mass=f_E * num_SNII_per_Msun * E_int / M_sun,
            snii_delay=snii_delay)

    def firing_energy(self, stars, t_now: float, active):
        """(energy to inject this step, fire flag) per star: live, active
        stars born in the run whose age crossed the SNII delay and which
        have not fired yet."""
        age = float(np.float32(t_now)) - stars["birth_time"]
        fire = (active & (stars["fb_done"] <= 0)
                & (age >= float(np.float32(self.snii_delay)))
                & (stars["mask"] > 0) & (stars["birth_time"] > 0))
        energy = torch.where(
            fire, float(np.float32(self.e_per_mass)) * stars["m"], 0.0)
        return energy, fire

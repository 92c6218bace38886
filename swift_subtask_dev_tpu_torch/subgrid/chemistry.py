"""EAGLE chemistry: the 9-element mass-fraction carriers.

Port of ``EagleChemistry`` of the reference's ``subgrid/chemistry.py``
(SWIFT's src/chemistry/EAGLE/chemistry.h: metal_mass_fraction[9] and
metal_mass_fraction_total): per-particle element mass fractions (H, He,
C, N, O, Ne, Mg, Si, Fe) and the total metallicity, initialised from the
EAGLEChemistry section (init_abundance_*) or read from the ICs, carried
through star formation (stars inherit their gas particle's abundances)
and consumed, kernel-smoothed (``ops.stencil.chemistry_smooth_loop``), by
the cooling tables and the metallicity-dependent star-formation
threshold.  The reference's GEAR chemistry is not ported (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ELEMENT_NAMES = ("Hydrogen", "Helium", "Carbon", "Nitrogen", "Oxygen",
                 "Neon", "Magnesium", "Silicon", "Iron")
N_ELEMENTS = len(ELEMENT_NAMES)


@dataclass(frozen=True)
class EagleChemistry:
    """Initial abundances (chemistry_init_backend, EAGLE/chemistry.h)."""

    init_fractions: tuple = (0.752, 0.248, 0.0, 0.0, 0.0,
                             0.0, 0.0, 0.0, 0.0)
    init_metallicity: float = 0.0

    @staticmethod
    def from_params(params) -> "EagleChemistry":
        sec = "EAGLEChemistry"
        fr = [params.opt_float(sec, f"init_abundance_{n}", d)
              for n, d in zip(ELEMENT_NAMES,
                              (0.752, 0.248, 0.0, 0.0, 0.0,
                               0.0, 0.0, 0.0, 0.0))]
        Z = params.opt_float(sec, "init_abundance_metal",
                             max(0.0, 1.0 - fr[0] - fr[1]))
        return EagleChemistry(init_fractions=tuple(fr), init_metallicity=Z)

    def particle_arrays(self, n: int):
        """(Z (n,), elem_frac (n, 9)) f32 from the initial abundances (the
        reference also reads the ICs' Metallicities and
        ElementMassFractions; the port reads no IC file)."""
        ef = np.tile(np.asarray(self.init_fractions, np.float32), (n, 1))
        return np.full(n, self.init_metallicity, np.float32), ef

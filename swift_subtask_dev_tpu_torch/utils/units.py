"""CGS-anchored unit system, equivalent to SWIFT's src/units.c.

A copy of the JAX package's ``utils/units.py`` (plain Python): what
cosmology and cooling need, ``UnitSystem.constants`` and ``from_cgs``.

The reference defines an internal unit system by five base units given in CGS
(mass, length, time-via-velocity, current, temperature) and converts every
I/O quantity through exponents of those base units (units.c:232-389,
``units_general_cgs_conversion_factor``).  We reproduce that: a
:class:`UnitSystem` carries the five base factors and converts named
quantities through the same exponent table.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import constants as cgs
from .constants import PhysicalConstants

# Exponent tuples: (mass, length, time, current, temperature)
# Mirrors units_get_base_unit_exponents_array (reference src/units.c:130-389).
UNIT_EXPONENTS = {
    "none": (0, 0, 0, 0, 0),
    "mass": (1, 0, 0, 0, 0),
    "length": (0, 1, 0, 0, 0),
    "time": (0, 0, 1, 0, 0),
    "current": (0, 0, 0, 1, 0),
    "temperature": (0, 0, 0, 0, 1),
    "frequency": (0, 0, -1, 0, 0),
    "velocity": (0, 1, -1, 0, 0),
    "acceleration": (0, 1, -2, 0, 0),
    "potential": (0, 2, -2, 0, 0),
    "density": (1, -3, 0, 0, 0),
    "number_density": (0, -3, 0, 0, 0),
    "inv_volume": (0, -3, 0, 0, 0),
    "energy": (1, 2, -2, 0, 0),
    "energy_per_unit_mass": (0, 2, -2, 0, 0),
    "energy_per_unit_time": (1, 2, -3, 0, 0),
    "power_density": (1, -1, -3, 0, 0),
    "entropy": (1, 2 - 3 * (5.0 / 3.0 - 1.0), -2, 0, 0),  # gamma-law A
    "entropy_per_unit_mass": (2 - 3 * (5.0 / 3.0 - 1.0), -3 * (5.0 / 3.0 - 1.0) + 2, -2, 0, 0),
    "pressure": (1, -1, -2, 0, 0),
    "force": (1, 1, -2, 0, 0),
    "momentum": (1, 1, -1, 0, 0),
    "angular_momentum": (1, 2, -1, 0, 0),
    "newton_G": (-1, 3, -2, 0, 0),
    "magnetic_field": (1, 0, -2, -1, 0),
    "ssfr": (0, 0, -1, 0, 0),
    "sfr": (1, 0, -1, 0, 0),
    "rate": (0, 0, -1, 0, 0),
}


@dataclass(frozen=True)
class UnitSystem:
    """Internal unit system defined by 5 base units in CGS.

    Same parameters as the reference YAML section ``InternalUnitSystem:``
    (units.c:49-80): UnitMass_in_cgs, UnitLength_in_cgs, UnitVelocity_in_cgs,
    UnitCurrent_in_cgs, UnitTemp_in_cgs.  Time is derived: L / V.
    """

    UnitMass_in_cgs: float = 1.0
    UnitLength_in_cgs: float = 1.0
    UnitVelocity_in_cgs: float = 1.0
    UnitCurrent_in_cgs: float = 1.0
    UnitTemp_in_cgs: float = 1.0

    @property
    def UnitTime_in_cgs(self) -> float:
        return self.UnitLength_in_cgs / self.UnitVelocity_in_cgs

    # --- conversions -------------------------------------------------------
    def base_factors(self):
        return (
            self.UnitMass_in_cgs,
            self.UnitLength_in_cgs,
            self.UnitTime_in_cgs,
            self.UnitCurrent_in_cgs,
            self.UnitTemp_in_cgs,
        )

    def cgs_factor_for_exponents(self, exps) -> float:
        """CGS value of 1 internal unit of a quantity with given exponents."""
        fac = 1.0
        for base, e in zip(self.base_factors(), exps):
            if e != 0:
                fac *= base ** e
        return fac

    def to_cgs(self, name: str) -> float:
        """CGS value of one internal unit of the named quantity."""
        return self.cgs_factor_for_exponents(UNIT_EXPONENTS[name])

    def from_cgs(self, name: str) -> float:
        return 1.0 / self.to_cgs(name)

    def convert_from(self, other: "UnitSystem", name: str) -> float:
        """Factor converting a value in `other` units into `self` units."""
        return other.to_cgs(name) * self.from_cgs(name)

    # --- physical constants ------------------------------------------------
    def constants(self) -> PhysicalConstants:
        """Constants in this unit system (reference phys_const_init)."""
        f = self.from_cgs
        return PhysicalConstants(
            const_newton_G=cgs.NEWTON_G_CGS * f("newton_G"),
            const_speed_light_c=cgs.SPEED_LIGHT_C_CGS * f("velocity"),
            const_planck_h=cgs.PLANCK_H_CGS
            / self.cgs_factor_for_exponents((1, 2, -1, 0, 0)),
            const_boltzmann_k=cgs.BOLTZMANN_K_CGS
            * f("energy")
            * self.UnitTemp_in_cgs,
            const_thomson_cross_section=cgs.THOMSON_CROSS_SECTION_CGS
            * f("length") ** 2,
            const_stefan_boltzmann=cgs.STEFAN_BOLTZMANN_CGS
            / self.cgs_factor_for_exponents((1, 0, -3, 0, -4)),
            const_electron_volt=cgs.ELECTRON_VOLT_CGS * f("energy"),
            const_electron_mass=cgs.ELECTRON_MASS_CGS * f("mass"),
            const_proton_mass=cgs.PROTON_MASS_CGS * f("mass"),
            const_year=cgs.YEAR_CGS * f("time"),
            const_astronomical_unit=cgs.ASTRONOMICAL_UNIT_CGS * f("length"),
            const_parsec=cgs.PARSEC_CGS * f("length"),
            const_solar_mass=cgs.SOLAR_MASS_CGS * f("mass"),
            const_earth_mass=cgs.EARTH_MASS_CGS * f("mass"),
            const_solar_luminosity=cgs.SOLAR_LUMINOSITY_CGS
            * f("energy_per_unit_time"),
            const_T_CMB_0=cgs.T_CMB_0_CGS / self.UnitTemp_in_cgs,
            const_primordial_He_fraction=cgs.PRIMORDIAL_HE_FRACTION_CGS,
            const_reduced_hubble=cgs.REDUCED_HUBBLE_CGS * f("frequency"),
            const_caseB_recomb=cgs.CASE_B_RECOMBINATION_CGS
            / self.cgs_factor_for_exponents((0, 3, -1, 0, 0)),
        )


# Ready-made cosmological unit system used by the reference examples
# (1e10 M_sun, Mpc, km/s), e.g. examples/SmallCosmoVolume.
COSMO_UNITS = UnitSystem(
    UnitMass_in_cgs=1.98841e43,
    UnitLength_in_cgs=3.08567758e24,
    UnitVelocity_in_cgs=1e5,
)

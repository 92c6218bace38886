"""Physical constants in CGS, converted to internal units on demand.

A copy of the JAX package's ``utils/constants.py`` (numpy-free plain
Python): the constant set of SWIFT's src/physical_constants_cgs.h with the
CODATA 2014 / IAU 2015 values, so that unit conversions agree bit for bit
in double precision.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

# --- CGS values (match reference src/physical_constants_cgs.h) -------------
NEWTON_G_CGS = 6.67430e-8  # cm^3 g^-1 s^-2
SPEED_LIGHT_C_CGS = 2.99792458e10  # cm s^-1
PLANCK_H_CGS = 6.62607015e-27  # erg s
BOLTZMANN_K_CGS = 1.380649e-16  # erg K^-1
AVOGADRO_NUMBER_CGS = 6.02214076e23  # mol^-1
THOMSON_CROSS_SECTION_CGS = 6.6524587321e-25  # cm^2
STEFAN_BOLTZMANN_CGS = 5.670374419e-5  # erg cm^-2 s^-1 K^-4
ELECTRON_CHARGE_CGS = 1.602176634e-19 * 2.99792458e9  # statC
ELECTRON_VOLT_CGS = 1.602176634e-12  # erg
ELECTRON_MASS_CGS = 9.1093837015e-28  # g
PROTON_MASS_CGS = 1.67262192369e-24  # g
YEAR_CGS = 3.15569251e7  # s (Julian-ish year used by the reference)
ASTRONOMICAL_UNIT_CGS = 1.49597870700e13  # cm
PARSEC_CGS = 3.08567758149e18  # cm
LIGHT_YEAR_CGS = 9.46063e17  # cm
SOLAR_MASS_CGS = 1.98841e33  # g
EARTH_MASS_CGS = 5.97217e27  # g
SOLAR_LUMINOSITY_CGS = 3.828e33  # erg s^-1
T_CMB_0_CGS = 2.7255  # K
PRIMORDIAL_HE_FRACTION_CGS = 0.245  # dimensionless
REDUCED_HUBBLE_CGS = 3.2407792894458e-18  # 100 km/s/Mpc in s^-1
CASE_B_RECOMBINATION_CGS = 2.6e-13  # cm^3 s^-1


@dataclass(frozen=True)
class PhysicalConstants:
    """Constants expressed in a given internal unit system.

    Built via :meth:`.units.UnitSystem.constants`.
    Field names mirror the reference's ``struct phys_const``
    (src/physical_constants.h:33-129).
    """

    const_newton_G: float
    const_speed_light_c: float
    const_planck_h: float
    const_boltzmann_k: float
    const_thomson_cross_section: float
    const_stefan_boltzmann: float
    const_electron_volt: float
    const_electron_mass: float
    const_proton_mass: float
    const_year: float
    const_astronomical_unit: float
    const_parsec: float
    const_solar_mass: float
    const_earth_mass: float
    const_solar_luminosity: float
    const_T_CMB_0: float
    const_primordial_He_fraction: float
    const_reduced_hubble: float
    const_caseB_recomb: float

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

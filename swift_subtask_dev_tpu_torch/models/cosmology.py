"""FLRW cosmology — integration tables and KDK operator factors.

A copy of the JAX package's ``models/cosmology.py`` (numpy; the port's
own, neutrino background included), re-deriving SWIFT's src/cosmology.c
(cosmology_init:856):
the integer timeline of a cosmological run lives in **log(a)**
(ti <-> a = a_begin * exp(ti * time_base)), and every drift/kick is an
integral of a power of 1/a over d(log a)/H:

  drift      : int dt / a^2      (comoving position update)
  kick_grav  : int dt / a        (gravity accelerations)
  kick_therm : int dt / a^{3(g-1)-1}... (thermal, a^-2 for gamma=5/3 usage
               below follows cosmology_get_therm_kick_factor)
  kick_corr  : int dt            (mesh/correction terms)

The reference integrates with GSL on the fly; here we precompute dense
f64 tables ONCE on the host (numpy cumulative Simpson) and every factor
lookup is an interpolation — all 64-bit time handling stays host-side,
matching the engine's StepTables design.  ``factors_at`` rounds each
factor to f32 where the reference does (``jnp.float32``) and hands the
engine python floats, which reach the pair kernels as launch arguments.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..utils import timeline as tl
from ..utils.constants import PhysicalConstants
from .sph.sphenix import CosmoFactors

TABLE_SIZE = 30000


@dataclass
class Cosmology:
    """FLRW model + tables (reference struct cosmology, cosmology.h).

    All quantities in internal units; H0 derived from h via the reduced
    Hubble constant in internal units.
    """

    Omega_cdm: float
    Omega_b: float
    Omega_lambda: float
    h: float
    a_begin: float
    a_end: float
    Omega_r: float = 0.0
    Omega_k: float = 0.0
    w_0: float = -1.0
    w_a: float = 0.0
    phys_const: Optional[PhysicalConstants] = None
    hydro_gamma: float = 5.0 / 3.0
    # --- neutrino background (cosmology.c:456-620) -------------------------
    Omega_g: float = 0.0          # photon density parameter
    N_ur: float = 0.0             # ultra-relativistic (massless nu) count
    M_nu_eV: tuple = ()           # massive neutrino masses [eV]
    deg_nu: tuple = ()            # degeneracies (default 1 each)
    T_nu_to_T_gamma: float = 0.71599  # T_nu0/T_CMB0 ((4/11)^(1/3) + QED)
    T_CMB_K: float = 2.7255

    def __post_init__(self):
        # Omega_r already IS the photon + massless-neutrino density: the
        # reference forbids specifying both (cosmology.c:888); accepting
        # both here would silently double-count the radiation
        if self.Omega_r != 0.0 and (self.Omega_g != 0.0 or self.N_ur != 0.0):
            raise ValueError(
                "specify either Cosmology:Omega_r or (Omega_g, N_ur), "
                "not both (cosmology.c:888)")
        self.Omega_m = self.Omega_cdm + self.Omega_b
        # H0 in internal units (phys_const carries 100 km/s/Mpc equivalent)
        if self.phys_const is not None:
            self.H0 = self.h * self.phys_const.const_reduced_hubble
        else:
            self.H0 = self.h * 0.000102271  # 100 km/s/Mpc in (Mpc, km/s) units
        self.log_a_begin = math.log(self.a_begin)
        self.log_a_end = math.log(self.a_end)
        # timeline in log(a): time_base mirrors cosmology.c:871
        self.time_base = (self.log_a_end - self.log_a_begin) \
            / tl.MAX_NR_TIMESTEPS
        self.time_base_inv = 1.0 / self.time_base
        self._init_neutrinos()
        self._build_tables()

    # --- neutrino background --------------------------------------------------
    def _init_neutrinos(self):
        """Fermi-Dirac density table for massive neutrinos + the massless
        Omega_ur term (cosmology_init_neutrino_tables, cosmology.c:535)."""
        dec4 = self.T_nu_to_T_gamma ** 4
        self.Omega_ur = self.N_ur * (7.0 / 8.0) * dec4 * self.Omega_g
        self._nu_pre = 15.0 * (self.T_nu_to_T_gamma / np.pi) ** 4
        self._kT_nu0_eV = 8.617333262e-5 * self.T_CMB_K \
            * self.T_nu_to_T_gamma
        if self.M_nu_eV:
            if not self.deg_nu:
                self.deg_nu = tuple(1.0 for _ in self.M_nu_eV)
            # I(y) = int_0^inf x^2 sqrt(x^2+y^2)/(1+e^x) dx on a log-y grid
            x = np.linspace(1e-6, 60.0, 20000)
            self._nu_ly = np.linspace(-12.0, 16.0, 600)
            ys = np.exp(self._nu_ly)
            integ = (x[None, :] ** 2 * np.hypot(x[None, :], ys[:, None])
                     / (1.0 + np.exp(x[None, :])))
            self._nu_I = np.trapezoid(integ, x, axis=1)
        self.Omega_nu_0 = float(self.Omega_nu(1.0)) \
            if self.M_nu_eV else 0.0

    def Omega_nu(self, a):
        """Massive-neutrino density parameter (relative to rho_crit0,
        carrying its own a-dependence — used as an addition to Omega_r,
        cosmology_get_neutrino_density, cosmology.c:580)."""
        if not self.M_nu_eV:
            return np.zeros_like(np.asarray(a, np.float64))
        a = np.asarray(a, np.float64)
        O = 0.0
        for m, g in zip(self.M_nu_eV, self.deg_nu):
            y = a * m / self._kT_nu0_eV
            I = np.interp(np.log(np.maximum(y, 1e-30)), self._nu_ly,
                          self._nu_I,
                          left=self._nu_I[0], right=np.nan)
            # beyond the table: exact matter-like asymptote I -> 1.803 y
            I = np.where(np.isnan(I), 1.80309 * y, I)
            O = O + g * I * self._nu_pre * self.Omega_g
        return O

    # --- background evolution -------------------------------------------------
    def w_de(self, a):
        """CPL dark energy equation of state w(a) = w0 + wa(1-a)."""
        return self.w_0 + self.w_a * (1.0 - a)

    def _de_density_factor(self, a):
        """exp(3 int_a^1 (1+w)/a da) for CPL (cosmology.c w_tilde)."""
        return a ** (-3.0 * (1.0 + self.w_0 + self.w_a)) \
            * np.exp(-3.0 * self.w_a * (1.0 - a))

    def E(self, a):
        """H(a)/H0 (cosmology.c E(); radiation = photons + massless nu +
        the Fermi-Dirac massive-nu density, drift_integrand:312)."""
        a = np.asarray(a, np.float64)
        Omega_rad = self.Omega_r + self.Omega_g + self.Omega_ur \
            + self.Omega_nu(a)
        return np.sqrt(Omega_rad / a ** 4 + self.Omega_m / a ** 3
                       + self.Omega_k / a ** 2
                       + self.Omega_lambda * self._de_density_factor(a))

    def H(self, a):
        return self.H0 * self.E(a)

    # --- tables ---------------------------------------------------------------
    def _build_tables(self):
        # dense grid in log(a) spanning a slightly beyond [a_begin, a_end]
        la = np.linspace(self.log_a_begin, self.log_a_end, TABLE_SIZE)
        a = np.exp(la)
        H = self.H(a)
        dla = la[1] - la[0]
        # dt = d(log a) / H ; integrals by cumulative trapezoid
        def cumint(integrand):
            inc = 0.5 * (integrand[1:] + integrand[:-1]) * dla
            return np.concatenate([[0.0], np.cumsum(inc)])

        self._la = la
        self._t = cumint(1.0 / H)                    # cosmic time since a_begin
        self._drift = cumint(1.0 / (H * a * a))      # int dt/a^2
        self._grav_kick = cumint(1.0 / (H * a))      # int dt/a
        g3 = 3.0 * (self.hydro_gamma - 1.0) - 1.0    # therm: dt/a^{3(g-1)-1}...
        self._therm_kick = cumint(a ** (-g3) / H)
        self._corr_kick = cumint(1.0 / H)            # int dt (mesh/corr)

    def _interp(self, table, log_a):
        return np.interp(log_a, self._la, table)

    # --- ti <-> a mapping -------------------------------------------------------
    def a_of_ti(self, ti: int) -> float:
        return math.exp(self.log_a_begin + ti * self.time_base)

    def log_a_of_ti(self, ti: int) -> float:
        return self.log_a_begin + ti * self.time_base

    def time_of_ti(self, ti: int) -> float:
        """Cosmic time since a_begin (for outputs)."""
        return float(self._interp(self._t, self.log_a_of_ti(ti)))

    # --- operator factors (cosmology.c:1217-1345) -------------------------------
    def _factor(self, table, ti_start: int, ti_end: int) -> float:
        la0 = self.log_a_of_ti(ti_start)
        la1 = self.log_a_of_ti(ti_end)
        return float(self._interp(table, la1) - self._interp(table, la0))

    def drift_factor(self, ti_start, ti_end):
        return self._factor(self._drift, ti_start, ti_end)

    def grav_kick_factor(self, ti_start, ti_end):
        return self._factor(self._grav_kick, ti_start, ti_end)

    def therm_kick_factor(self, ti_start, ti_end):
        return self._factor(self._therm_kick, ti_start, ti_end)

    def corr_kick_factor(self, ti_start, ti_end):
        return self._factor(self._corr_kick, ti_start, ti_end)

    def delta_time(self, ti_start, ti_end):
        return self._factor(self._t, ti_start, ti_end)

    # --- per-step factors for the SPH equations ---------------------------------
    def factors_at(self, ti: int) -> CosmoFactors:
        """CosmoFactors snapshot at ti (a_factor_* from cosmology.c:400-460),
        each rounded to f32 as the reference's ``jnp.float32``."""
        a = self.a_of_ti(ti)
        H = float(self.H(a))
        g = self.hydro_gamma

        def f32(x):
            return float(np.float32(x))

        return CosmoFactors(
            a=f32(a), H=f32(H), a_inv2=f32(1.0 / a ** 2),
            fac_mu=f32(a ** (0.5 * (3.0 * g - 5.0))),
            a_factor_sound_speed=f32(a ** (-0.5 * (3.0 * g - 1.0)) * a),
            a_factor_Balsara_eps=f32(a ** (0.5 * (1.0 - 3.0 * g)) * a ** 1.5),
            a_factor_internal_energy=f32(a ** (-3.0 * (g - 1.0))),
        )


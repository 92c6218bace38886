"""EAGLE stellar enrichment: AGB + SNII mass return, SNIa rates, metals.

Port of ``EagleEnrichment`` of the reference's ``subgrid/enrichment.py``
(SWIFT's src/feedback/EAGLE/: enrichment.h evolve_SNIa :267, evolve_SNII
:340, evolve_AGB :512; imf.h; yield_tables.h), with the reference's
synthesized yield forms: a Chabrier (2003) IMF on [0.1, 100] Msun
normalised to one solar mass, lifetimes t(m) = 10 Gyr m^-2.5 (with a mild
metallicity factor) inverted for the dying-mass window of each step,
white-dwarf / neutron-star remnants, metallicity-binned SNII and AGB
metal yields and an exponential SNIa delay-time distribution with a
W7-like composition.  The cumulative IMF integrals are built on the host
(numpy, float64) and interpolated on the device in f32, as the
reference's ``jnp.interp``.  ``load_yield_tables`` (the real yield files)
is not ported (ROADMAP.md, queue 1 item 10).  Ejecta are shared over the
star's gas neighbours by ``ops.stencil.enrichment_apply_loop``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .chemistry import N_ELEMENTS

# element order: H, He, C, N, O, Ne, Mg, Si, Fe (chemistry.py)
_SNII_METALS = np.array([0.0, 0.0, 0.01, 0.005, 0.5,
                         0.15, 0.1, 0.15, 0.085])   # fractions of Z yield
# AGB composition shifts with initial Z (Marigo 2001: primary C at low Z,
# secondary N at high Z), lerped in log Z between these ends
_AGB_METALS_LO_Z = np.array([0.0, 0.0, 0.85, 0.10, 0.05,
                             0.0, 0.0, 0.0, 0.0])
_AGB_METALS_HI_Z = np.array([0.0, 0.0, 0.40, 0.55, 0.05,
                             0.0, 0.0, 0.0, 0.0])
# one SNIa event ejects 1.4 Msun of metals
_SNIA_EJECTA = np.array([0.0, 0.0, 0.002, 1e-5, 0.14,
                         0.005, 0.01, 0.15, 0.74]) * 1.4 / 1.047
# metallicity bins of the yield tables (yield_tables.h; enrichment.h
# determine_bin_yield interpolates between them in log Z)
_Z_BINS = np.array([0.0004, 0.004, 0.008, 0.019, 0.05])
assert len(_SNII_METALS) == N_ELEMENTS


def _snii_yield_frac(Z):
    return 0.10 * (1.0 - 6.0 * Z)


def _agb_yield_frac(Z):
    return 0.005 + 0.35 * Z


def chabrier_imf(m):
    """Number IMF xi(m) (imf.h:142), unnormalised."""
    m = np.asarray(m, np.float64)
    lognormal = (0.852464 / m) * np.exp(
        -(np.log10(m) - np.log10(0.079)) ** 2 / (2 * 0.69 ** 2))
    power = 0.237912 * m ** -2.3
    return np.where(m > 1.0, power, lognormal)


def _remnant_mass(m):
    """White dwarf below 8 Msun, 1.4 Msun compact remnant above."""
    return np.where(m < 8.0, 0.44 + 0.08 * m, 1.4)


def _trapezoid(y, x):
    """numpy.trapezoid(y, x), written out (numpy < 2 lacks the name)."""
    return (np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum()


def interp(x: torch.Tensor, xp: torch.Tensor,
           fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation with constant ends (jnp.interp's form)."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclass(frozen=True)
class EagleEnrichment:
    """Pre-integrated IMF/yield tables and the SNIa DTD parameters.

    Masses in Msun internally; ``Msun`` and ``Gyr`` convert to internal
    units at the call boundary.
    """

    Msun: float = 1.0           # internal units per solar mass
    Gyr: float = 1.0            # internal units per Gyr
    SNIa_nu: float = 2e-3       # events per Msun formed
    SNIa_tau_Gyr: float = 2.0
    SNIa_delay_Gyr: float = 0.04
    SNII_min: float = 8.0
    SNII_max: float = 100.0
    # cumulative tables on the log-mass grid (set in __post_init__)
    log_m_grid: np.ndarray = field(default=None, repr=False, compare=False)
    cum_ej: np.ndarray = field(default=None, repr=False, compare=False)
    cum_Z_snii: np.ndarray = field(default=None, repr=False, compare=False)
    cum_Z_agb: np.ndarray = field(default=None, repr=False, compare=False)
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        lg = np.linspace(np.log10(0.1), np.log10(100.0), 512)
        m = 10.0 ** lg
        xi = chabrier_imf(m)
        # normalise: the integral of m xi dm is 1 (one Msun formed)
        xi = xi / _trapezoid(m * xi * m * np.log(10.0), lg)
        dndlg = xi * m * np.log(10.0)           # per dlog10 m

        def cum(w):
            return np.concatenate([[0.0], np.cumsum(
                0.5 * (w[1:] + w[:-1]) * np.diff(lg))])

        ej = np.maximum(m - _remnant_mass(m), 0.0)
        agb_w = (m > 0.8) & (m < self.SNII_min)
        snii_w = (m >= self.SNII_min) & (m <= self.SNII_max)
        object.__setattr__(self, "log_m_grid", lg)
        object.__setattr__(self, "cum_ej", cum(ej * dndlg * (agb_w | snii_w)))
        # metal yields per Z bin, lerped in log Z when evaluated
        object.__setattr__(self, "cum_Z_snii", np.stack([
            cum(_snii_yield_frac(Zb) * m * dndlg * snii_w)
            for Zb in _Z_BINS]))
        object.__setattr__(self, "cum_Z_agb", np.stack([
            cum(_agb_yield_frac(Zb) * m * dndlg * agb_w) for Zb in _Z_BINS]))

    @staticmethod
    def from_params(params, units) -> "EagleEnrichment":
        sec = "EAGLEFeedback"
        Msun = 1.98841e33 * units.from_cgs("mass")
        Gyr = 3.15569252e16 * units.from_cgs("time")
        return EagleEnrichment(
            Msun=Msun, Gyr=Gyr,
            SNIa_nu=params.opt_float(sec, "SNIa_DTD_exp_norm_p_Msun", 2e-3),
            SNIa_tau_Gyr=params.opt_float(
                sec, "SNIa_DTD_exp_timescale_Gyr", 2.0),
            SNIa_delay_Gyr=params.opt_float(sec, "SNIa_DTD_delay_Gyr", 0.04),
            SNII_min=params.opt_float(sec, "SNII_min_mass_Msun", 8.0),
            SNII_max=params.opt_float(sec, "SNII_max_mass_Msun", 100.0))

    # --- device pieces ------------------------------------------------------
    def _tables(self, device):
        key = str(device)
        if key not in self._dev:
            def on(a):
                return torch.as_tensor(np.asarray(a, np.float32),
                                       device=device)
            self._dev[key] = {
                "lg": on(self.log_m_grid), "cum_ej": on(self.cum_ej),
                "cum_Z_snii": on(self.cum_Z_snii),
                "cum_Z_agb": on(self.cum_Z_agb),
                "zgrid": torch.log(on(np.maximum(_Z_BINS, 1e-10))),
                "snii_v": on(_SNII_METALS), "agb_lo": on(_AGB_METALS_LO_Z),
                "agb_hi": on(_AGB_METALS_HI_Z),
                "onea_v": on(_SNIA_EJECTA / max(_SNIA_EJECTA.sum(), 1e-30))}
        return self._dev[key]

    def dying_mass(self, age_Gyr, Z):
        """m(t): the inverse of the stellar lifetime at the star's Z,
        t(m) = 10 m^-2.5 f_L(Z) Gyr, f_L ~20% longer at high Z."""
        t = torch.clamp_min(age_Gyr, 1e-6)
        f_L = torch.clamp(1.0 + 0.04 * torch.log(
            torch.clamp_min(Z, 1e-8) / 0.019), 0.75, 1.10)
        t = t / f_L
        return torch.clamp((t / 10.0) ** (-1.0 / 2.5), 0.1, 100.0)

    def window(self, table, m_lo, m_hi):
        tb = self._tables(m_lo.device)
        return torch.clamp_min(interp(torch.log10(m_hi), tb["lg"], table)
                               - interp(torch.log10(m_lo), tb["lg"], table),
                               0.0)

    def _z_weights(self, Z):
        """Bracketing Z-bin index and log-Z fraction (determine_bin_yield,
        feedback/EAGLE/enrichment.h)."""
        zgrid = self._tables(Z.device)["zgrid"]
        lz = torch.log(torch.clamp(Z, float(_Z_BINS[0]), float(_Z_BINS[-1])))
        zi = torch.clamp(torch.searchsorted(zgrid, lz.contiguous()) - 1, 0,
                         len(_Z_BINS) - 2)
        zf = (lz - zgrid[zi]) / (zgrid[zi + 1] - zgrid[zi])
        return zi, torch.clamp(zf, 0.0, 1.0)

    def window_z(self, tables, m_lo, m_hi, Z):
        """A yield window at the star's metallicity: the mass window in
        every Z bin, lerped between the two bracketing bins in log Z."""
        v = torch.stack([self.window(tables[k], m_lo, m_hi)
                         for k in range(tables.shape[0])])
        zi, zf = self._z_weights(Z)
        lo = torch.gather(v, 0, zi[None])[0]
        hi = torch.gather(v, 0, (zi + 1)[None])[0]
        return lo * (1.0 - zf) + hi * zf

    def num_SNIa(self, t1_Gyr, t2_Gyr):
        """SNIa per Msun formed in the age interval (enrichment.h:165)."""
        tau_inv = 1.0 / self.SNIa_tau_Gyr
        t1 = torch.clamp_min(t1_Gyr - self.SNIa_delay_Gyr, 0.0)
        t2 = torch.clamp_min(t2_Gyr - self.SNIa_delay_Gyr, 0.0)
        return self.SNIa_nu * (torch.exp(-t1 * tau_inv)
                               - torch.exp(-t2 * tau_inv))

    def ejecta(self, m_init, Z_star, elem_frac_star, t1, t2):
        """Per-star ejecta over the ages [t1, t2] (internal time units):
        (dm, dmZ, delem (..., 9)) in internal mass units, the per-step
        output of compute_stellar_evolution (feedback.c:847)."""
        tb = self._tables(m_init.device)
        t1_G = t1 / self.Gyr
        t2_G = t2 / self.Gyr
        m_hi = self.dying_mass(t1_G, Z_star)
        m_lo = self.dying_mass(t2_G, Z_star)
        M_msun = m_init / self.Msun
        ej = self.window(tb["cum_ej"], m_lo, m_hi)      # per Msun formed
        Z_snii = self.window_z(tb["cum_Z_snii"], m_lo, m_hi, Z_star)
        Z_agb = self.window_z(tb["cum_Z_agb"], m_lo, m_hi, Z_star)
        n_1a = self.num_SNIa(t1_G, t2_G)
        snia_sum = float(np.float32(_SNIA_EJECTA.sum()))
        dm_msun = ej * M_msun + n_1a * M_msun * snia_sum
        mz_snii = Z_snii * M_msun
        mz_agb = Z_agb * M_msun
        mz_1a = n_1a * M_msun * snia_sum
        # AGB composition lerps C -> N with log Z (Marigo secondary N)
        lz0, lz1 = float(np.log(_Z_BINS[0])), float(np.log(_Z_BINS[-1]))
        zfrac = torch.clamp(
            (torch.log(torch.clamp(Z_star, float(_Z_BINS[0]),
                                   float(_Z_BINS[-1]))) - lz0)
            / (lz1 - lz0), 0.0, 1.0)[..., None]
        agb_v = (1.0 - zfrac) * tb["agb_lo"] + zfrac * tb["agb_hi"]
        new_metals = (mz_snii[..., None] * tb["snii_v"]
                      + mz_agb[..., None] * agb_v
                      + mz_1a[..., None] * tb["onea_v"])
        # the ejecta not newly synthesised carry the star's own composition
        dm_old = torch.clamp_min(dm_msun - mz_snii - mz_agb - mz_1a, 0.0)
        delem = new_metals + dm_old[..., None] * elem_frac_star
        dmZ = mz_snii + mz_agb + mz_1a + dm_old * Z_star
        return (dm_msun * self.Msun, dmZ * self.Msun, delem * self.Msun)

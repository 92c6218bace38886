"""EAGLE-style table-interpolation cooling, in torch.

Port of the reference's ``subgrid/eagle_cooling.py`` (SWIFT's
src/cooling/EAGLE/: cooling.c:1148 cooling_cool_part, interpolate.h,
cooling_tables.c): net radiative cooling/heating rates Lambda_net(z, n_H,
T) at solar abundance ratios interpolated trilinearly from tables, a
metallicity-scaled metal term, Compton cooling off the CMB, and an
implicit (log-bisection) solve for the end-of-step internal energy, whose
result is written back as the particle's u_dt.

The tables are the reference's: synthesized on the host (numpy, float64)
from analytic rates (Katz, Weinberg & Hernquist 1996 primordial CIE
rates, bremsstrahlung, a metal-line bump, a UV-background heating
history), then used in f32 on the device.  ``EagleCooling.from_wiersma``
(real Wiersma+2009 HDF5 tables) is not ported: the machine with the card
has no ``h5py`` (ROADMAP.md, queue 1 item 10).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

# table axes (cooling_tables.c uses log-spaced T and n_H exactly like this)
LOG_T_MIN, LOG_T_MAX, N_T = 2.0, 9.0, 128
LOG_NH_MIN, LOG_NH_MAX, N_NH = -9.0, 3.0, 25
Z_MIN, Z_MAX, N_Z = 0.0, 9.0, 10

K_B = 1.380649e-16          # erg/K
M_P = 1.67262192e-24        # g
T_CMB0 = 2.7255
Z_SUN = 0.0134

F32 = np.float32


def _f32(x: float) -> float:
    return float(np.float32(x))


def _primordial_lambda(T):
    """Primordial (H+He) CIE cooling Lambda/n_H^2 [erg cm^3/s] (Katz,
    Weinberg & Hernquist 1996 table 1 fits, collisional equilibrium)."""
    T = np.asarray(T, np.float64)
    T3 = T / 1e3
    T5 = T / 1e5
    T6 = T / 1e6
    x_ion = 1.0 / (1.0 + np.exp(-(np.log10(T) - 4.1) / 0.08))
    ce_H = 7.5e-19 * np.exp(-118348.0 / T) / (1.0 + np.sqrt(T5))
    ci_H = 1.27e-21 * np.sqrt(T) * np.exp(-157809.1 / T) \
        / (1.0 + np.sqrt(T5))
    re_H = 8.7e-27 * np.sqrt(T) * T3 ** (-0.2) / (1.0 + T6 ** 0.7)
    y = 0.0789
    ce_He = 5.54e-17 * T ** (-0.397) * np.exp(-473638.0 / T) \
        / (1.0 + np.sqrt(T5)) * y
    gff = 1.1 + 0.34 * np.exp(-((5.5 - np.log10(T)) ** 2) / 3.0)
    ff = 1.42e-27 * gff * np.sqrt(T) * (1.0 + y)
    return (ce_H + ci_H + re_H + ce_He) * x_ion ** 2 + ff * x_ion ** 2


def _metal_lambda(T):
    """Metal-line cooling Lambda_Z/n_H^2 [erg cm^3/s] at solar metallicity
    (a bump near 1e5.5 K, the shape of the Wiersma+09 metal term)."""
    logT = np.log10(np.asarray(T, np.float64))
    bump = 1.0e-21 * np.exp(-((logT - 5.4) ** 2) / (2 * 0.55 ** 2))
    hot = 2.0e-23 * np.exp(-((logT - 7.2) ** 2) / (2 * 0.8 ** 2))
    on = 1.0 / (1.0 + np.exp(-(logT - 4.0) / 0.05))
    return (bump + hot) * on


def _uvb_heating(z):
    """Photoheating rate per H atom [erg/s] (a smooth history peaking near
    z ~ 2; stands in for the tabulated UV background)."""
    return 5.0e-26 * np.exp(-((z - 2.0) ** 2) / 8.0) + 5.0e-27


@dataclass(frozen=True)
class EagleCooling:
    """Synthesized-table EAGLE cooling model (internal-unit interface).

    ``table``: (N_Z, N_NH, N_T) net Lambda/n_H^2 [erg cm^3/s] at solar
    metallicity, ``metal_table`` (N_T,), both float64 host arrays,
    interpolated in (z, log n_H, log T) as interpolate.h does.
    """

    table: np.ndarray = field(repr=False, compare=False, default=None)
    metal_table: np.ndarray = field(repr=False, compare=False, default=None)
    nH_from_rho: float = 1.0      # internal rho -> n_H [cm^-3]
    T_from_u: float = 1.0         # internal u -> K (at mu=1)
    dudt_from_cgs: float = 1.0    # erg/s/g -> internal du/dt
    hydrogen_mass_fraction: float = 0.752
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    @staticmethod
    def from_params(params, units, phys_const,
                    hydrogen_mass_fraction: float = 0.752
                    ) -> "EagleCooling":
        """The EAGLECooling section (cooling_init, EAGLE/cooling.c)."""
        X_H = params.opt_float("EAGLECooling", "H_mass_fraction",
                               hydrogen_mass_fraction)
        T = np.logspace(LOG_T_MIN, LOG_T_MAX, N_T)
        zs = np.linspace(Z_MIN, Z_MAX, N_Z)
        nH = np.logspace(LOG_NH_MIN, LOG_NH_MAX, N_NH)
        lam_p = _primordial_lambda(T)
        table = np.empty((N_Z, N_NH, N_T))
        for iz, z in enumerate(zs):
            heat = _uvb_heating(z)
            for inH, n in enumerate(nH):
                # net = heating/n_H - cooling (per n_H^2); the UVB heats
                # only low-density (self-shielding above n_H ~ 1e-2),
                # cool (ionized above ~1e5 K) gas
                shield = 1.0 / (1.0 + (n / 1e-2) ** 2)
                hot_off = np.exp(-(T / 3e5))
                table[iz, inH] = heat * shield * hot_off / n - lam_p
        rho_to_cgs = 1.0 / units.from_cgs("density")
        u_to_cgs = (1.0 / units.from_cgs("velocity")) ** 2
        t_int = 1.0 / units.from_cgs("time")  # internal time in seconds
        return EagleCooling(
            table=table, metal_table=_metal_lambda(T),
            nH_from_rho=float(X_H / M_P * rho_to_cgs),
            T_from_u=float(u_to_cgs * M_P / K_B),
            dudt_from_cgs=float(t_int / u_to_cgs),
            hydrogen_mass_fraction=float(X_H))

    # --- device-side interpolation -----------------------------------------
    def _tables_dev(self, device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (
                torch.as_tensor(self.table.astype(F32), device=device),
                torch.as_tensor(self.metal_table.astype(F32), device=device))
        return self._dev[key]

    def net_rate_cgs(self, logT, lognH, z: float, Z_metal, T, n_H):
        """Lambda_net/n_H^2 [erg cm^3/s]: trilinear table interpolation,
        metallicity scaling and Compton cooling (interpolate.h analog).
        ``z`` is the redshift as an f32 value."""
        tab, mtab = self._tables_dev(logT.device)
        ti = (logT - LOG_T_MIN) / (LOG_T_MAX - LOG_T_MIN) * (N_T - 1)
        ni = (lognH - LOG_NH_MIN) / (LOG_NH_MAX - LOG_NH_MIN) * (N_NH - 1)
        zi = np.clip(F32(F32(F32(z) - F32(Z_MIN)) / F32(Z_MAX - Z_MIN))
                     * F32(N_Z - 1), F32(0.0), F32(N_Z - 1.001))
        z0 = int(np.floor(zi))
        fz = float(F32(zi - F32(z0)))
        ti = torch.clamp(ti, 0.0, N_T - 1.001)
        ni = torch.clamp(ni, 0.0, N_NH - 1.001)
        t0 = torch.floor(ti).to(torch.int64)
        n0 = torch.floor(ni).to(torch.int64)
        ft, fn = ti - t0, ni - n0

        lam = None
        for dz, wz in ((0, float(F32(1.0) - F32(fz))), (1, fz)):
            for dn, wn in ((0, 1 - fn), (1, fn)):
                for dt, wt in ((0, 1 - ft), (1, ft)):
                    term = wz * wn * wt * tab[z0 + dz][n0 + dn, t0 + dt]
                    lam = term if lam is None else lam + term
        lam_Z = (1 - ft) * mtab[t0] + ft * mtab[t0 + 1]
        lam = lam - lam_Z * (Z_metal / Z_SUN)
        # Compton off the CMB: Lambda_C = pref n_e (T - T_CMB) T_CMB^4 /
        # n_H^2, with n_e/n_H^2 = 1.16 x_e / n_H (one n_H cancelled:
        # n_H^2 underflows f32 below 1e-19)
        T_cmb = F32(T_CMB0) * F32(F32(1.0) + F32(z))
        T_cmb2 = F32(T_cmb * T_cmb)
        ne_nH2 = 1.16 * torch.sigmoid((logT - 4.1) / 0.08) \
            / torch.clamp_min(n_H, 1e-30)
        lam = lam - float(F32(5.65e-36) * F32(T_cmb2 * T_cmb2)) \
            * (T - float(T_cmb)) * ne_nH2
        return lam

    def du_dt_internal(self, rho_phys, u_phys, z: float, Z_metal):
        """Net du/dt in internal units (physical frame) at the given
        physical density and energy (the implicit solver's rate)."""
        n_H = rho_phys * _f32(self.nH_from_rho)
        # mean molecular weight: neutral 1.22 below 1e4 K, ionised 0.59
        T_mu1 = u_phys * (2.0 / 3.0) * _f32(self.T_from_u)
        mu = 0.59 + (1.22 - 0.59) * torch.sigmoid(
            (4.0 - torch.log10(torch.clamp_min(T_mu1 * 0.59, 1.0))) / 0.1)
        T = T_mu1 * mu
        logT = torch.log10(torch.clamp_min(T, 10.0 ** LOG_T_MIN))
        lognH = torch.log10(torch.clamp_min(n_H, 10.0 ** LOG_NH_MIN))
        lam = self.net_rate_cgs(logT, lognH, z, Z_metal, T, n_H)
        # du/dt [erg/s/g] = Lambda n_H^2 / rho; rho in cgs from n_H
        rho_cgs = n_H * _f32(M_P / self.hydrogen_mass_fraction)
        dudt_cgs = lam * n_H * n_H / torch.clamp_min(rho_cgs, 1e-40)
        return dudt_cgs * _f32(self.dudt_from_cgs)


def make_eagle_cooling_fn(model: EagleCooling, floor=None,
                          u_minimal: float = 0.0,
                          hydro_gamma: float = 5.0 / 3.0,
                          n_iter: int = 40):
    """The engine's cooling hook with the EAGLE implicit solve
    (cooling_cool_part, EAGLE/cooling.c:1148): log-bisection on f(u) = u -
    u_0 - du/dt_cool(u) dt, u_0 including the hydro du/dt, an explicit
    step where the change is small, the entropy floor and the minimal
    energy; the particle's u_dt becomes (u_final - u_start)/dt.  The
    step's cosmology factors enter as f32 values, as on the reference's
    device."""

    def cooling_fn(s, cosmo, dt_therm):
        a = F32(cosmo.a)
        a_u = F32(cosmo.a_factor_internal_energy)
        a_inv2 = F32(cosmo.a_inv2)
        z = F32(F32(1.0) / a - F32(1.0))
        u_com0 = s["u_full"]
        rho_com = torch.clamp_min(s["rho"], 1e-30)
        rho_phys = rho_com * float(a_inv2) / float(a)
        Z_metal = s["Z"] if "Z" in s else torch.zeros_like(u_com0)
        dt = torch.clamp_min(dt_therm, 1e-30)
        # hydro du/dt folded into u_0 (EAGLE/cooling.c:1202); the solve runs
        # in the comoving frame with the physical -> comoving rate factor
        u0_com = torch.clamp_min(u_com0 + s["u_dt"] * dt, 1e-30)

        def rate_com(u_com):
            phys = model.du_dt_internal(rho_phys, u_com * float(a_u), z,
                                        Z_metal)
            return phys * float(a) * float(a) / float(a_u)

        # explicit if the change is small (cooling.c:1260)
        lam0 = rate_com(u0_com)
        u_expl = u0_com + lam0 * dt
        lo = u0_com / float(2.0 ** 20)
        hi = u0_com * float(2.0 ** 20)
        for _ in range(n_iter):
            mid = torch.sqrt(lo * hi)
            f = mid - u0_com - rate_com(mid) * dt
            up = f > 0
            lo = torch.where(up, lo, mid)
            hi = torch.where(up, mid, hi)
        u_impl = torch.sqrt(lo * hi)
        explicit_ok = torch.abs(lam0 * dt) < 0.05 * u0_com
        u_final_com = torch.where(explicit_ok, u_expl, u_impl)

        # floors: the entropy floor and the absolute minimum (physical ->
        # comoving)
        if floor is not None:
            u_fl = floor.u_floor(rho_phys, rho_com, hydro_gamma)
        else:
            u_fl = torch.zeros_like(u_final_com)
        u_final_com = torch.maximum(
            u_final_com,
            torch.clamp_min(u_fl, _f32(u_minimal)) / float(a_u))
        total = (u_final_com - u_com0) / dt
        zero_dt = dt_therm <= 0.0
        return {"u_dt": torch.where(zero_dt, s["u_dt"], total)}

    return cooling_fn

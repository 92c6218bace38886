"""Initial conditions (numpy, seeded).

Copies of ``bcc_lattice``, ``cubic_lattice``, ``uniform_box_ic``,
``sod_shock_ic`` and ``sedov_ic`` from the reference's ``ics.py``: the
same lattices, the same ``default_rng(seed)`` jitter, the same shock tube
and the same blast injection, so both packages start from identical
particles; and ``zeldovich`` with the gas and DM lattices of
``examples/small_cosmo_volume/make_ics.py``, returned as arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def bcc_lattice(n: Tuple[int, int, int], box: Tuple[float, float, float],
                origin=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Body-centred cubic lattice: 2*nx*ny*nz sites in the given box."""
    nx, ny, nz = n
    dx = np.asarray(box, np.float64) / np.asarray(n, np.float64)
    g = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij"), -1).reshape(-1, 3).astype(np.float64)
    a = (g + 0.25) * dx
    b = (g + 0.75) * dx
    return np.concatenate([a, b]) + np.asarray(origin, np.float64)


def uniform_box_ic(n: int = 16, rho: float = 1.0, u0: float = 1.0,
                   L: float = 1.0, eta: float = 1.2348, jitter: float = 0.0,
                   seed: int = 0):
    box = (L, L, L)
    pos = bcc_lattice((n, n, n), box)
    if jitter:
        rng = np.random.default_rng(seed)
        pos = np.mod(pos + rng.normal(0, jitter * L / n, pos.shape), L)
    N = len(pos)
    m = np.full(N, rho * L ** 3 / N, np.float32)
    h = np.full(N, eta * (L ** 3 / N) ** (1 / 3), np.float32)
    u = np.full(N, u0, np.float32)
    v = np.zeros((N, 3), np.float32)
    return {"pos": pos, "m": m, "u": u, "h": h, "v": v, "box": box,
            "gamma": 5 / 3}


def cubic_lattice(n: Tuple[int, int, int], box: Tuple[float, float, float],
                  origin=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Simple cubic lattice: nx*ny*nz cell-centred sites in the box."""
    nx, ny, nz = n
    dx = np.asarray(box, np.float64) / np.asarray(n, np.float64)
    g = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij"), -1).reshape(-1, 3)
    return (g.astype(np.float64) + 0.5) * dx + np.asarray(origin,
                                                          np.float64)


def sod_shock_ic(n_l: int = 32, y_aspect: float = 0.5, gamma: float = 5 / 3,
                 eta: float = 1.2348, lattice: str = "bcc"):
    """SodShock_3D ICs (examples/HydroTests/SodShock_3D/makeIC.py behavior).

    Box [0,2]x[0,Y]x[0,Y]; left half rho=1, P=1; right half rho=0.125,
    P=0.1; equal-mass particles (left lattice spacing a, right 2a).
    n_l = number of left-lattice spacings per unit length.
    """
    a = 1.0 / n_l
    Y = y_aspect
    ny = max(2, int(round(Y / a)))
    Y = ny * a  # snap so lattices tile the box exactly
    box = (2.0, Y, Y)
    lat = bcc_lattice if lattice == "bcc" else cubic_lattice

    pos_l = lat((n_l, ny, ny), (1.0, Y, Y))
    pos_r = lat((n_l // 2, ny // 2, ny // 2), (1.0, Y, Y),
                origin=(1.0, 0.0, 0.0))
    pos = np.concatenate([pos_l, pos_r])
    n_left = len(pos_l)

    rho_l, P_l = 1.0, 1.0
    rho_r, P_r = 0.125, 0.1
    vol_half = 1.0 * Y * Y
    m = np.full(len(pos), rho_l * vol_half / n_left, np.float64)
    u = np.empty(len(pos))
    u[:n_left] = P_l / ((gamma - 1) * rho_l)
    u[n_left:] = P_r / ((gamma - 1) * rho_r)
    # per-particle spacing for initial h
    spacing = np.empty(len(pos))
    ppc_l = 2 if lattice == "bcc" else 1  # particles per lattice cell
    spacing[:n_left] = a / ppc_l ** (1 / 3)
    spacing[n_left:] = 2 * a / ppc_l ** (1 / 3)
    h = eta * spacing
    v = np.zeros((len(pos), 3))
    return {
        "pos": pos, "m": m.astype(np.float32), "u": u.astype(np.float32),
        "h": h.astype(np.float32), "v": v.astype(np.float32), "box": box,
        "gamma": gamma,
    }


def sedov_ic(n: int = 32, E0: float = 1.0, n_inject: int = 15,
             gamma: float = 5 / 3, eta: float = 1.2348,
             u_bg: float = 1e-6):
    """SedovBlast_3D ICs: uniform box rho=1, energy E0 injected into the
    n_inject particles closest to the centre (makeIC.py behavior)."""
    box = (1.0, 1.0, 1.0)
    pos = bcc_lattice((n, n, n), box)
    N = len(pos)
    m = np.full(N, 1.0 / N, np.float32)
    spacing = (1.0 / N) ** (1 / 3)
    h = np.full(N, eta * spacing, np.float32)
    u = np.full(N, u_bg, np.float64)
    r2 = np.sum((pos - 0.5) ** 2, axis=1)
    idx = np.argsort(r2)[:n_inject]
    u[idx] += E0 / (n_inject * m[0])
    v = np.zeros((N, 3), np.float32)
    return {"pos": pos, "m": m, "u": u.astype(np.float32), "h": h,
            "v": v, "box": box, "gamma": gamma}


# ---------------------------------------------------------------------------
# SmallCosmoVolume (examples/small_cosmo_volume/make_ics.py, as arrays)
# ---------------------------------------------------------------------------

def zeldovich(n, L, amp, slope, seed, a_start, Omega_m, H0):
    """Displacement + velocity fields on an n^3 lattice: a Gaussian
    random field with a power-law spectrum P(k) ~ amp k^slope (cut off
    near the Nyquist wavenumber), Zel'dovich displacements psi = i k/k^2
    delta_k, and growing-mode velocities v = a H(a) f psi with f ~
    Omega_m(a)^0.55.  Returns (psi (n^3, 3), vel (n^3, 3)), float64."""
    rng = np.random.default_rng(seed)
    k1 = np.fft.fftfreq(n, d=L / n) * 2 * np.pi
    kx, ky, kz = np.meshgrid(k1, k1, k1, indexing="ij")
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    k2[0, 0, 0] = 1.0
    phase = rng.standard_normal((n, n, n)) + 1j * rng.standard_normal(
        (n, n, n))
    k_ny = np.pi * n / L
    pk = amp * np.maximum(k2, 1e-30) ** (slope / 2.0) \
        * np.exp(-k2 / (0.5 * k_ny) ** 2)
    pk[0, 0, 0] = 0.0
    delta_k = phase * np.sqrt(pk)
    psi = []
    for kk in (kx, ky, kz):
        f = 1j * kk / k2 * delta_k
        psi.append(np.real(np.fft.ifftn(f)))
    psi = np.stack(psi, axis=-1).reshape(-1, 3)
    Ha = H0 * np.sqrt(Omega_m / a_start ** 3 + (1.0 - Omega_m))
    f_growth = (Omega_m / a_start ** 3
                / (Omega_m / a_start ** 3 + 1.0 - Omega_m)) ** 0.55
    vel = a_start * Ha * f_growth * psi
    return psi, vel


def small_cosmo_volume_ic(n: int = 16, L: float = 25.0, z: float = 9.0,
                          amp: float = 40.0, seed: int = 1,
                          h: float = 0.67, Omega_m: float = 0.309,
                          Omega_b: float = 0.049):
    """SmallCosmoVolume-style gas + DM initial conditions (make_ics.py's
    arrays, without its HDF5 writer): n^3 DM on a cell-centred lattice
    and n^3 gas offset by half a spacing, both displaced by one
    Zel'dovich field (slope -1), growing-mode velocities, u = 150 and
    h = 1.3 spacings for the gas; units Mpc, km/s, 1e10 Msun.  Returns a
    dict of per-species arrays and the box, a_start and rms |psi|."""
    a0 = 1.0 / (1.0 + z)
    H0 = 100.0 * h              # km/s/Mpc = internal velocity/length
    G = 43.022                  # Mpc (km/s)^2 / 1e10 Msun
    rho_crit0 = 3.0 * H0 ** 2 / (8.0 * np.pi * G)
    m_tot = Omega_m * rho_crit0 * L ** 3
    lat = (np.indices((n, n, n)).reshape(3, -1).T + 0.5) / n * L
    psi, vel = zeldovich(n, L, amp, -1.0, seed, a0, Omega_m, H0)
    N = n ** 3
    d_mean = L / n
    return {
        "box": (L, L, L), "a_start": a0,
        "psi_rms": float(np.sqrt(np.mean(np.sum(psi * psi, axis=1)))),
        "gas": {"pos": np.mod(lat + 0.5 * L / n + psi, L),
                "v": vel.astype(np.float32),
                "m": np.full(N, Omega_b / Omega_m * m_tot / N, np.float32),
                "u": np.full(N, 150.0, np.float32),
                "h": np.full(N, 1.3 * d_mean, np.float32),
                "pid": np.arange(N, dtype=np.int64)},
        "dm": {"pos": np.mod(lat + psi, L),
               "v": vel.astype(np.float32),
               "m": np.full(N, (1 - Omega_b / Omega_m) * m_tot / N,
                            np.float32),
               "pid": np.arange(N, 2 * N, dtype=np.int64)},
    }


# ---------------------------------------------------------------------------
# EAGLE volume (examples/eagle_volume/make_ics.py, as arrays)
# ---------------------------------------------------------------------------

def eagle_volume_ic(n: int = 16, L: float = 25.0, z: float = 9.0,
                    star_frac: float = 0.02, seed: int = 42,
                    black_hole: bool = False):
    """The EAGLE volume's initial conditions
    (``examples/eagle_volume/make_ics.py`` without its HDF5 file): the
    SmallCosmoVolume arrays, with max(1, int(star_frac n^3)) gas sites,
    drawn by ``default_rng(seed).choice`` without replacement, carved out
    as star particles (id = gas id + 2 n^3, the gas's mass and velocity);
    with ``black_hole``, the file's seed black hole at the box centre (at
    rest, the stars' mean mass, id = the largest star id + 1).  Returns
    the dict of ``small_cosmo_volume_ic`` with a "stars" entry (and a
    "bh" entry)."""
    ic = small_cosmo_volume_ic(n=n, L=L, z=z)
    gas = ic["gas"]
    N = len(gas["pos"])
    n_star = max(1, int(star_frac * N))
    star_idx = np.random.default_rng(seed).choice(N, n_star, replace=False)
    keep = np.ones(N, bool)
    keep[star_idx] = False
    ic["stars"] = {"pos": gas["pos"][star_idx], "v": gas["v"][star_idx],
                   "m": gas["m"][star_idx],
                   "pid": gas["pid"][star_idx] + 2 * N}
    ic["gas"] = {k: v[keep] for k, v in gas.items()}
    if black_hole:
        st = ic["stars"]
        ic["bh"] = {"pos": np.asarray([[L / 2, L / 2, L / 2]]),
                    "v": np.zeros((1, 3), np.float32),
                    "m": np.asarray([st["m"].mean()], np.float32),
                    "pid": np.asarray([int(st["pid"].max()) + 1], np.int64)}
    return ic

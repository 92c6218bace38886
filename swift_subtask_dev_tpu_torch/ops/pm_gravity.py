"""Particle-mesh long-range gravity, in torch.

Port of the main-path subset of the reference's ``ops/pm_gravity.py``:
TSC deposit (``index_put_`` with accumulation) -> ``torch.fft.rfftn`` ->
the Hockney & Eastwood optimal influence function built on the exact
complement of the erfc-truncated P2P kernel (``green_table``, built once)
-> spectral gradient a_j(k) = -i k_j phi(k) -> ``irfftn`` -> TSC gather of
(ax, ay, az, phi) back to the particles.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

F32 = torch.float32


@dataclass(frozen=True)
class PMMeshParams:
    """Reference defaults: gravity_properties.c:38-40."""

    N: int                        # mesh side length
    box: Tuple[float, float, float]
    a_smooth: float = 1.25        # r_s in mesh cells
    r_cut_max_ratio: float = 4.5  # r_cut = ratio * r_s

    @property
    def cell(self) -> float:
        return self.box[0] / self.N

    @property
    def r_s(self) -> float:
        return self.a_smooth * self.cell

    @property
    def r_cut(self) -> float:
        return self.r_cut_max_ratio * self.r_s


# mass assignment order: 3 = TSC (the reference's default; its CIC and
# PCS variants are not ported)
ORDER = 3


def _axis_weights(x: torch.Tensor):
    """Per-axis TSC stencil: (base index, [(offset, weight), ...])."""
    i0 = torch.floor(x + 0.5).to(torch.int64)
    f = x - i0.to(F32)                       # in [-0.5, 0.5)
    a, b = 0.5 - f, 0.5 + f
    return i0, [(-1, 0.5 * (a * a)), (0, 0.75 - f * f), (1, 0.5 * (b * b))]


def _mesh_coords(pm: PMMeshParams, pos: torch.Tensor) -> torch.Tensor:
    box = torch.tensor(pm.box, dtype=F32, device=pos.device)
    return torch.remainder(pos.reshape(-1, 3) / box * pm.N, pm.N)


def deposit(pm: PMMeshParams, pos: torch.Tensor, m: torch.Tensor
            ) -> torch.Tensor:
    """TSC mass deposit -> (N, N, N) grid."""
    N = pm.N
    w = m.reshape(-1)
    x = _mesh_coords(pm, pos)
    ib, wx = _axis_weights(x[:, 0])
    jb, wy = _axis_weights(x[:, 1])
    kb, wz = _axis_weights(x[:, 2])
    grid = torch.zeros((N, N, N), dtype=F32, device=pos.device)
    for dx, ax in wx:
        ix = torch.remainder(ib + dx, N)
        for dy, ay in wy:
            iy = torch.remainder(jb + dy, N)
            for dz, az in wz:
                iz = torch.remainder(kb + dz, N)
                grid.index_put_((ix, iy, iz), w * ax * ay * az,
                                accumulate=True)
    return grid


def gather_multi(pm: PMMeshParams, fields, pos: torch.Tensor):
    """TSC interpolation of several mesh fields (one row gather per
    stencil point)."""
    N = pm.N
    shp = pos.shape[:-1]
    x = _mesh_coords(pm, pos)
    ib, wx = _axis_weights(x[:, 0])
    jb, wy = _axis_weights(x[:, 1])
    kb, wz = _axis_weights(x[:, 2])
    nf = len(fields)
    stacked = torch.stack([fld.reshape(-1) for fld in fields], dim=-1)
    out = 0.0
    for dx, ax in wx:
        ix = torch.remainder(ib + dx, N)
        for dy, ay in wy:
            iy = torch.remainder(jb + dy, N)
            for dz, az in wz:
                iz = torch.remainder(kb + dz, N)
                idx = (ix * N + iy) * N + iz
                out = out + stacked[idx] * (ax * ay * az)[:, None]
    return [out[:, i].reshape(shp) for i in range(nf)]


@functools.lru_cache(maxsize=8)
def _complement_table(N: int, L: float, r_s: float, r_cut: float):
    """Radial kernel table f(|k|) of the exact complement of the
    erfc-truncated P2P: phi_long(k) = (4 pi / k^2) f(k) with

      f(k) = 1 - k * int_0^rc erfc(r / 2 r_s) sin(k r) dr.

    Host numpy in f64 (the reference's table), integrated in row blocks
    so the (16384 x 4097) sine table never exists at once."""
    kmax = 5.5 * (2 * np.pi / L) * (N / 2)
    kk = np.linspace(0.0, kmax, 16384)
    rr = np.linspace(0.0, r_cut, 4097)
    u = rr / (2.0 * r_s)
    Sr = np.asarray([math.erfc(x) for x in u])
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    integ = np.empty_like(kk)
    for i0 in range(0, len(kk), 1024):
        blk = kk[i0:i0 + 1024]
        integ[i0:i0 + 1024] = trapezoid(
            Sr[None, :] * np.sin(np.outer(blk, rr)), rr, axis=1)
    fk = np.ones_like(kk)
    fk[1:] = 1.0 - kk[1:] * integ[1:]
    fk[0] = 0.0
    return kk.astype(np.float32), fk.astype(np.float32)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """Linear interpolation with constant extrapolation (jnp.interp)."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _window_hat(kx, ky, kz, cell: float):
    """Fourier transform of the TSC assignment window (sinc^ORDER)."""
    def s(k):
        x = k * (cell / 2.0)
        return torch.where(torch.abs(x) < 1e-12, 1.0, torch.sin(x) / x)
    w = s(kx) * s(ky) * s(kz)
    out = w
    for _ in range(ORDER - 1):
        out = out * w
    return out


def green_factor(pm: PMMeshParams, G: float, kxi, kyi, kzi):
    """phi_hat(k) = rho_hat(k) * green_factor, for the reference's default
    "optimal" Green function: Hockney & Eastwood alias-optimal influence
    function over the +-1 images per axis, built on the complement kernel,
    windows included (its "gaussian" and "complement" variants are not
    ported).  kxi/kyi/kzi are broadcastable f32 INTEGER frequency grids."""
    dev = kxi.device
    N = pm.N
    L = pm.box[0]
    cell = pm.cell
    two_pi = 2 * math.pi / L
    kx, ky, kz = kxi * two_pi, kyi * two_pi, kzi * two_pi
    k2 = kx * kx + ky * ky + kz * kz
    norm = N ** 3 / L ** 3          # FFT + density normalisation

    kkt, fkt = _complement_table(N, L, pm.r_s, pm.r_cut)
    kkj = torch.as_tensor(kkt, device=dev)
    fkj = torch.as_tensor(fkt, device=dev)

    shape = torch.broadcast_shapes(kx.shape, ky.shape, kz.shape)
    num = torch.zeros(shape, dtype=F32, device=dev)
    den = torch.zeros_like(num)
    kN = two_pi * N
    for nx in (-1, 0, 1):
        for ny in (-1, 0, 1):
            for nz in (-1, 0, 1):
                kxn = kx + nx * kN
                kyn = ky + ny * kN
                kzn = kz + nz * kN
                k2n = kxn * kxn + kyn * kyn + kzn * kzn
                wh = _window_hat(kxn, kyn, kzn, cell)
                W2 = wh * wh
                Rmag = 4 * math.pi * _interp(torch.sqrt(k2n), kkj, fkj) \
                    / torch.clamp_min(k2n, 1e-30)
                num = num + W2 * Rmag * (kx * kxn + ky * kyn + kz * kzn)
                den = den + W2
    g_opt = torch.where(k2 > 0,
                        num / (torch.clamp_min(k2, 1e-30) * (den * den)),
                        0.0)
    return -G * g_opt * norm


def _freqs(N: int, device):
    """Exact integer FFT frequencies as f32 (full axis, half axis)."""
    k_int = np.fft.fftfreq(N, d=1.0 / N)
    kz_int = np.fft.rfftfreq(N, d=1.0 / N)
    return (torch.as_tensor(k_int, dtype=F32, device=device),
            torch.as_tensor(kz_int, dtype=F32, device=device))


def green_table(pm: PMMeshParams, G: float,
                device="cuda") -> torch.Tensor:
    """The (N, N, N//2+1) green_factor grid on ``device`` (the card unless
    the caller names another; build once, outside the step:
    GravitySolver holds it as a buffer)."""
    k_int, kz_int = _freqs(pm.N, device)
    return green_factor(pm, G, k_int[:, None, None], k_int[None, :, None],
                        kz_int[None, None, :])


def long_range_fields(pm: PMMeshParams, mass_grid: torch.Tensor, G: float,
                      green: torch.Tensor = None):
    """One k-space pass -> (acc (3,N,N,N), phi (N,N,N)), spectral
    accelerations a_j(k) = -i k_j phi(k) (the reference's default; its
    4-point stencil is not ported) with the derivative Nyquist plane
    zeroed so the inverse transforms stay real-consistent."""
    N = pm.N
    L = pm.box[0]
    dev = mass_grid.device
    rho_k = torch.fft.rfftn(mass_grid.to(F32))
    k_int, kz_int = _freqs(N, dev)
    kx = k_int[:, None, None]
    ky = k_int[None, :, None]
    kz = kz_int[None, None, :]
    if green is None:
        green = green_factor(pm, G, kx, ky, kz)
    phi_k = rho_k * green
    phi = torch.fft.irfftn(phi_k, s=(N, N, N))

    def kd(k):  # derivative frequencies: Nyquist plane zeroed
        return torch.where(torch.abs(k) == N // 2, 0.0, k) \
            * (2 * math.pi / L)

    acc = [torch.fft.irfftn(phi_k * (-1j) * kd(kj), s=(N, N, N))
           for kj in (kx, ky, kz)]
    return torch.stack(acc), phi

"""Short-range (P2P) gravity factors — the near field of P3M, in torch.

Port of the factor functions of the reference's ``ops/p2p_gravity.py``:

* C2-spline softening (kernel_gravity.h:79): F = W(r/H)/H^3 inside the
  softening H, Newtonian 1/r^3 outside, with a = -G m F dx;
* Gadget-like long-range truncation (kernel_long_gravity.h:34):
  erfc(u) + 2u/sqrt(pi) exp(-u^2), u = r / (2 r_s).

erfc is the Abramowitz & Stegun 7.1.26 polynomial, not ``torch.erfc``:
the reference and ``csrc/pair_bodies.cuh`` use the same polynomial, so
every path agrees to rounding.
"""

from __future__ import annotations

import torch

_SQRT_PI_INV = 0.5641895835477563  # 1/sqrt(pi)


def _r_inv_of(r):
    return torch.where(r > 0, 1.0 / torch.clamp_min(r, 1e-30), 0.0)


def softened_force_factor(r2, H):
    """F(r) with a = -G m F(r) dx: W(r/H)/H^3 inside H, 1/r^3 outside."""
    r = torch.sqrt(r2)
    r_inv = _r_inv_of(r)
    u = r / H
    # C2 spline force kernel (kernel_gravity.h:91)
    W = 21.0 * u - 90.0
    W = W * u + 140.0
    W = W * u - 84.0
    W = W * u
    W = W * u + 14.0
    inside = W / (H * H * H)
    outside = r_inv * r_inv * r_inv
    return torch.where(r < H, inside, outside)


def _erfc_pos(x):
    """erfc(x) for x >= 0 — Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7)."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return poly * torch.exp(-x * x)


def truncation_factor(r2, r_s_inv):
    """chi_force(r, r_s) = erfc(u) + 2u/sqrt(pi) e^{-u^2}, u = r/(2 r_s)."""
    r = torch.sqrt(r2)
    u = 0.5 * r * r_s_inv
    return _erfc_pos(u) + 2.0 * u * _SQRT_PI_INV * torch.exp(-u * u)


def softened_pot_factor(r2, H):
    """phi = -G m P(r): (3 - S(r/H))/H inside H, 1/r outside, with
    S(u) = 3u^7 - 15u^6 + 28u^5 - 21u^4 + 7u^2 (kernel_gravity.h:62)."""
    r = torch.sqrt(r2)
    r_inv = _r_inv_of(r)
    u = r / H
    u2 = u * u
    S = u2 * (7.0 + u2 * (-21.0 + u * (28.0 + u * (-15.0 + 3.0 * u))))
    inside = (3.0 - S) / H
    return torch.where(r < H, inside, r_inv)


def pot_truncation_factor(r2, r_s_inv):
    """chi_pot(r, r_s) = erfc(r / (2 r_s)) (kernel_long_gravity.h:52)."""
    return _erfc_pos(0.5 * torch.sqrt(r2) * r_s_inv)


def force_pot_factors(r2, H_inv, r_s_inv, trunc: bool):
    """(F, P) softened + truncated force/potential factors, fused.

    The same formulas as the four factors above, restructured: one rsqrt
    gives r and 1/r, the erfc polynomial and its exp(-x^2) are shared by
    the force and potential truncations, and divides by constants are
    reciprocal multiplies.
    """
    r_inv = torch.where(r2 > 0, torch.rsqrt(torch.clamp_min(r2, 1e-38)),
                        0.0)
    r = r2 * r_inv
    u = r * H_inv
    W = 21.0 * u - 90.0
    W = W * u + 140.0
    W = W * u - 84.0
    W = W * u
    W = W * u + 14.0
    H3_inv = H_inv * H_inv * H_inv
    r_inv2 = r_inv * r_inv
    inside = u < 1.0
    F = torch.where(inside, W * H3_inv, r_inv2 * r_inv)
    u2 = u * u
    S = u2 * (7.0 + u2 * (-21.0 + u * (28.0 + u * (-15.0 + 3.0 * u))))
    P = torch.where(inside, (3.0 - S) * H_inv, r_inv)
    if trunc:
        x = 0.5 * r * r_s_inv
        e = torch.exp(-x * x)
        t = 1.0 / (1.0 + 0.3275911 * x)
        poly = t * (0.254829592 + t * (-0.284496736 + t * (
            1.421413741 + t * (-1.453152027 + t * 1.061405429))))
        erfc = poly * e
        F = F * (erfc + (2.0 * _SQRT_PI_INV) * x * e)
        P = P * erfc
    return F, P

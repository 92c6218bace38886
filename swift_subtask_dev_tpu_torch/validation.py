"""The exact Riemann solution for the shock-tube validation problems.

Copies of ``riemann_exact`` and ``sod_solution`` from the reference's
``validation.py`` (plain NumPy: Toro 1999, ch. 4, as SWIFT's
examples/HydroTests/SodShock_3D/plotSolution.py): the oracle the Sod
example and ``chip_smoke.py`` hold the engine's profile to.
"""

from __future__ import annotations

import numpy as np


def riemann_exact(rho_l, v_l, P_l, rho_r, v_r, P_r, gamma, x, t,
                  x0=0.0):
    """Exact solution of the 1D Riemann problem sampled at positions x, time t.

    Returns (rho, v, P) arrays.  Standard exact solver: Newton iteration for
    the star-region pressure, then wave-by-wave sampling.
    """
    g = gamma
    g1 = (g - 1) / (2 * g)
    g2 = (g + 1) / (2 * g)
    g3 = 2 * g / (g - 1)
    g4 = 2 / (g - 1)
    g5 = 2 / (g + 1)
    g6 = (g - 1) / (g + 1)
    g7 = (g - 1) / 2
    g8 = g - 1

    c_l = np.sqrt(g * P_l / rho_l)
    c_r = np.sqrt(g * P_r / rho_r)

    def f_K(P, rho_K, P_K, c_K):
        if P > P_K:  # shock
            A = g5 / rho_K
            B = g6 * P_K
            return (P - P_K) * np.sqrt(A / (P + B))
        else:  # rarefaction
            return g4 * c_K * ((P / P_K) ** g1 - 1.0)

    def f_K_prime(P, rho_K, P_K, c_K):
        if P > P_K:
            A = g5 / rho_K
            B = g6 * P_K
            return np.sqrt(A / (B + P)) * (1 - 0.5 * (P - P_K) / (B + P))
        else:
            return 1.0 / (rho_K * c_K) * (P / P_K) ** (-g2)

    # initial guess (two-rarefaction approximation)
    P_star = max(1e-8, ((c_l + c_r - g7 * (v_r - v_l))
                        / (c_l / P_l ** g1 + c_r / P_r ** g1)) ** g3)
    for _ in range(60):
        f = f_K(P_star, rho_l, P_l, c_l) + f_K(P_star, rho_r, P_r, c_r) \
            + (v_r - v_l)
        fp = f_K_prime(P_star, rho_l, P_l, c_l) \
            + f_K_prime(P_star, rho_r, P_r, c_r)
        dP = f / fp
        P_new = max(1e-10, P_star - dP)
        if abs(P_new - P_star) < 1e-12 * P_star:
            P_star = P_new
            break
        P_star = P_new

    v_star = 0.5 * (v_l + v_r) + 0.5 * (
        f_K(P_star, rho_r, P_r, c_r) - f_K(P_star, rho_l, P_l, c_l))

    x = np.asarray(x, np.float64)
    if t <= 0:
        rho = np.where(x < x0, rho_l, rho_r)
        v = np.where(x < x0, v_l, v_r)
        P = np.where(x < x0, P_l, P_r)
        return rho, v, P
    s = (x - x0) / t

    rho = np.empty_like(x)
    v = np.empty_like(x)
    P = np.empty_like(x)

    # left of contact
    left = s <= v_star
    if P_star > P_l:  # left shock
        rho_star_l = rho_l * ((P_star / P_l + g6) / (g6 * P_star / P_l + 1))
        S_l = v_l - c_l * np.sqrt(g2 * P_star / P_l + g1)
        in_l = left & (s < S_l)
        in_star = left & (s >= S_l)
        rho[in_l], v[in_l], P[in_l] = rho_l, v_l, P_l
        rho[in_star], v[in_star], P[in_star] = rho_star_l, v_star, P_star
    else:  # left rarefaction
        rho_star_l = rho_l * (P_star / P_l) ** (1 / g)
        c_star_l = c_l * (P_star / P_l) ** g1
        S_hl = v_l - c_l
        S_tl = v_star - c_star_l
        in_l = left & (s < S_hl)
        in_fan = left & (s >= S_hl) & (s < S_tl)
        in_star = left & (s >= S_tl)
        rho[in_l], v[in_l], P[in_l] = rho_l, v_l, P_l
        sf = s[in_fan]
        v[in_fan] = g5 * (c_l + g7 * v_l + sf)
        cf = g5 * (c_l + g7 * (v_l - sf))
        rho[in_fan] = rho_l * (cf / c_l) ** g4
        P[in_fan] = P_l * (cf / c_l) ** g3
        rho[in_star], v[in_star], P[in_star] = rho_star_l, v_star, P_star

    # right of contact
    right = ~left
    if P_star > P_r:  # right shock
        rho_star_r = rho_r * ((P_star / P_r + g6) / (g6 * P_star / P_r + 1))
        S_r = v_r + c_r * np.sqrt(g2 * P_star / P_r + g1)
        in_r = right & (s > S_r)
        in_star = right & (s <= S_r)
        rho[in_r], v[in_r], P[in_r] = rho_r, v_r, P_r
        rho[in_star], v[in_star], P[in_star] = rho_star_r, v_star, P_star
    else:  # right rarefaction
        rho_star_r = rho_r * (P_star / P_r) ** (1 / g)
        c_star_r = c_r * (P_star / P_r) ** g1
        S_hr = v_r + c_r
        S_tr = v_star + c_star_r
        in_r = right & (s > S_hr)
        in_fan = right & (s <= S_hr) & (s > S_tr)
        in_star = right & (s <= S_tr)
        rho[in_r], v[in_r], P[in_r] = rho_r, v_r, P_r
        sf = s[in_fan]
        v[in_fan] = g5 * (-c_r + g7 * v_r + sf)
        cf = g5 * (c_r - g7 * (v_r - sf))
        rho[in_fan] = rho_r * (cf / c_r) ** g4
        P[in_fan] = P_r * (cf / c_r) ** g3
        rho[in_star], v[in_star], P[in_star] = rho_star_r, v_star, P_star

    return rho, v, P


def sod_solution(x, t, gamma=5.0 / 3.0, x0=1.0):
    """SWIFT's SodShock_3D setup: (1, 0, 1) | (0.125, 0, 0.1)."""
    return riemann_exact(1.0, 0.0, 1.0, 0.125, 0.0, 0.1, gamma, x, t, x0)

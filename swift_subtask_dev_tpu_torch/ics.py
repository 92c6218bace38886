"""Initial conditions (numpy, seeded).

Copies of ``bcc_lattice``, ``uniform_box_ic`` and ``sedov_ic`` from the
reference's ``ics.py``: the same lattice, the same ``default_rng(seed)``
jitter and the same blast injection, so both packages start from
identical particles.
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

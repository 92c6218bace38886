"""Star smoothing-length iteration (the species ghost).

Port of the reference's ``ops/species_ghost.py`` (SWIFT's
src/runner_ghost.c:72 runner_do_stars_ghost): a star's h is iterated to
the neighbour target over its gas neighbours with the gas ghost's
Newton/bisection update (``models.sph.sphenix.ghost_h_update``), on the
27-cell stencil's live-slot walk (``ops.stencil._stencil_pairs``).  Stars
sum W over gas neighbours with no self term (stars/EAGLE/stars.h:202
stars_end_density) and aim at eta^3 with the hydro eta.

The reference's traced ``while_loop`` becomes a host loop that reads the
convergence flag each trip; each trip re-sums only the stars it updates
(the others keep their sums, which the reference recomputes and then
discards), so the iteration is the reference's.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from ..models.sph import sphenix
from .stencil import _sanitize, _stencil_pairs

HYDRO_DIM = 3.0


def species_wcount_loop(grid, s_i: Dict, gas_s: Dict, p,
                        sel: Optional[torch.Tensor] = None,
                        packed: bool = False):
    """Raw neighbour-count sums of a non-gas species over gas: (wsum,
    wdh_sum), the unnormalised sum w(u) and sum -(3 w + u w') over gas
    neighbours within gamma h_i (stars_iact.h
    runner_iact_nonsym_stars_density), (C, K_i) each.  ``sel`` limits the
    i slots summed (the others read 0); by default every live slot.
    ``packed``: the 27 offsets as one j axis (``stencil._stencil_walk``;
    for a species of few particles, the black holes)."""
    gamma2 = float(np.float32(p.kernel.gamma2))
    h = _sanitize(s_i["mask"], s_i["h"])
    if sel is None:
        sel = s_i["mask"] > 0

    def acc(gi, gj, dx, r2):
        hinv = gi["hinv"]
        ok = gj["_valid"] & (r2 * hinv ** 2 < gamma2)
        u = torch.sqrt(r2) * hinv
        wi, wi_dx = p.kernel.deval(u)
        kick = HYDRO_DIM * wi + u * wi_dx
        return torch.cat([
            torch.sum(torch.where(ok, wi, 0.0), -1, keepdim=True),
            -torch.sum(torch.where(ok, kick, 0.0), -1, keepdim=True)], -1)

    out = _stencil_pairs(grid, {"off": s_i["off"], "hinv": 1.0 / h}, sel,
                         {"off": gas_s["off"]}, gas_s["mask"] > 0, acc, 2,
                         packed)
    return out[..., 0] * s_i["mask"], out[..., 1] * s_i["mask"]


def species_h_iterate(grid, s_i: Dict, gas_s: Dict, p,
                      active: torch.Tensor, max_iter: int = 10,
                      eta: Optional[float] = None, h_min: float = 0.0,
                      h_max: Optional[float] = None, packed: bool = False):
    """Iterate the species' h to the neighbour target over gas.

    Returns (h_new (C, K_i), wcount (C, K_i), n_iter).  Only ``active``
    slots are updated, warm-started from s_i["h"]; ``wcount`` is the
    normalised sum of W(r, h) h^-3 at the final h of the active slots (0
    elsewhere).  ``packed`` as ``species_wcount_loop``'s."""
    eta_dim = float(eta) ** 3 if eta is not None else p.eta_dim
    pp = SimpleNamespace(eta_dim=eta_dim, h_tolerance=p.h_tolerance,
                         h_min=h_min,
                         h_max=float(h_max) if h_max is not None
                         else p.h_max)
    live = s_i["mask"] > 0
    has_floor = 1e-5 * eta_dim

    def wpass(h, sel):
        wsum, wdh = species_wcount_loop(grid, {**s_i, "h": h}, gas_s, p,
                                        sel=sel, packed=packed)
        # stars_end_density: no kernel_root self term
        hs = torch.where(live, h, 1.0)
        hs2 = hs * hs
        return wsum / (hs * hs2), wdh / (hs2 * hs2)

    def h_update(h, wc, wdh, left, right):
        has_ngb = wc * (h * (h * h)) > has_floor
        return sphenix.ghost_h_update(pp, h, wc, wdh, left, right, has_ngb)

    h = torch.where(live, s_i["h"], 1.0)
    left = torch.zeros_like(h)
    right = torch.full_like(h, pp.h_max)
    wc, wdh = wpass(h, live & active)
    _, _, _, conv = h_update(h, wc, wdh, left, right)
    conv = conv | ~active
    n_iter = 0
    while n_iter < max_iter and not bool(conv.all()):
        h_new, left, right, _ = h_update(h, wc, wdh, left, right)
        upd = active & ~conv
        h = torch.where(upd, h_new, h)
        wc_n, wdh_n = wpass(h, live & upd)
        wc = torch.where(upd, wc_n, wc)
        wdh = torch.where(upd, wdh_n, wdh)
        _, _, _, c2 = h_update(h, wc, wdh, left, right)
        conv = conv | ~upd | (upd & c2)
        n_iter += 1
    h = torch.where(live, h, s_i["h"])
    return h, torch.where(active, wc, 0.0), n_iter

"""The 27-cell neighbour stencil: its constants and the limiter's scan.

Port of the reference's ``ops/stencil.py`` (the XLA roll-stencil): its
constants, the view and roll helpers, and ``timebin_loop``, the wake scan
of the timestep limiter on the 27-cell grid (the ``pallas`` and
``pallas_ring`` backends).  The stencil's density, gradient and force
loops (the ``xla`` backend) are not ported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# "no neighbour" sentinel of the time-bin min reductions (> any real bin,
# small enough that sentinel + 2 cannot overflow i32)
NBIN_SENTINEL = 64

# The 27 stencil offsets, self first: the order the packed pair kernel
# walks the neighbour cells.
STENCIL_27 = [(0, 0, 0)] + [
    (dx, dy, dz)
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if not (dx == 0 and dy == 0 and dz == 0)
]

F32 = torch.float32


def _grid_view(grid, arr: torch.Tensor) -> torch.Tensor:
    """(C, K, ...) -> (ncx, ncy, ncz, K, ...)."""
    return arr.reshape(tuple(grid.cdim) + tuple(arr.shape[1:]))


def _flat_view(grid, arr: torch.Tensor) -> torch.Tensor:
    return arr.reshape((grid.C,) + tuple(arr.shape[3:]))


def _roll(arr: torch.Tensor, d) -> torch.Tensor:
    """rolled[c] = arr[c + d] (periodic)."""
    if tuple(d) == (0, 0, 0):
        return arr
    return torch.roll(arr, shifts=(-d[0], -d[1], -d[2]), dims=(0, 1, 2))


def _sanitize(mask, x, fill=1.0):
    """Empty-slot values replaced so masked pairs stay finite."""
    return torch.where(mask > 0, x, fill)


def timebin_loop(grid, s: Dict[str, torch.Tensor], p) -> torch.Tensor:
    """(C, K) i32 min time bin over *active* neighbours whose kernel
    reaches the slot (the limiter's wake scan, runner_iact_nonsym_limiter,
    timestep_limiter_iact.h:106, inverted j-centric): ``NBIN_SENTINEL``
    where there is none.

    ``s`` holds mask, off, h, time_bin (post-timestep) and active (0/1
    f32).  The reference's unrolled form: for each of the 27 stencil
    cells the periodic shift is folded into the j offsets before the
    subtraction, ``dx = off_i - (off_j + f32(d * edge))``, and
    ``mask_j > 0 & active_j > 0 & r2 > 0 & r2 < gamma^2 h_j^2 & tb_j > 0``
    accepts a pair.  Only live active slots can be accepted, so each
    cell's are gathered first and the others are never paired (exact: a
    min over the pairs the mask accepts); the offsets are walked one at a
    time, so one (C, K, Kj) tile is live at once."""
    g = lambda name: _grid_view(grid, s[name])        # noqa: E731
    mask, off = g("mask"), g("off")
    h = _sanitize(mask, g("h"))
    tb = g("time_bin").to(F32)
    cand = (mask > 0) & (g("active") > 0)
    gamma2 = float(np.float32(p.kernel.gamma2))
    big_bin = 1e9
    acc = torch.full(mask.shape, big_bin, dtype=F32, device=mask.device)
    Kj = int(cand.sum(-1).max()) if cand.numel() else 0
    if Kj:
        order = torch.argsort((~cand).to(torch.int8), dim=-1,
                              stable=True)[..., :Kj]

        def take(x):
            return torch.gather(x, -1, order)

        j_fields = {"cand": take(cand), "h": take(h), "tb": take(tb),
                    **{f"off{a}": take(off[..., a]) for a in range(3)}}
        edge = grid.edge
        for d in STENCIL_27:
            jf = {k: _roll(v, d)[..., None, :] for k, v in j_fields.items()}
            dx = [off[..., a, None]
                  - (jf[f"off{a}"] + float(np.float32(d[a] * edge[a])))
                  for a in range(3)]
            r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
            h_j, tb_j = jf["h"], jf["tb"]
            ok = (jf["cand"] & (r2 > 0) & (r2 < gamma2 * h_j * h_j)
                  & (tb_j > 0))
            acc = torch.minimum(acc, torch.amin(
                torch.where(ok, tb_j, big_bin), dim=-1))
    return _flat_view(grid, torch.clamp_max(acc, float(NBIN_SENTINEL))
                      ).to(torch.int32)

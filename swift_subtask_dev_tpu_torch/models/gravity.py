"""Self-gravity solver for the flat column grid: PM mesh + P2P near field.

Port of the flat (P3M) branch of the reference's ``models/gravity.py``
for periodic boxes (the erfc-truncated P2P always pairs with the mesh):
the column edges cover r_cut, so everything inside the 9 neighbour columns
within r_cut is direct P2P on the flat pair engine and everything beyond
is the PM mesh.  Every species bucketed on the grid sources and receives
gravity: the mesh deposits their union, and each species' P2P pass runs
over every species (K1's one-species launch against itself, its
cross-species launch against the others).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..grid.cellgrid import CellGrid
from ..ops import hydro_flat, pm_gravity


@dataclass(frozen=True)
class GravityParams:
    """Reference Gravity: YAML section (gravity_properties.c)."""

    G: float = 1.0
    eps: float = 1e-3            # Plummer-equivalent comoving softening
    # (the baryon value; Gravity:comoving_baryon_softening)
    eps_dm: float = 0.0          # DM softening (comoving_DM_softening);
    # 0 -> same as eps.  Pairs soften with max(H_i, H_j), H = 3 eps
    mesh_N: int = 64             # Gravity:mesh_side_length
    a_smooth: float = 1.25
    r_cut_ratio: float = 4.5
    eta: float = 0.025           # Gravity:eta (timestep)

    @property
    def H_soft(self) -> float:
        """Softening kernel size H = 3 * Plummer eps (kernel_gravity.h)."""
        return 3.0 * self.eps

    @property
    def H_soft_dm(self) -> float:
        return 3.0 * (self.eps_dm if self.eps_dm > 0 else self.eps)


class GravitySolver(nn.Module):
    """Owns the PM mesh and computes P3M accelerations for species tiles.

    Buffers: ``mesh_green`` (N, N, N//2+1), the optimal influence
    function, and ``corners`` (C, 3), the column corner positions, on
    ``device`` (the card unless the caller names another).
    """

    def __init__(self, gp: GravityParams, grid: CellGrid, device="cuda"):
        super().__init__()
        if grid.cdim[2] != 1:
            raise ValueError("the port's GravitySolver runs on the flat "
                             "column grid only (cdim z == 1)")
        self.gp = gp
        self.grid = grid
        # per-species Plummer softenings, aligned with the species list
        # the caller passes to the list methods ([baryon, dm, ...] in the
        # multi engine's order); None -> gp.eps for every species
        self.eps_per_species: Optional[List[float]] = None
        self.pm = pm_gravity.PMMeshParams(
            N=gp.mesh_N, box=grid.box, a_smooth=gp.a_smooth,
            r_cut_max_ratio=gp.r_cut_ratio)
        if min(grid.edge[:2]) < self.pm.r_cut * (1 - 1e-6):
            raise ValueError(
                f"flat gravity needs column edges >= r_cut="
                f"{self.pm.r_cut:.4g} (have {grid.edge[:2]}); "
                "coarsen the PM mesh or the columns")
        self.register_buffer(
            "corners", torch.as_tensor(grid.cell_corners(),
                                       dtype=torch.float32, device=device))
        self.register_buffer(
            "mesh_green", pm_gravity.green_table(self.pm, gp.G, device))

    def positions_of(self, s: Dict) -> torch.Tensor:
        """(C, K, 3) absolute positions from tiled offsets (f32)."""
        return self.corners[:, None, :] + s["off"]

    def mesh_accelerations(self, species: Sequence[Dict]) -> List:
        """PM long-range only: [(acc_mesh (C,K,3), pot_mesh (C,K)), ...]
        for each species, from one TSC deposit of their union, one solve
        and a gather per species."""
        pos_all = [self.positions_of(s) for s in species]
        grid_mass = 0.0
        for s, pos in zip(species, pos_all):
            grid_mass = grid_mass + pm_gravity.deposit(
                self.pm, pos, s["m"] * s["mask"])
        acc_mesh, phi = pm_gravity.long_range_fields(
            self.pm, grid_mass, self.gp.G, green=self.mesh_green)
        outs = []
        for s, pos in zip(species, pos_all):
            ax, ay, az, pot = pm_gravity.gather_multi(
                self.pm, (acc_mesh[0], acc_mesh[1], acc_mesh[2], phi), pos)
            outs.append((torch.stack([ax, ay, az], -1)
                         * s["mask"][..., None], pot * s["mask"]))
        return outs

    def _H_list(self, n: int) -> List[float]:
        """Per-species softening kernel sizes H = 3 eps."""
        eps = self.eps_per_species
        if eps:
            return [3.0 * float(e) for e in eps[:n]] \
                + [self.gp.H_soft] * max(0, n - len(eps))
        return [self.gp.H_soft] * n

    def short_range_accelerations(self, species: Sequence[Dict]) -> List:
        """Near-field P2P on the flat pair engine: [(acc (C,K,3), pot
        (C,K)), ...], each species from every species."""
        gp = self.gp
        H = self._H_list(len(species))
        return [hydro_flat.p2p_gravity_loop(
            self.grid, s, species, gp.G, H[i], self.pm.r_s, self.pm.r_cut,
            H_soft_j=H) for i, s in enumerate(species)]

    def gas_short_range_fn(self):
        """Near-field gravity_fn of one species (the single-species
        engines) for an engine running split mesh kicks.

        The returned fn carries ``fuse_spec`` — the P2P literals — so the
        gas engine folds the gravity pair pass into the hydro force pass
        (hydro_flat.force_gravity_loop)."""
        def fn(s: Dict):
            [(acc, pot)] = self.short_range_accelerations([s])
            return acc, pot
        gp = self.gp
        fn.fuse_spec = dict(G=gp.G, H_soft=self._H_list(1)[0],
                            r_s=self.pm.r_s, r_cut=self.pm.r_cut)
        return fn

    def gas_mesh_fn(self):
        """mesh_fn hook of one species: (acc_mesh, pot_mesh)."""
        def fn(s: Dict):
            [(acc, pot)] = self.mesh_accelerations([s])
            return acc, pot
        return fn

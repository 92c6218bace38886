"""The cell grid and its bucketing, in torch.

Port of the reference's ``grid/cellgrid.py``: a periodic grid of
``ncx * ncy * ncz`` cells, each a fixed-capacity tile of ``K`` slots.  The
flat backend uses columns (``ncz == 1``) whose particles are sorted by z
(``zsort=True``); the 27-cell backend uses a 3-d grid whose particles keep
their input order within a cell (``zsort=False``).  Positions inside the
engine are (cell, f32 offset-from-corner) pairs.

The bucketing reproduces the reference bit for bit: the same f32
mod/floor chain, the same order (one stable sort by cell, or the (cell, z)
lexicographic order as two stable sorts: z first, then cell), the same
rank-in-run and overflow sentinel.  Live particles fill a prefix of their
cell's slots.  Every function here runs on whatever device its tensors
live on; ``bucket_fields`` puts new tensors on the card unless the caller
names another device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

I32 = torch.int32
F32 = torch.float32


@dataclass(frozen=True)
class CellGrid:
    """Static description of the periodic top grid."""

    box: Tuple[float, float, float]
    cdim: Tuple[int, int, int]
    K: int
    # Cyclic x relabeling: physical column ix maps to ARRAY index
    # (ix + x_roll) % ncx (the reference's slab-balance knob; 0 on a
    # single device).
    x_roll: int = 0

    def __post_init__(self):
        if any(c < 3 and c != 1 for c in self.cdim):
            raise ValueError(
                f"cdim {self.cdim} < 3: the 27-stencil needs >= 3 cells per "
                "axis (otherwise offsets alias and pairs double-count); "
                "an axis of exactly 1 is the column layout of the flat "
                "backend, which never runs the stencil")

    def validate_range(self, interaction_range: float) -> None:
        """Check every cell edge covers the interaction range (a smaller
        edge would silently lose pairs)."""
        bad = [e for e in self.edge if e < interaction_range * (1 - 1e-6)]
        if bad:
            raise ValueError(
                f"cell edges {self.edge} smaller than interaction range "
                f"{interaction_range}: box too thin or h too large "
                f"(need box >= 3*range per axis)")

    @property
    def C(self) -> int:
        return self.cdim[0] * self.cdim[1] * self.cdim[2]

    @property
    def edge(self) -> Tuple[float, float, float]:
        return (self.box[0] / self.cdim[0],
                self.box[1] / self.cdim[1],
                self.box[2] / self.cdim[2])

    @property
    def edge_arr(self) -> np.ndarray:
        return np.asarray(self.edge, dtype=np.float64)

    @staticmethod
    def _cdim_for(box, interaction_range: float, min_cdim: int,
                  max_cdim: int):
        return [int(np.clip(int(math.floor(b / max(interaction_range,
                                                     1e-30))),
                            min_cdim, max_cdim)) for b in box]

    @staticmethod
    def build(box, interaction_range: float, n_particles: int,
              occupancy: float = 0.55, k_align: int = 8,
              max_cdim: int = 128, min_cdim: int = 3,
              k_max: int = 2048) -> "CellGrid":
        """3-d grid with cell edges >= interaction_range; K targets a mean
        occupancy of ``occupancy``, rounded up to a multiple of
        ``k_align``."""
        box = tuple(float(b) for b in box)
        cdim = CellGrid._cdim_for(box, interaction_range, min_cdim,
                                  max_cdim)
        C = cdim[0] * cdim[1] * cdim[2]
        mean_per_cell = n_particles / max(C, 1)
        K = int(math.ceil(mean_per_cell / occupancy / k_align)) * k_align
        K = min(max(K, k_align), k_max)
        return CellGrid(box=box, cdim=tuple(cdim), K=K)

    @staticmethod
    def build_for_positions(box, interaction_range: float, pos,
                            headroom: float = 1.5, k_align: int = 8,
                            max_cdim: int = 128, min_cdim: int = 3
                            ) -> "CellGrid":
        """Like :meth:`build`, but K = fullest cell's count * headroom
        (rounded up to ``k_align``), from a histogram of ``pos`` on the
        candidate grid."""
        box = tuple(float(b) for b in box)
        pos = np.asarray(pos, np.float64)
        cdim = CellGrid._cdim_for(box, interaction_range, min_cdim,
                                  max_cdim)
        edge = np.asarray(box) / np.asarray(cdim)
        ijk = np.floor(np.mod(pos, box) / edge).astype(np.int64)
        ijk = np.clip(ijk, 0, np.asarray(cdim) - 1)
        lin = (ijk[:, 0] * cdim[1] + ijk[:, 1]) * cdim[2] + ijk[:, 2]
        max_count = int(np.bincount(lin).max()) if len(lin) else 1
        K = int(math.ceil(max_count * headroom / k_align)) * k_align
        g = CellGrid(box=box, cdim=tuple(cdim), K=max(K, k_align))
        g.validate_range(interaction_range)
        return g

    @staticmethod
    def build_columns(box, interaction_range: float, pos,
                      headroom: float = 1.4, w_align: int = 128,
                      max_cdim: int = 512) -> "CellGrid":
        """Column grid for the flat (z-sorted) backend: cdim=(ncx, ncy, 1).

        Column cross-section >= interaction_range (so 9 neighbour columns
        cover all pairs); W sized from the actual fullest column, aligned
        to the kernel's 128-lane i-tiles.
        """
        box = tuple(float(b) for b in box)
        pos = np.asarray(pos, np.float64)
        cd = CellGrid._cdim_for(box[:2], interaction_range, 3, max_cdim)
        edge = np.asarray([box[0] / cd[0], box[1] / cd[1]])
        ij = np.floor(np.mod(pos[:, :2], box[:2]) / edge).astype(np.int64)
        ij = np.clip(ij, 0, np.asarray(cd) - 1)
        lin = ij[:, 0] * cd[1] + ij[:, 1]
        max_count = int(np.bincount(lin).max()) if len(lin) else 1
        W = int(math.ceil(max_count * headroom / w_align)) * w_align
        return CellGrid(box=box, cdim=(cd[0], cd[1], 1), K=max(W, w_align))

    def cell_corners(self) -> np.ndarray:
        """(C, 3) f64 cell corner positions (host-side, exact).

        Array x index j sits at physical column (j - x_roll) % ncx."""
        ix, iy, iz = np.meshgrid(np.arange(self.cdim[0]),
                                 np.arange(self.cdim[1]),
                                 np.arange(self.cdim[2]), indexing="ij")
        ix = (ix - self.x_roll) % self.cdim[0]
        idx = np.stack([ix, iy, iz], axis=-1).reshape(-1, 3).astype(np.float64)
        return idx * self.edge_arr

    def linear_cell_of(self, ixyz: torch.Tensor) -> torch.Tensor:
        """Linear cell index from integer (..., 3) cell coords (with wrap)."""
        ncx, ncy, ncz = self.cdim
        ix = torch.remainder(ixyz[..., 0], ncx)
        iy = torch.remainder(ixyz[..., 1], ncy)
        iz = torch.remainder(ixyz[..., 2], ncz)
        return (ix * ncy + iy) * ncz + iz


def _lexsort(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Indices ordering by (major, minor), ties by position — numpy's
    ``lexsort((minor, major))`` as two stable sorts."""
    o1 = torch.sort(minor, stable=True).indices
    o2 = torch.sort(major[o1], stable=True).indices
    return o1[o2]


def _rank_in_run(cell_s: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal values, for a SORTED
    key array: boundary flags + one cumulative max of the boundary
    indices (O(N))."""
    n = cell_s.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=cell_s.device)
    boundary = torch.ones(n, dtype=torch.bool, device=cell_s.device)
    boundary[1:] = cell_s[1:] != cell_s[:-1]
    first = torch.cummax(torch.where(boundary, iota, 0), dim=0).values
    return iota - first


def _as_f32_tensor(x, device) -> torch.Tensor:
    t = torch.as_tensor(x, device=device)
    return t.to(F32) if t.dtype == torch.float64 else t


def _cell_order(cell: torch.Tensor, z: torch.Tensor,
                zsort: bool) -> torch.Tensor:
    """Slot order: by cell (stable), and by z within a cell if zsort."""
    if zsort:
        return _lexsort(z, cell)
    return torch.sort(cell, stable=True).indices


def bucket_fields(grid: CellGrid, pos, fields: Dict, device="cuda",
                  zsort: bool = True):
    """Counting-sort N particles into (C, K, ...) padded tiles, z-sorted
    within each tile when ``zsort`` (the flat backend's columns), else in
    input order within each cell (the reference's ``zsort=False``).

    pos: (N, 3) absolute positions (any float dtype; wrapped periodically,
    computed in f32 like the reference).  fields: dict of (N,) or (N, 3)
    arrays scattered alongside (f64 inputs become f32).

    Returns (out_fields, mask, off, n_overflow): mask (C, K) f32, off
    (C, K, 3) f32 cell-local offsets, n_overflow a 0-dim i32 tensor of
    particles dropped because their cell exceeded K.
    """
    pos = torch.as_tensor(pos, device=device).to(F32)
    dev = pos.device
    box = torch.tensor(grid.box, dtype=F32, device=dev)
    edge = torch.tensor(grid.edge_arr, dtype=F32, device=dev)
    cdim = torch.tensor(grid.cdim, dtype=I32, device=dev)
    C, K = grid.C, grid.K
    N = pos.shape[0]
    ncx, ncy, ncz = grid.cdim

    p = torch.remainder(pos, box)
    ixyz = torch.floor(p / edge).to(I32)
    ixyz = torch.clamp(ixyz, torch.zeros_like(cdim), cdim - 1)
    off = p - ixyz.to(F32) * edge
    cell = (((ixyz[:, 0] + grid.x_roll) % ncx) * ncy
            + ixyz[:, 1] % ncy) * ncz + ixyz[:, 2] % ncz
    cell = cell.to(torch.int64)

    order = _cell_order(cell, p[:, 2], zsort)
    cell_s = cell[order]
    rank = _rank_in_run(cell_s)

    ok = rank < K
    n_overflow = torch.sum(~ok).to(I32)
    slot = torch.where(ok, cell_s * K + rank, C * K)

    def scatter(x_sorted, fill=0.0):
        out = torch.full((C * K + 1,) + tuple(x_sorted.shape[1:]), fill,
                         dtype=x_sorted.dtype, device=dev)
        out[slot] = x_sorted
        return out[:-1].reshape((C, K) + tuple(x_sorted.shape[1:]))

    out_fields = {name: scatter(_as_f32_tensor(arr, dev)[order])
                  for name, arr in fields.items()}
    mask = scatter(torch.ones(N, dtype=F32, device=dev))
    off_t = scatter(off[order])
    return out_fields, mask, off_t, n_overflow


def rebucket_offsets(grid: CellGrid, mask: torch.Tensor, off: torch.Tensor,
                     fields: Dict[str, torch.Tensor], zsort: bool = True):
    """Re-bucket from existing (C, K) tiles after drift, z-sorted within
    each tile when ``zsort`` (as :func:`bucket_fields`).

    Computes each slot's new cell from its (possibly out-of-cell) offset
    and redistributes all fields — exact in f32 because it never forms
    absolute positions.  One i32 scatter builds the destination->source
    map; every field then moves by one row gather per dtype group.  The
    moved arrays are keyed by position in a list, never by a name that
    could collide with a caller's field.

    Returns (out_fields, new_mask, new_off, n_overflow).
    """
    dev = mask.device
    C, K = grid.C, mask.shape[1]
    edge = torch.tensor(grid.edge_arr, dtype=F32, device=dev)
    cdim = torch.tensor(grid.cdim, dtype=I32, device=dev)

    cid = torch.arange(C, dtype=I32, device=dev)
    ncx, ncy, ncz = grid.cdim
    ix = cid // (ncy * ncz)
    iy = (cid // ncz) % ncy
    iz = cid % ncz
    cur = torch.stack([ix, iy, iz], dim=-1)[:, None, :]     # (C,1,3)

    shift = torch.floor(off / edge).to(I32)                 # (C,K,3)
    new_ixyz = torch.remainder(cur + shift, cdim)
    new_off = off - shift.to(F32) * edge
    new_cell = grid.linear_cell_of(new_ixyz).reshape(-1).to(torch.int64)

    valid = mask.reshape(-1) > 0
    new_cell = torch.where(valid, new_cell, C)  # invalid slots sort last

    order = _cell_order(new_cell, new_off[..., 2].reshape(-1), zsort)
    cell_s = new_cell[order]
    rank = _rank_in_run(cell_s)

    ok = (cell_s < C) & (rank < K)
    n_overflow = torch.sum((cell_s < C) & (rank >= K)).to(I32)
    slot = torch.where(ok, cell_s * K + rank, C * K)

    CK = C * K
    src = torch.full((CK + 1,), CK, dtype=torch.int64, device=dev)
    src[slot] = order
    src = src[:-1]

    names = list(fields)
    arrays = [mask, new_off] + [fields[n] for n in names]
    fills = [0, 0] + [(-1 if n == "pid" and not fields[n].is_floating_point()
                       else 0) for n in names]
    groups: Dict[torch.dtype, list] = {}
    for i, arr in enumerate(arrays):
        groups.setdefault(arr.dtype, []).append(i)
    moved = [None] * len(arrays)
    for dt, idx in groups.items():
        flats = [arrays[i].reshape(CK, -1) for i in idx]
        fill_row = torch.cat(
            [torch.full((1, f.shape[1]), fills[i], dtype=dt, device=dev)
             for i, f in zip(idx, flats)], dim=1)
        big = torch.cat([torch.cat(flats, dim=1), fill_row], dim=0)
        out = big[src]
        c0 = 0
        for i, f in zip(idx, flats):
            k = f.shape[1]
            moved[i] = out[:, c0:c0 + k].reshape(
                (C, K) + tuple(arrays[i].shape[2:]))
            c0 += k
    out_fields = {n: moved[2 + j] for j, n in enumerate(names)}
    return out_fields, moved[0], moved[1], n_overflow


def global_positions(grid: CellGrid, off) -> np.ndarray:
    """(C, K, 3) f64 absolute positions (host-side; for I/O and checks)."""
    if isinstance(off, torch.Tensor):
        off = off.detach().cpu().numpy()
    corners = grid.cell_corners().reshape(grid.C, 1, 3)
    pos = corners + np.asarray(off, np.float64)
    return np.mod(pos, np.asarray(grid.box, np.float64))

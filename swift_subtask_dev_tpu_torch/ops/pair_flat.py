"""The flat (column/z-sorted) pair engine: CUDA kernel + plain torch version.

Port of the reference's ``ops/pallas_flat.py``.  The domain is a grid of
(x, y) columns (``CellGrid.build_columns``); particles are z-sorted inside
each column tile.  For every 128-slot i-tile of a column and each of its 9
neighbour columns, two packed range words (``s | c << 16``, unsigned 16-bit
fields, in granules of ``GRAN`` rows) name the j-rows whose z-range can
reach the tile: one run, or two when the window wraps the periodic box.
A pair body is evaluated on exactly those rows, and ``n_sum`` masked sums
and ``n_max`` masked maxes are reduced per i slot.  The pair mask is
``mask_j > 0 & r2 > 0 & ok_extra``.

Cross-species passes (``PairPass.fields_j``; the reference's ``fields_j``
/ ``field_order_j``) take the i slots from one species' tiles and the j
rows from another's, on the same column grid, in the same field order;
each species has its own per-column capacity (``W`` for the i side,
``Wj`` for the j side), and the range words are built over the j
species' blocks.

``_block_ranges`` (the range words) is plain torch and bit-identical to
the reference.  ``pair_apply`` runs the hand-written CUDA kernel
(``csrc/pair_flat.cu``) on CUDA tensors and ``pair_apply_plain`` on CPU
tensors; there is no other path.  Output conventions follow the reference
kernel: dead tiles (at or past ceil(count/128) of their column) read 0 in
every output, live tiles with no accepted pair read 0 (sums) / -inf (maxes).

The kernel evaluates a body only on the pairs it accepts: each warp keeps
the staged rows that some of its 32 slots may accept (a box around the
slots and the body's reach bounds, ``REACH2``), every lane tests the kept
rows with the body's predicate, and the warp then evaluates the body in
rounds of one accepted pair per lane, each lane in j-row order.  On
request the kernel returns per-warp statistics of its walk; their pair
counts equal the plain version's per-slot counts summed over the slots
each warp walks (``warp_pairs``).  ``walk_filter`` is the plain model of
the warp filter alone.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..grid.cellgrid import CellGrid
from ..models.sph import SCHEME_MODULES
from .cuda_build import KernelLibrary

F32 = torch.float32
I32 = torch.int32

# 9 (dx, dy) column offsets, self first (the kernel walks them in this
# order and the range words are laid out in it)
OFFSETS_9 = [(0, 0)] + [(dx, dy)
                        for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                        if not (dx == 0 and dy == 0)]
LANES = 128      # i-tile width (one CUDA thread per i slot)
GRAN = 16        # range-word granularity in j-rows
# the kernel's walk (csrc/pair_flat.cu; kernel_attributes() reads them back)
WARPS = LANES // 32
# per warp: rows staged, rows kept (accepted by some slot of the warp),
# rounds, accepted pairs; then clock64 cycles waiting for staged chunks, in
# rounds, in the representative empty slot's rows, and in the whole walk
WALK_STATS = ("staged", "kept", "rounds", "pairs", "wait_cycles",
              "round_cycles", "rep_cycles", "walk_cycles")
REACH_SLACK = 1.0001     # the warp filter's slack on r2 bounds ...
BOX_SLACK = 1e-5         # ... and on distances, x (boxz + ex + ey)
# plain version: pair evaluations per column chunk (bounds its memory)
_PLAIN_PAIRS = {"cpu": 1 << 20, "cuda": 1 << 24}

# launches of the CUDA kernel per body name; the kernel wrapper adds one
# per launch and nothing else touches it (reset with reset_launches)
LAUNCHES: Dict[str, int] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def body_key(body: "PairBody") -> str:
    """A body's name with its mode: ``force`` (SPHENIX, cubic spline) or
    ``force[minimal/wendland-C2]``."""
    return body.name + (f"[{body.mode}]" if body.mode else "")


def launch_name(body: "PairBody", launch: "PairLaunch") -> str:
    """The ``LAUNCHES`` key of a launch: ``body_key``, with ``_cross`` for
    a cross-species launch."""
    return body_key(body) + ("_cross" if launch.cross else "")


@dataclass(frozen=True)
class PairBody:
    """One pair body: its CUDA entry, field order and plain callback.

    ``fields`` is the order of the SoA/AoS field rows; it must match the
    body's field indices in ``csrc/pair_bodies.cuh``.  ``params`` are the
    body's float constants in the order of its ``P_*`` indices there.
    ``fn(sf, nf, dx, r2)`` returns (ok_extra, sums, maxes) on broadcast
    tensors, the protocol of the reference's pair callbacks.  ``mode``
    names the SPH scheme and smoothing kernel of an SPH body
    (``"<SPH:scheme>/<SPH:kernel>"``, whose entries are in that mode's
    library, ``mode_library``); "" for the default library (SPHENIX with
    the cubic spline, and every non-SPH body).
    """

    name: str
    fields: Tuple[str, ...]
    n_sum: int
    n_max: int
    params: Tuple[float, ...]
    fn: Callable
    mode: str = ""


@dataclass
class PairPass:
    """A body bound to the (Ncol, W) field tiles it runs over, with the
    reach of its range words."""

    body: PairBody
    fields: Dict[str, torch.Tensor]
    range_scale: float
    sym_range: bool = False
    reach_floor: float = 0.0
    # cross-species pass: the j side's (Ncol, Wj) tiles, same field names
    fields_j: Optional[Dict[str, torch.Tensor]] = None


@dataclass
class PairLaunch:
    """Everything the kernel and the plain version take (same contract)."""

    tcounts: torch.Tensor      # (Ncol,) i32 live i-tiles per column
    ranges: torch.Tensor       # (Ncol, TPC, 9, 2) i32 range words
    Xi: torch.Tensor           # (F, Ncol*W) f32, i-side SoA
    Xa: torch.Tensor           # (Ncol*Wj, F) f32, j-side AoS
    ncx: int
    ncy: int
    W: int                     # i-side column capacity
    ex: float
    ey: float
    boxz: float
    Wj: int                    # j-side column capacity (W for one species)
    cross: bool                # the j side is another species


def _column_geometry(grid: CellGrid):
    ncx, ncy, ncz = grid.cdim
    if ncz != 1:
        raise ValueError("flat engine needs a column grid (cdim z == 1)")
    return ncx, ncy, ncx * ncy


def _nbr_table(ncx: int, ncy: int) -> np.ndarray:
    ids = np.arange(ncx * ncy)
    ix, iy = ids // ncy, ids % ncy
    out = np.empty((ncx * ncy, 9), np.int32)
    for o, (dx, dy) in enumerate(OFFSETS_9):
        out[:, o] = ((ix + dx) % ncx) * ncy + (iy + dy) % ncy
    return out


def nbr_col_table(grid: CellGrid) -> np.ndarray:
    """(Ncol, 9) i32 linear ids of each column's 9 neighbours."""
    ncx, ncy, _ = _column_geometry(grid)
    return _nbr_table(ncx, ncy)


def _block_ranges(grid: CellGrid, maskf, zf, hf, gamma: float,
                  sym_range: bool, jb: int = GRAN,
                  reach_floor: float = 0.0, maskf_j=None, zf_j=None,
                  hf_j=None) -> torch.Tensor:
    """(Ncol, TPC, 9, 2) i32 packed j-row ranges: word 0 = s1|c1<<16,
    word 1 = s2|c2<<16, in units of ``jb`` rows.

    Columns are z-sorted, so the j-blocks whose z-interval overlaps an
    i-tile's reach-inflated z-range form a contiguous run of block ids, or
    two runs when the range wraps the periodic box.  With the j side's
    ``maskf_j``, ``zf_j`` and ``hf_j`` (a cross-species pass) the blocks
    are the j species' own (its capacity Wj, Wj / jb blocks); the i-tile
    extents stay the i side's.
    """
    dev = maskf.device
    ncx, ncy, Ncol = _column_geometry(grid)
    NI, W = maskf.shape
    TPC = W // LANES
    boxz = float(np.float32(grid.box[2]))
    inf = float("inf")
    live = maskf > 0
    if maskf_j is None:
        maskf_j, zf_j, hf_j = maskf, zf, hf
    live_j = maskf_j > 0
    NBLK = maskf_j.shape[1] // jb

    zi = torch.where(live, zf, inf).reshape(NI, TPC, LANES)
    iz_lo = torch.amin(zi, dim=2)                               # (NI,TPC)
    iz_hi = torch.amax(torch.where(torch.isfinite(zi), zi, -inf), dim=2)
    hmax_tile = torch.amax(
        torch.where(live, hf, 0.0).reshape(NI, TPC, LANES), dim=2)
    hmax_col = torch.amax(torch.where(live_j, hf_j, 0.0), dim=1)  # (Ncol,)

    zb = torch.where(live_j, zf_j, inf).reshape(Ncol, NBLK, jb)
    jb_lo = torch.amin(zb, dim=2)                              # (Ncol,NBLK)
    jb_hi = torch.amax(torch.where(torch.isfinite(zb), zb, -inf), dim=2)
    # empty blocks (trailing, z-sorted): never "below" an interval, and
    # excluded from the end count via jb_lo = +inf
    empty = ~torch.isfinite(jb_hi)
    jb_hi_e = torch.where(empty, inf, jb_hi)

    nbr = torch.as_tensor(nbr_col_table(grid), dtype=torch.int64,
                          device=dev)                          # (NI, 9)
    g32 = float(np.float32(gamma))
    if sym_range:
        reach = g32 * torch.maximum(hmax_tile[:, :, None],
                                    hmax_col[nbr][:, None, :])
    else:
        reach = (g32 * hmax_tile)[:, :, None].expand(NI, TPC, 9)
    if reach_floor > 0.0:
        # fused passes (hydro force + P2P gravity) cover both ranges
        reach = torch.clamp_min(reach, float(np.float32(reach_floor)))
    lo = iz_lo[:, :, None] - reach                             # (NI,TPC,9)
    hi = iz_hi[:, :, None] + reach

    jlo = jb_lo[nbr]                                           # (NI,9,NBLK)
    jhi = jb_hi_e[nbr]

    def range_of(a, b):
        """start = #blocks entirely below a, end = NBLK - #blocks entirely
        above b (prefix/suffix counts by z-sortedness)."""
        start = torch.sum(jhi[:, None] < a[..., None], dim=-1)
        end = NBLK - torch.sum(jlo[:, None] > b[..., None], dim=-1)
        return start.to(I32), torch.clamp_min(end - start, 0).to(I32)

    # Drifted particles may sit outside [0, boxz) until their next
    # rebucket (the drift does not wrap z), so the windows are not clamped
    # to the box: the first image is [lo, hi] and the second [lo, hi]
    # shifted by one box height wherever that can reach a j particle
    # (top / bot: the j side's z extremes, at least the box's).  For j
    # z in [0, boxz) the words are the reference's, bit for bit; the
    # reference clamps to the box and so misses the pairs of a particle
    # drifted across z = 0 or z = boxz.
    zj = torch.where(live_j, zf_j, inf)
    top = torch.clamp_min(torch.amax(torch.where(live_j, zf_j, -inf)),
                          boxz)
    bot = torch.clamp_max(torch.amin(zj), 0.0)
    wrap_lo = lo < top - boxz
    wrap_hi = hi > bot + boxz
    # range covers the box (or needs both shifted images)
    full = ((hi - lo) >= boxz) | (wrap_lo & wrap_hi)
    a1, b1 = lo, hi
    # second image (empty sentinel a2 > b2 yields count 0)
    a2 = torch.where(wrap_lo, lo + boxz,
                     torch.where(wrap_hi, lo - boxz, inf))
    b2 = torch.where(wrap_lo, hi + boxz,
                     torch.where(wrap_hi, hi - boxz, -inf))
    s1, c1 = range_of(a1, b1)
    s2, c2 = range_of(a2, b2)
    # a wide block can intersect both images: visit it once by clipping
    # range 2 out of range 1's index interval
    e1 = s1 + c1
    e2 = s2 + c2
    both = (c1 > 0) & (c2 > 0)
    s2 = torch.where(both & (s1 <= s2), torch.maximum(s2, e1), s2)
    e2 = torch.where(both & (s1 > s2), torch.minimum(e2, s1), e2)
    c2 = torch.clamp_min(e2 - s2, 0)
    s1 = torch.where(full, 0, s1)
    c1 = torch.where(full, NBLK, c1)
    c2 = torch.where(full, 0, c2)
    return torch.stack([(s1 | (c1 << 16)).to(I32),
                        (s2 | (c2 << 16)).to(I32)], dim=-1)


def prepare(grid: CellGrid, pp: PairPass,
            active_i: Optional[torch.Tensor] = None) -> PairLaunch:
    """Build the kernel's inputs for one pass: live-tile counts, range
    words (zeroed for i-tiles without an active particle), SoA/AoS fields.
    A cross-species pass (``pp.fields_j``) takes its AoS and its range
    words' blocks from the j species.
    """
    ncx, ncy, Ncol = _column_geometry(grid)
    f = pp.fields
    cross = pp.fields_j is not None
    fj = pp.fields_j if cross else f
    W = f["mask"].shape[1]
    Wj = fj["mask"].shape[1]
    if W % LANES:
        raise ValueError(f"i-side column capacity W={W} must be a "
                         f"multiple of {LANES}")
    if Wj % GRAN or Wj // GRAN > 65535:
        raise ValueError(f"j-side column capacity Wj={Wj} must be a "
                         f"multiple of {GRAN} with at most 65535 granules")
    TPC = W // LANES
    col_counts = torch.sum(f["mask"] > 0, dim=1).to(I32)
    tcounts = ((col_counts + (LANES - 1)) // LANES).to(I32)
    jside = ((fj["mask"], fj["off2"], fj["h"]) if cross
             else (None, None, None))
    ranges = _block_ranges(grid, f["mask"], f["off2"], f["h"],
                           pp.range_scale, pp.sym_range, jb=GRAN,
                           reach_floor=pp.reach_floor, maskf_j=jside[0],
                           zf_j=jside[1], hf_j=jside[2])
    if active_i is not None:
        tile_act = torch.any((active_i > 0).reshape(Ncol, TPC, LANES),
                             dim=2)
        ranges = torch.where(tile_act[:, :, None, None], ranges, 0)
    Xi = torch.stack([f[n].reshape(-1).to(F32) for n in pp.body.fields],
                     dim=0).contiguous()
    if cross:
        Xa = torch.stack([fj[n].reshape(-1).to(F32)
                          for n in pp.body.fields], dim=1).contiguous()
    else:
        Xa = Xi.t().contiguous()
    return PairLaunch(tcounts=tcounts.contiguous(),
                      ranges=ranges.to(I32).contiguous(), Xi=Xi, Xa=Xa,
                      ncx=ncx, ncy=ncy, W=W, ex=float(grid.edge[0]),
                      ey=float(grid.edge[1]), boxz=float(grid.box[2]),
                      Wj=Wj, cross=cross)


def _split(out: torch.Tensor, body: PairBody, Ncol: int, W: int):
    res = out.reshape(-1, Ncol, W)
    return ([res[q] for q in range(body.n_sum)],
            [res[body.n_sum + q] for q in range(body.n_max)])


def pair_apply(grid: CellGrid, pp: PairPass,
               active_i: Optional[torch.Tensor] = None):
    """Run ``pp.body`` over all pairs of the column/z-sorted layout.

    Returns (sums, maxes) as lists of (Ncol, W) tensors.  CUDA tensors go
    to the CUDA kernel, CPU tensors to the plain version.

    ``active_i`` ((Ncol, W) bool/0-1): i-tiles with no active particle get
    zeroed range words, so their outputs are 0 (sums) / -inf (maxes) and
    the caller merges previous values (the ghost's unconverged-subset
    re-runs).
    """
    launch = prepare(grid, pp, active_i)
    if launch.Xi.is_cuda:
        out = pair_apply_kernel(launch, pp.body)
    elif launch.Xi.device.type == "cpu":
        out = pair_apply_plain(launch, pp.body)
    else:
        raise RuntimeError(
            f"pair_apply: no path for device {launch.Xi.device}")
    return _split(out, pp.body, launch.ncx * launch.ncy, launch.W)


# ---------------------------------------------------------------------------
# Plain torch version (same contract as the kernel)
# ---------------------------------------------------------------------------

def pair_apply_plain(launch: PairLaunch, body: PairBody,
                     stats: Optional[Dict] = None) -> torch.Tensor:
    """(n_sum + n_max, Ncol*W) outputs of ``body`` evaluated densely over
    every (i slot, j row) of each live tile's 9 neighbour columns, masked
    to the rows the range words name.  Rows at or past the fullest j
    column's live count are left out: every column's live particles fill
    a prefix of its slots (checked here on the j side, the i species' or
    another's; a violation raises), so those rows are empty.  Chunked
    over columns to bound memory.

    ``stats``, when given, receives ``"pairs"``: the accepted pairs whose i
    slot is live (the work the pass needs, for a roofline bound), and
    ``"slot_pairs"``: (Ncol*W,) int64, the accepted pairs of every i slot
    of a live tile, empty ones included."""
    L = launch
    dev = L.Xi.device
    Ncol, W = L.ncx * L.ncy, L.W
    F = len(body.fields)
    fidx = {n: i for i, n in enumerate(body.fields)}
    n_out = body.n_sum + body.n_max
    nbr = torch.as_tensor(_nbr_table(L.ncx, L.ncy), dtype=torch.int64,
                          device=dev)
    live_j = L.Xa.reshape(Ncol, L.Wj, F)[..., fidx["mask"]] > 0
    counts = torch.sum(live_j, dim=1)
    rows = torch.arange(L.Wj, device=dev, dtype=I32)
    if bool(torch.any(live_j & (rows[None, :] >= counts[:, None]))):
        raise ValueError("pair_apply_plain: a live slot lies past its "
                         "column's count (columns must be front-packed)")
    Wj = int(counts.max()) if Ncol else 0
    TPC = int(L.tcounts.max()) if Ncol else 0     # live tiles of any column
    out = torch.zeros((n_out, Ncol, W // LANES, LANES), dtype=F32,
                      device=dev)
    slot_pairs = torch.zeros((Ncol, W // LANES, LANES), dtype=torch.int64,
                             device=dev)
    if Wj == 0 or TPC == 0:
        if stats is not None:
            stats["pairs"] = 0
            stats["slot_pairs"] = slot_pairs.reshape(Ncol * W)
        return out.reshape(n_out, Ncol * W)
    xi_all = L.Xi.reshape(F, Ncol, W // LANES, LANES, 1)[:, :, :TPC]
    xa_all = L.Xa.reshape(Ncol, L.Wj, F)[:, :Wj]
    rows = rows[:Wj]
    inv_boxz = 1.0 / L.boxz
    nc = max(1, _PLAIN_PAIRS.get(dev.type, 1 << 20) // (TPC * LANES * Wj))

    for c0 in range(0, Ncol, nc):
        cols = slice(c0, min(c0 + nc, Ncol))
        xi = xi_all[:, cols]                        # (F, n, TPC, 128, 1)

        def sf(name):
            return xi[fidx[name]]

        n = xi.shape[1]
        acc = [torch.zeros((n, TPC, LANES), dtype=F32, device=dev)
               for _ in range(body.n_sum)]
        mx = [torch.full((n, TPC, LANES), float("-inf"), dtype=F32,
                         device=dev) for _ in range(body.n_max)]
        for o, (dx, dy) in enumerate(OFFSETS_9):
            xj = xa_all[nbr[cols, o]]               # (n, Wj, F)

            def nf(name):
                return xj[:, None, None, :, fidx[name]]  # (n,1,1,Wj)

            w = L.ranges[cols, :TPC, o, :]          # (n, TPC, 2)
            s = (w & 0xFFFF) * GRAN
            e = s + ((w >> 16) & 0xFFFF) * GRAN
            r = rows[None, None, :]
            row_ok = (((r >= s[..., 0:1]) & (r < e[..., 0:1]))
                      | ((r >= s[..., 1:2]) & (r < e[..., 1:2])))
            sx = float(np.float32(dx * L.ex))
            sy = float(np.float32(dy * L.ey))
            dz = sf("off2") - nf("off2")
            dz = dz - L.boxz * torch.round(dz * inv_boxz)
            dxv = (sf("off0") - (nf("off0") + sx),
                   sf("off1") - (nf("off1") + sy),
                   dz)
            r2 = dxv[0] * dxv[0] + dxv[1] * dxv[1] + dxv[2] * dxv[2]
            ok_extra, sums, maxes = body.fn(sf, nf, dxv, r2)
            ok = ((nf("mask") > 0) & (r2 > 0) & ok_extra
                  & row_ok[:, :, None, :])
            if stats is not None:
                slot_pairs[cols, :TPC] += torch.sum(ok, dim=-1)
            for q, val in enumerate(sums):
                acc[q] = acc[q] + torch.sum(torch.where(ok, val, 0.0),
                                            dim=-1)
            for q, val in enumerate(maxes):
                mx[q] = torch.maximum(mx[q], torch.amax(
                    torch.where(ok, val, float("-inf")), dim=-1))
        for q in range(body.n_sum):
            out[q, cols, :TPC] = acc[q]
        for q in range(body.n_max):
            out[body.n_sum + q, cols, :TPC] = mx[q]
    live = (torch.arange(W // LANES, device=dev)[None, :]
            < L.tcounts[:, None].to(torch.int64))
    out = torch.where(live[None, :, :, None], out, 0.0)
    if stats is not None:
        slot_pairs = torch.where(live[:, :, None], slot_pairs, 0)
        live_i = L.Xi[fidx["mask"]].reshape(slot_pairs.shape) > 0
        stats["pairs"] = int(torch.sum(torch.where(live_i, slot_pairs, 0)))
        stats["slot_pairs"] = slot_pairs.reshape(Ncol * W)
    return out.reshape(n_out, Ncol * W)


# ---------------------------------------------------------------------------
# The kernel's walk: reach bounds, walked slots, and a model of its filter
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    return float(np.float32(x))


def _gh2(g2: float, h):
    return g2 * h * h


# (lane part, row part) of a bound on the r2 each body's predicate accepts,
# as ``lane_reach2`` / ``row_reach2`` in csrc/pair_bodies.cuh and
# csrc/probe_bodies.cuh: no pair with r2 above max(lane part of any slot
# of a warp, row part of the j row) is accepted, and no pair at all with a
# j row whose row part is negative.  Each entry maps (params, sf, nf) to
# the two parts (sf, nf: field accessors of the i slots and j rows).
REACH2: Dict[str, Callable] = {
    "density": lambda p, sf, nf: (_gh2(_f32(p[0]), sf("h")), 0.0),
    "gradient": lambda p, sf, nf: (_gh2(_f32(p[0]), sf("h")), 0.0),
    "force": lambda p, sf, nf: (_gh2(_f32(p[0]), sf("h")),
                                _gh2(_f32(p[0]), nf("h"))),
    "force_gravity": lambda p, sf, nf: (
        _gh2(_f32(p[0]), sf("h")),
        torch.clamp_min(_gh2(_f32(p[0]), nf("h")), _f32(p[6]))),
    "p2p_gravity": lambda p, sf, nf: (0.0, _f32(p[0])),
    "timebin": lambda p, sf, nf: (0.0, torch.where(
        (nf("act") > 0) & (nf("tb") > 0), _gh2(_f32(p[0]), nf("h")),
        -1.0)),
    "chem_smooth": lambda p, sf, nf: (_gh2(_f32(p[0]), sf("h")), 0.0),
    "probe_a00": lambda p, sf, nf: (float("inf"), 0.0),
    **{name: (lambda p, sf, nf: (_f32(0.0036), 0.0))
       for name in ("probe_a", "probe_b", "probe_c", "probe_d", "probe_e")},
}


def walked_slots(launch: PairLaunch, mask_field: int) -> torch.Tensor:
    """(Ncol, TPC, WARPS, 32) bool: the i slots the kernel walks itself.
    A tile's empty slots whose fields are bit-identical to its first empty
    slot (the representative) are not walked: the kernel evaluates that
    one apart and copies its outputs to them.  ``mask_field``: the index
    of the mask among the body's fields."""
    L = launch
    F, Ncol, W = L.Xi.shape[0], L.ncx * L.ncy, L.W
    bits = L.Xi.reshape(F, Ncol, W // LANES, LANES).view(torch.int32)
    empty = ~(L.Xi[mask_field].reshape(Ncol, W // LANES, LANES) > 0)
    first = torch.argmax(empty.to(torch.int8), dim=-1)     # (Ncol, TPC)
    rep = torch.gather(bits, -1, first[None, :, :, None].expand(
        F, -1, -1, 1))
    copy = empty & torch.all(bits == rep, dim=0)
    return ~copy.reshape(Ncol, W // LANES, WARPS, 32)


def warp_pairs(launch: PairLaunch, body: PairBody,
               slot_pairs: torch.Tensor) -> torch.Tensor:
    """(Ncol, TPC, WARPS) int64: the pairs each warp of the kernel
    evaluates (its walk statistics' ``"pairs"``), from the plain version's
    per-slot counts (``pair_apply_plain``'s ``"slot_pairs"``) over the
    slots it walks."""
    walked = walked_slots(launch, body.fields.index("mask"))
    return torch.sum(torch.where(walked, slot_pairs.reshape(walked.shape),
                                 0), dim=-1)


def walk_filter(launch: PairLaunch, body: PairBody) -> Dict:
    """Plain model of the kernel's warp filter.  Per warp (Ncol, TPC,
    WARPS) int64 ``"staged"``: the rows of its tile's spans; ``"passed"``:
    those the filter lets through (a live row within the body's reach
    bounds, ``REACH2``, of the box around the warp's walked slots, z
    periodic, with the kernel's slack); and ``"dropped"``: the pairs of
    walked slots that the body accepts on rows the filter rejects (0 for
    a conservative filter).  Dead tiles read 0."""
    L = launch
    dev = L.Xi.device
    Ncol, W = L.ncx * L.ncy, L.W
    TPC = W // LANES
    F = len(body.fields)
    fidx = {n: i for i, n in enumerate(body.fields)}
    nbr = torch.as_tensor(_nbr_table(L.ncx, L.ncy), dtype=torch.int64,
                          device=dev)
    live_t = (torch.arange(TPC, device=dev)[None, :]
              < L.tcounts[:, None].to(torch.int64))       # (Ncol, TPC)
    own_all = walked_slots(L, fidx["mask"])
    f32 = np.float32
    slack = float(f32(BOX_SLACK) * (f32(L.boxz) + f32(L.ex) + f32(L.ey)))
    inv_boxz = 1.0 / L.boxz
    rows = torch.arange(L.Wj, device=dev)
    xi_all = L.Xi.reshape(F, Ncol, TPC, WARPS, 32)
    xa_all = L.Xa.reshape(Ncol, L.Wj, F)
    w = L.ranges.to(torch.int64)                   # (Ncol, TPC, 9, 2)
    start = (w & 0xFFFF) * GRAN
    end = start + ((w >> 16) & 0xFFFF) * GRAN
    staged = torch.where(live_t, torch.sum(end - start, dim=(-2, -1)), 0)
    passed = torch.zeros((Ncol, TPC, WARPS), dtype=torch.int64, device=dev)
    dropped = 0
    nc = max(1, _PLAIN_PAIRS.get(dev.type, 1 << 20) // 4
             // (LANES * TPC * L.Wj))
    for c0 in range(0, Ncol, nc):
        cols = slice(c0, min(c0 + nc, Ncol))
        xi = xi_all[:, cols, :, :, :, None]        # (F, n, TPC, WARPS, 32, 1)
        own = own_all[cols]                         # (n, TPC, WARPS, 32)

        def sf(name):
            return xi[fidx[name]]

        def lo_hi(name):
            v = sf(name)[..., 0]
            return (torch.amin(torch.where(own, v, float("inf")), dim=-1),
                    torch.amax(torch.where(own, v, float("-inf")), dim=-1))

        box = []
        for name in ("off0", "off1", "off2"):
            lo, hi = lo_hi(name)
            box.append((0.5 * (lo + hi)[..., None],
                        (0.5 * (hi - lo) + slack)[..., None]))
        lane_r2, _ = REACH2[body.name](
            body.params, sf, lambda name: torch.zeros((), device=dev))
        lane_r2 = torch.as_tensor(lane_r2, dtype=F32, device=dev)
        lr2 = torch.amax(torch.where(own, lane_r2.expand(xi.shape[1:])[..., 0],
                                     float("-inf")), dim=-1)[..., None]
        any_own = torch.any(own, dim=-1)[..., None]  # (n, TPC, WARPS, 1)
        for o, (dx, dy) in enumerate(OFFSETS_9):
            xj = xa_all[nbr[cols, o]]              # (n, Wj, F)

            def nf(name):
                return xj[:, None, None, None, :, fidx[name]]

            def nb(name):
                return nf(name)[..., 0, :]         # (n, 1, 1, Wj)

            sx = float(np.float32(dx * L.ex))
            sy = float(np.float32(dy * L.ey))
            bz = box[2][0] - nb("off2")
            bz = bz - L.boxz * torch.round(bz * inv_boxz)
            bz = torch.clamp_min(torch.abs(bz) - box[2][1], 0.0)
            bx = torch.clamp_min(torch.abs(box[0][0] - (nb("off0") + sx))
                                 - box[0][1], 0.0)
            by = torch.clamp_min(torch.abs(box[1][0] - (nb("off1") + sy))
                                 - box[1][1], 0.0)
            _, row_r2 = REACH2[body.name](body.params, sf, nb)
            row_r2 = torch.as_tensor(row_r2, dtype=F32, device=dev)
            keep = (any_own & (nb("mask") > 0) & (row_r2 >= 0)
                    & (bx * bx + by * by + bz * bz
                       <= torch.maximum(row_r2, lr2) * REACH_SLACK))
            dz = sf("off2") - nf("off2")
            dz = dz - L.boxz * torch.round(dz * inv_boxz)
            dxv = (sf("off0") - (nf("off0") + sx),
                   sf("off1") - (nf("off1") + sy), dz)
            r2 = dxv[0] * dxv[0] + dxv[1] * dxv[1] + dxv[2] * dxv[2]
            ok_extra, _, _ = body.fn(sf, nf, dxv, r2)
            ok = ((nf("mask") > 0) & (r2 > 0) & ok_extra
                  & own[..., None])                   # (n,TPC,WARPS,32,W)
            s_, e_ = start[cols, :, o, :, None], end[cols, :, o, :, None]
            span = torch.any((rows >= s_) & (rows < e_), dim=-2)
            span = (span & live_t[cols][..., None])[:, :, None, :]
            passed[cols] += torch.sum(keep & span, dim=-1)
            dropped += int(torch.sum(ok & (span & ~keep)[..., None, :]))
    return {"staged": staged[..., None].expand(-1, -1, WARPS),
            "passed": passed, "dropped": dropped}


def walk_summary(stats: torch.Tensor,
                 names: Tuple[str, ...] = WALK_STATS) -> Dict[str, float]:
    """Totals of a kernel's per-warp walk statistics ``names`` and the
    lane utilisation (accepted pairs over 32 lanes x rounds)."""
    n = stats.shape[-1]
    tot = {k: int(v) for k, v in zip(
        names, stats.reshape(-1, n).sum(0).tolist())}
    tot["utilisation"] = tot["pairs"] / max(32 * tot["rounds"], 1)
    return tot


# ---------------------------------------------------------------------------
# CUDA kernel: build (nvcc, at first use), bind (ctypes), launch
# ---------------------------------------------------------------------------

BODY_NAMES = ("density", "gradient", "force", "force_gravity", "p2p_gravity",
              "timebin", "chem_smooth")
# the cost probe's synthetic bodies (csrc/probe_bodies.cuh,
# probes/probe_kernel.py)
PROBE_BODY_NAMES = ("probe_a00", "probe_a", "probe_b", "probe_c", "probe_d",
                    "probe_e")
SOURCES = ("pair_flat.cu", "pair_bodies.cuh", "probe_bodies.cuh",
           "walk.cuh")
# SPH:scheme and SPH:kernel names -> their structs in csrc/pair_bodies.cuh
SCHEME_STRUCTS = {n: m.CUDA_STRUCT for n, m in SCHEME_MODULES.items()}
KERNEL_STRUCTS = {"cubic-spline": "CubicSpline",
                  "quartic-spline": "QuarticSpline",
                  "quintic-spline": "QuinticSpline",
                  "wendland-C2": "WendlandC2", "wendland-C4": "WendlandC4",
                  "wendland-C6": "WendlandC6"}


def _binder(names):
    def bind(lib: ctypes.CDLL) -> None:
        for name in names:
            fn = getattr(lib, f"pair_flat_{name}")
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_float] * 4
                           + [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            attr = getattr(lib, f"pair_flat_{name}_attributes")
            attr.argtypes = [ctypes.POINTER(ctypes.c_int)]
            attr.restype = ctypes.c_int
    return bind


LIBRARY = KernelLibrary("pair_flat", SOURCES,
                        _binder(BODY_NAMES + PROBE_BODY_NAMES))
# mode libraries by their nvcc flags: two modes with the same scheme
# struct and kernel (Planetary's and Minimal's) share one
_MODE_LIBRARIES: Dict[Tuple[str, ...], KernelLibrary] = {}


def mode_body_names(mode: str) -> Tuple[str, ...]:
    """The entries of a mode's library: its scheme's SPH bodies."""
    mod = SCHEME_MODULES[mode.split("/")[0]]
    grad = ("gradient",) if mod.HAS_GRADIENT_LOOP else ()
    return ("density",) + grad + ("force", "force_gravity")


def mode_library(mode: str) -> KernelLibrary:
    """The library of an SPH mode ``"<scheme>/<kernel>"`` (``""``: the
    default ``LIBRARY``): csrc/pair_flat.cu built with that scheme's and
    kernel's structs, holding ``mode_body_names(mode)``.  Modes whose
    scheme struct, kernel and gradient flag agree share their library."""
    if not mode:
        return LIBRARY
    scheme, kernel = mode.split("/")
    if scheme not in SCHEME_STRUCTS or kernel not in KERNEL_STRUCTS:
        raise ValueError(f"no flat kernel mode {mode!r} (schemes "
                         f"{list(SCHEME_STRUCTS)}, kernels "
                         f"{list(KERNEL_STRUCTS)})")
    struct = SCHEME_STRUCTS[scheme]
    grad = int(SCHEME_MODULES[scheme].HAS_GRADIENT_LOOP)
    flags = (f"-DSPH_SCHEME={struct}",
             f"-DSPH_KERNEL={KERNEL_STRUCTS[kernel]}",
             f"-DSPH_GRADIENT={grad}")
    lib = _MODE_LIBRARIES.get(flags)
    if lib is None:
        lib = KernelLibrary(
            f"pair_flat_{struct}_{KERNEL_STRUCTS[kernel]}", SOURCES,
            _binder(mode_body_names(mode)), flags=flags)
        _MODE_LIBRARIES[flags] = lib
    return lib


def all_modes() -> Tuple[str, ...]:
    """Every SPH mode but the default: each scheme under each kernel."""
    return tuple(f"{s}/{k}" for s in SCHEME_STRUCTS for k in KERNEL_STRUCTS
                 if (s, k) != ("sphenix", "cubic-spline"))


def mode_libraries() -> List[KernelLibrary]:
    """The distinct libraries of ``all_modes()``, one per scheme struct
    and kernel."""
    return list({id(lib): lib for lib in map(mode_library, all_modes())}
                .values())


ATTRIBUTES = ("registers", "local_bytes", "static_smem", "dynamic_smem",
              "blocks_per_sm", "fields", "window", "chunk_rows", "stages",
              "warps", "n_stats")


def kernel_attributes(name: str, mode: str = "") -> Dict[str, int]:
    """The compiled kernel of body ``name`` (in ``mode``'s library):
    registers per thread, local memory bytes per thread (spills), static
    and dynamic shared memory per block, resident blocks per SM, and its
    walk's constants (needs the card).  Raises if its statistics are not
    laid out as ``WALK_STATS`` per warp."""
    res = (ctypes.c_int * len(ATTRIBUTES))()
    err = getattr(mode_library(mode).load(),
                  f"pair_flat_{name}_attributes")(res)
    if err != 0:
        raise RuntimeError(f"pair_flat_{name}_attributes: CUDA error {err}")
    a = dict(zip(ATTRIBUTES, res))
    if (a["warps"], a["n_stats"]) != (WARPS, len(WALK_STATS)):
        raise RuntimeError(f"pair_flat_{name}: the kernel's statistics "
                           f"{a} are not laid out as WALK_STATS per warp")
    return a


def pair_apply_kernel(launch: PairLaunch, body: PairBody,
                      stats: Optional[Dict] = None) -> torch.Tensor:
    """Launch the CUDA kernel of ``body`` on PyTorch's current stream
    (a cross-species launch reads its j rows from the j species' AoS,
    ``Wj`` rows a column).

    Returns (n_sum + n_max, Ncol*W).  ``stats``, when given, receives
    ``"walk"``: the (Ncol, TPC, WARPS, 8) i32 per-warp statistics of
    ``WALK_STATS`` (0 for dead tiles).  Raises on anything the kernel does
    not take and on a launch error."""
    L = launch
    F = len(body.fields)
    Ncol, W = L.ncx * L.ncy, L.W
    dev = L.Xi.device
    for name, t, dt in (("tcounts", L.tcounts, I32),
                        ("ranges", L.ranges, I32), ("Xi", L.Xi, F32),
                        ("Xa", L.Xa, F32)):
        if not t.is_cuda or t.device != dev or t.dtype != dt \
                or not t.is_contiguous():
            raise ValueError(f"pair_apply_kernel: {name} must be a "
                             f"contiguous {dt} tensor on {dev}")
    if tuple(L.Xi.shape) != (F, Ncol * W) or tuple(L.Xa.shape) != (
            Ncol * L.Wj, F) or tuple(L.ranges.shape) != (Ncol, W // LANES,
                                                         9, 2):
        raise ValueError("pair_apply_kernel: inconsistent shapes")
    if W % LANES or L.Wj % GRAN or L.Wj // GRAN > 65535:
        raise ValueError(f"pair_apply_kernel: capacities W={W}, "
                         f"Wj={L.Wj} out of the kernel's range")
    if Ncol > 65535:
        raise ValueError(f"pair_apply_kernel: {Ncol} columns > 65535")
    if L.Xa.data_ptr() % 16:
        raise ValueError("pair_apply_kernel: Xa must be 16-byte aligned "
                         "(bulk copies)")
    fn = getattr(mode_library(body.mode).load(), f"pair_flat_{body.name}")
    out = torch.zeros((body.n_sum + body.n_max, Ncol * W), dtype=F32,
                      device=dev)
    walk = None
    if stats is not None:
        walk = torch.zeros((Ncol, W // LANES, WARPS, len(WALK_STATS)),
                           dtype=I32, device=dev)
    prm = (ctypes.c_float * max(1, len(body.params)))(*body.params)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(L.tcounts.data_ptr(), L.ranges.data_ptr(), L.Xi.data_ptr(),
             L.Xa.data_ptr(), out.data_ptr(),
             None if walk is None else walk.data_ptr(), L.ncx, L.ncy, W,
             L.Wj, GRAN, F, L.ex, L.ey, L.boxz, 1.0 / L.boxz, prm,
             len(body.params), stream)
    if err != 0:
        raise RuntimeError(f"pair_flat_{body_key(body)}: CUDA error {err}")
    key = launch_name(body, L)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    if walk is not None:
        stats["walk"] = walk
    return out

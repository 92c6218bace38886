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

``_block_ranges`` (the range words) is plain torch and bit-identical to
the reference.  ``pair_apply`` runs the hand-written CUDA kernel
(``csrc/pair_flat.cu``) on CUDA tensors and ``pair_apply_plain`` on CPU
tensors; there is no other path.  Output conventions follow the reference
kernel: dead tiles (at or past ceil(count/128) of their column) read 0 in
every output, live tiles with no accepted pair read 0 (sums) / -inf (maxes).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..grid.cellgrid import CellGrid
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
# plain version: pair evaluations per column chunk (bounds its memory)
_PLAIN_PAIRS = {"cpu": 1 << 20, "cuda": 1 << 24}

# launches of the CUDA kernel per body name; the kernel wrapper adds one
# per launch and nothing else touches it (reset with reset_launches)
LAUNCHES: Dict[str, int] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


@dataclass(frozen=True)
class PairBody:
    """One pair body: its CUDA entry, field order and plain callback.

    ``fields`` is the order of the SoA/AoS field rows; it must match the
    body's field indices in ``csrc/pair_bodies.cuh``.  ``params`` are the
    body's float constants in the order of its ``P_*`` indices there.
    ``fn(sf, nf, dx, r2)`` returns (ok_extra, sums, maxes) on broadcast
    tensors, the protocol of the reference's pair callbacks.
    """

    name: str
    fields: Tuple[str, ...]
    n_sum: int
    n_max: int
    params: Tuple[float, ...]
    fn: Callable


@dataclass
class PairPass:
    """A body bound to the (Ncol, W) field tiles it runs over, with the
    reach of its range words."""

    body: PairBody
    fields: Dict[str, torch.Tensor]
    range_scale: float
    sym_range: bool = False
    reach_floor: float = 0.0


@dataclass
class PairLaunch:
    """Everything the kernel and the plain version take (same contract)."""

    tcounts: torch.Tensor      # (Ncol,) i32 live i-tiles per column
    ranges: torch.Tensor       # (Ncol, TPC, 9, 2) i32 range words
    Xi: torch.Tensor           # (F, Ncol*W) f32, i-side SoA
    Xa: torch.Tensor           # (Ncol*W, F) f32, j-side AoS
    ncx: int
    ncy: int
    W: int
    ex: float
    ey: float
    boxz: float


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
                  reach_floor: float = 0.0) -> torch.Tensor:
    """(Ncol, TPC, 9, 2) i32 packed j-row ranges: word 0 = s1|c1<<16,
    word 1 = s2|c2<<16, in units of ``jb`` rows.

    Columns are z-sorted, so the j-blocks whose z-interval overlaps an
    i-tile's reach-inflated z-range form a contiguous run of block ids, or
    two runs when the range wraps the periodic box.
    """
    dev = maskf.device
    ncx, ncy, Ncol = _column_geometry(grid)
    NI, W = maskf.shape
    TPC = W // LANES
    boxz = float(np.float32(grid.box[2]))
    inf = float("inf")
    live = maskf > 0
    NBLK = W // jb

    zi = torch.where(live, zf, inf).reshape(NI, TPC, LANES)
    iz_lo = torch.amin(zi, dim=2)                               # (NI,TPC)
    iz_hi = torch.amax(torch.where(torch.isfinite(zi), zi, -inf), dim=2)
    hmax_tile = torch.amax(
        torch.where(live, hf, 0.0).reshape(NI, TPC, LANES), dim=2)
    hmax_col = torch.amax(torch.where(live, hf, 0.0), dim=1)   # (Ncol,)

    zb = torch.where(live, zf, inf).reshape(Ncol, NBLK, jb)
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

    wrap_lo = lo < 0.0
    wrap_hi = hi > boxz
    full = (hi - lo) >= boxz                    # range covers the box
    a1 = torch.where(wrap_lo, 0.0, lo)
    b1 = torch.where(wrap_hi, boxz, hi)
    # second image (empty sentinel a2 > b2 yields count 0)
    a2 = torch.where(wrap_lo, lo + boxz,
                     torch.where(wrap_hi, 0.0, boxz + 1.0))
    b2 = torch.where(wrap_lo, boxz,
                     torch.where(wrap_hi, hi - boxz, -1.0))
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
    """
    ncx, ncy, Ncol = _column_geometry(grid)
    f = pp.fields
    W = f["mask"].shape[1]
    if W % LANES or W % GRAN or W // GRAN > 65535:
        raise ValueError(f"column capacity W={W} must be a multiple of "
                         f"{LANES} with at most 65535 granules")
    TPC = W // LANES
    col_counts = torch.sum(f["mask"] > 0, dim=1).to(I32)
    tcounts = ((col_counts + (LANES - 1)) // LANES).to(I32)
    ranges = _block_ranges(grid, f["mask"], f["off2"], f["h"],
                           pp.range_scale, pp.sym_range, jb=GRAN,
                           reach_floor=pp.reach_floor)
    if active_i is not None:
        tile_act = torch.any((active_i > 0).reshape(Ncol, TPC, LANES),
                             dim=2)
        ranges = torch.where(tile_act[:, :, None, None], ranges, 0)
    Xi = torch.stack([f[n].reshape(-1).to(F32) for n in pp.body.fields],
                     dim=0).contiguous()
    Xa = Xi.t().contiguous()
    return PairLaunch(tcounts=tcounts.contiguous(),
                      ranges=ranges.to(I32).contiguous(), Xi=Xi, Xa=Xa,
                      ncx=ncx, ncy=ncy, W=W, ex=float(grid.edge[0]),
                      ey=float(grid.edge[1]), boxz=float(grid.box[2]))


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
    to the rows the range words name.  Rows at or past the fullest
    column's live count are left out: every column's live particles fill
    a prefix of its slots (checked here; a violation raises), so those
    rows are empty.  Chunked over columns to bound memory.

    ``stats``, when given, receives ``"pairs"``: the accepted pairs whose i
    slot is live (the work the pass needs, for a roofline bound)."""
    L = launch
    dev = L.Xi.device
    Ncol, W = L.ncx * L.ncy, L.W
    F = len(body.fields)
    fidx = {n: i for i, n in enumerate(body.fields)}
    n_out = body.n_sum + body.n_max
    nbr = torch.as_tensor(_nbr_table(L.ncx, L.ncy), dtype=torch.int64,
                          device=dev)
    live_j = L.Xa.reshape(Ncol, W, F)[..., fidx["mask"]] > 0
    counts = torch.sum(live_j, dim=1)
    rows = torch.arange(W, device=dev, dtype=I32)
    if bool(torch.any(live_j & (rows[None, :] >= counts[:, None]))):
        raise ValueError("pair_apply_plain: a live slot lies past its "
                         "column's count (columns must be front-packed)")
    Wj = int(counts.max()) if Ncol else 0
    TPC = int(L.tcounts.max()) if Ncol else 0     # live tiles of any column
    out = torch.zeros((n_out, Ncol, W // LANES, LANES), dtype=F32,
                      device=dev)
    if Wj == 0 or TPC == 0:
        if stats is not None:
            stats["pairs"] = 0
        return out.reshape(n_out, Ncol * W)
    xi_all = L.Xi.reshape(F, Ncol, W // LANES, LANES, 1)[:, :, :TPC]
    xa_all = L.Xa.reshape(Ncol, W, F)[:, :Wj]
    rows = rows[:Wj]
    inv_boxz = 1.0 / L.boxz
    nc = max(1, _PLAIN_PAIRS.get(dev.type, 1 << 20) // (TPC * LANES * Wj))
    n_pairs = torch.zeros((), dtype=torch.int64, device=dev)

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
                n_pairs += torch.sum(ok & (sf("mask") > 0))
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
        stats["pairs"] = int(n_pairs)
    return out.reshape(n_out, Ncol * W)


# ---------------------------------------------------------------------------
# CUDA kernel: build (nvcc, at first use), bind (ctypes), launch
# ---------------------------------------------------------------------------

BODY_NAMES = ("density", "gradient", "force", "force_gravity", "p2p_gravity",
              "timebin")
# the cost probe's synthetic bodies (csrc/probe_bodies.cuh,
# probes/probe_kernel.py)
PROBE_BODY_NAMES = ("probe_a00", "probe_a", "probe_b", "probe_c", "probe_d",
                    "probe_e")


def _bind(lib: ctypes.CDLL) -> None:
    for name in BODY_NAMES + PROBE_BODY_NAMES:
        fn = getattr(lib, f"pair_flat_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 4
                       + [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("pair_flat", ("pair_flat.cu", "pair_bodies.cuh",
                                     "probe_bodies.cuh"), _bind)


def pair_apply_kernel(launch: PairLaunch, body: PairBody) -> torch.Tensor:
    """Launch the CUDA kernel of ``body`` on PyTorch's current stream.

    Returns (n_sum + n_max, Ncol*W).  Raises on anything the kernel does
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
            Ncol * W, F) or tuple(L.ranges.shape) != (Ncol, W // LANES,
                                                      9, 2):
        raise ValueError("pair_apply_kernel: inconsistent shapes")
    if Ncol > 65535:
        raise ValueError(f"pair_apply_kernel: {Ncol} columns > 65535")
    fn = getattr(LIBRARY.load(), f"pair_flat_{body.name}")
    out = torch.zeros((body.n_sum + body.n_max, Ncol * W), dtype=F32,
                      device=dev)
    prm = (ctypes.c_float * max(1, len(body.params)))(*body.params)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(L.tcounts.data_ptr(), L.ranges.data_ptr(), L.Xi.data_ptr(),
             L.Xa.data_ptr(), out.data_ptr(), L.ncx, L.ncy, W, GRAN, F,
             L.ex, L.ey, L.boxz, 1.0 / L.boxz, prm, len(body.params),
             stream)
    if err != 0:
        raise RuntimeError(f"pair_flat_{body.name}: CUDA error {err}")
    LAUNCHES[body.name] = LAUNCHES.get(body.name, 0) + 1
    return out

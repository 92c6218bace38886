"""The walk the two 27-cell pair kernels share (``csrc/walk27.cuh``).

The packed engine (``pair_packed``, K2) and the ring-buffer engine
(``pair_ring``, K3) differ only in the order of the 27 stencil offsets
and in how the separation rounds; everything else is here: what a launch
takes (:class:`Launch27`), the packing of the walked i slots into warps
and blocks (:func:`warp_table`), the plain torch version of the walk
(:func:`pair_apply_plain`), the kernel's ctypes binding and launch, and
CPU models of the kernel's walk (:func:`warp_pairs`, :func:`walk_filter`).

Contract (both engines, kernel and plain version): for every walked i
slot of a cell (live, and active when the caller passes ``active_i``)
and each stencil cell in the engine's order, the body runs on the rows
[0, count_j) of that cell in ``Xa``, each cell's live rows in slot order;
a walked slot with no accepted pair reads 0 (sums) / -inf (maxes), every
other slot 0 in every output.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..grid.cellgrid import CellGrid
from .cuda_build import KernelLibrary
from .pair_flat import (BOX_SLACK, REACH2, REACH_SLACK, PairBody,
                        walk_summary as _walk_summary)

F32 = torch.float32
I32 = torch.int32
WARP = 32
MAX_WARPS = 4    # i-slot warps per block at most (csrc/walk27.cuh)
# per warp: rows staged, rows kept (accepted by some slot of the warp),
# rounds, accepted pairs; then clock64 cycles waiting for staged chunks, in
# rounds, and in the whole walk
WALK_STATS = ("staged", "kept", "rounds", "pairs", "wait_cycles",
              "round_cycles", "walk_cycles")
ATTRIBUTES = ("registers", "local_bytes", "static_smem", "dynamic_smem",
              "blocks_per_sm", "fields", "window", "chunk_rows", "stages",
              "max_warps", "n_stats")
# plain version: pair evaluations per cell chunk (bounds its memory)
_PLAIN_PAIRS = {"cpu": 1 << 21, "cuda": 1 << 24}

# a separation rule: (off_i, off_j, shift) -> the f32 separation
Separation = Callable[[torch.Tensor, torch.Tensor, object], torch.Tensor]


@dataclass
class Launch27:
    """Everything the kernel and the plain version take (same contract)."""

    counts: torch.Tensor       # (C,) i32 live rows of each cell in Xa
    Xi: torch.Tensor           # (F, C*K) f32, i-side SoA at the slots
    Xa: torch.Tensor           # (C*KJ, F) f32, j-side AoS: live rows first
    rows: Optional[torch.Tensor]  # (C, K) i64 slot of each Xa row; None: k
    walked: torch.Tensor       # (C, K) bool, the i slots to evaluate
    wslot: torch.Tensor        # (NW*32,) i32 slot of each warp lane, or -1
    blocks: torch.Tensor       # (NB, 3) i32 cell, first warp, warps
    wpb: int                   # i-slot warps a block (the launch's)
    cdim: Tuple[int, int, int]
    K: int
    KJ: int
    edge: Tuple[float, float, float]


def nbr_cell_table(cdim, offsets) -> np.ndarray:
    """(C, 27) linear ids of each cell's stencil cells (periodic wrap), in
    the order of ``offsets``."""
    ncx, ncy, ncz = cdim
    ids = np.arange(ncx * ncy * ncz)
    ix, iy, iz = ids // (ncy * ncz), (ids // ncz) % ncy, ids % ncz
    out = np.empty((len(ids), 27), np.int64)
    for o, (dx, dy, dz) in enumerate(offsets):
        out[:, o] = (((ix + dx) % ncx) * ncy + (iy + dy) % ncy) * ncz \
            + (iz + dz) % ncz
    return out


def choose_wpb(warps: np.ndarray) -> int:
    """The i-slot warps a block that take the fewest warp slots over the
    cells' ``warps`` (idle warps of a cell's last block and each block's
    producer included)."""
    w = warps[warps > 0]
    if w.size == 0:
        return 1
    cost = [int(np.sum(-(-w // b))) * (b + 1)
            for b in range(1, MAX_WARPS + 1)]
    return 1 + int(np.argmin(cost))


def warp_table(walked: torch.Tensor):
    """(wslot, blocks, wpb) of the (C, K) walked slots: each cell's walked
    slots 32 to a warp in slot order (``wslot``, -1 past the cell's last),
    the warps of a cell consecutive, and cut into blocks of ``wpb``
    (``blocks``: cell, first warp, warps).  Reads the per-cell counts on
    the host (to size the launch)."""
    C, K = walked.shape
    dev = walked.device
    n_c = walked.sum(1).cpu().numpy()
    warps = -(-n_c // WARP)
    wpb = choose_wpb(warps)
    nb_c = -(-warps // wpb)
    n_blocks = int(nb_c.sum())
    wstart = np.cumsum(warps) - warps
    cell = np.repeat(np.arange(C), nb_c)
    b_in = np.arange(n_blocks) - np.repeat(np.cumsum(nb_c) - nb_c, nb_c)
    first = wstart[cell] + b_in * wpb
    blocks = np.stack([cell, first,
                       np.minimum(wpb, warps[cell] - b_in * wpb)], axis=1)
    nw = int(warps.sum())
    # one copy to the card: lane 32 x (the cell's first warp) - 1, blocks
    host = torch.from_numpy(np.concatenate(
        [wstart * WARP - 1, blocks.reshape(-1)]).astype(np.int64)).to(dev)
    # a walked slot of rank r in its cell goes to that lane + 1 + r
    pos = torch.where(walked, host[:C, None] + torch.cumsum(walked, dim=1),
                      nw * WARP)                         # the rest: dumped
    wslot = torch.full((nw * WARP + 1,), -1, dtype=I32, device=dev)
    wslot.scatter_(0, pos.reshape(-1),
                   torch.arange(C * K, dtype=I32, device=dev))
    return (wslot[:nw * WARP].contiguous(),
            host[C:].to(I32).reshape(-1, 3), wpb)


def make_launch(grid: CellGrid, Xi: torch.Tensor, Xa: torch.Tensor,
                counts: torch.Tensor, rows: Optional[torch.Tensor],
                walked: torch.Tensor) -> Launch27:
    """A launch from the i side ``Xi`` (F, C*K), the j side ``Xa`` (C, K,
    F) with each cell's ``counts`` live rows first (``rows``: their slots,
    None when they lie in place) and the (C, K) ``walked`` slots.  Xa's
    cells are padded to a multiple of 4 rows (16-byte bulk copies)."""
    C, K, F = Xa.shape
    KJ = -(-K // 4) * 4
    if KJ != K:
        Xa = torch.cat([Xa, Xa.new_zeros((C, KJ - K, F))], dim=1)
    wslot, blocks, wpb = warp_table(walked)
    return Launch27(counts=counts.to(I32).contiguous(), Xi=Xi,
                    Xa=Xa.reshape(C * KJ, F).contiguous(), rows=rows,
                    walked=walked, wslot=wslot, blocks=blocks, wpb=wpb,
                    cdim=tuple(grid.cdim), K=K, KJ=KJ,
                    edge=tuple(float(e) for e in grid.edge))


def split(out: torch.Tensor, body: PairBody, C: int, K: int):
    """(sums, maxes) as lists of (C, K) tensors."""
    res = out.reshape(-1, C, K)
    return ([res[q] for q in range(body.n_sum)],
            [res[body.n_sum + q] for q in range(body.n_max)])


def _shifts(launch: Launch27, offsets) -> torch.Tensor:
    """(27, 3) f32 shifts f32(d_a * edge_a) of ``offsets``."""
    return torch.tensor([[float(np.float32(d[a] * launch.edge[a]))
                          for a in range(3)] for d in offsets],
                        dtype=F32, device=launch.Xi.device)


# ---------------------------------------------------------------------------
# Plain torch version (same contract as the kernel)
# ---------------------------------------------------------------------------

def pair_apply_plain(launch: Launch27, body: PairBody, offsets,
                     sep: Separation,
                     stats: Optional[Dict] = None) -> torch.Tensor:
    """(n_sum + n_max, C*K) outputs of ``body``, evaluated densely for each
    cell's live rows (as i) against the live rows of its 27 stencil cells
    in ``offsets`` order (as j), the separation rounded by ``sep``, and
    kept for the walked slots only.  Rows are cut to the fullest cell's
    count: the rows past a cell's own count have mask 0, which the pair
    mask excludes.  Chunked over cells to bound memory.

    ``stats``, when given, receives ``"pairs"``: the accepted pairs whose i
    slot is walked (the work the pass needs, for a roofline bound), and
    ``"slot_pairs"``: (C*K,) int64, the accepted pairs of every slot (0
    where it is not walked)."""
    L = launch
    dev = L.Xi.device
    C, K, KJ = L.Xi.shape[1] // L.K, L.K, L.KJ
    F = len(body.fields)
    fidx = {n: i for i, n in enumerate(body.fields)}
    n_out = body.n_sum + body.n_max
    out = torch.zeros((n_out, C, K), dtype=F32, device=dev)
    slot_pairs = torch.zeros((C, K), dtype=torch.int64, device=dev)
    Kl = int(L.counts.max()) if C else 0
    if Kl:
        x_live = L.Xa.reshape(C, KJ, F)[:, :Kl]                 # (C, Kl, F)
        rows = (torch.arange(Kl, device=dev).expand(C, Kl) if L.rows is None
                else L.rows[:, :Kl])
        walked = torch.gather(L.walked, 1, rows)                # (C, Kl)
        res = torch.zeros((n_out, C, Kl), dtype=F32, device=dev)
        sp = torch.zeros((C, Kl), dtype=torch.int64, device=dev)
        nbr = torch.as_tensor(nbr_cell_table(L.cdim, offsets), device=dev)
        shift = _shifts(L, offsets)[:, None, :].expand(27, Kl, 3).reshape(
            1, 1, 27 * Kl, 3)
        xi_all = x_live.permute(2, 0, 1)[..., None]          # (F, C, Kl, 1)
        nc = max(1, _PLAIN_PAIRS.get(dev.type, 1 << 21) // (Kl * 27 * Kl))
        for c0 in range(0, C, nc):
            cells = slice(c0, min(c0 + nc, C))
            xi = xi_all[:, cells]                            # (F, n, Kl, 1)
            n = xi.shape[1]
            xj = x_live[nbr[cells]].reshape(n, 1, 27 * Kl, F)

            def sf(name):
                return xi[fidx[name]]

            def nf(name):
                return xj[..., fidx[name]]                    # (n, 1, 27Kl)

            dxv = tuple(sep(sf(f"off{a}"), nf(f"off{a}"), shift[..., a])
                        for a in range(3))
            r2 = dxv[0] * dxv[0] + dxv[1] * dxv[1] + dxv[2] * dxv[2]
            ok_extra, sums, maxes = body.fn(sf, nf, dxv, r2)
            ok = (nf("mask") > 0) & (r2 > 0) & ok_extra
            sp[cells] = torch.sum(ok, dim=-1)
            for q, val in enumerate(sums):
                res[q, cells] = torch.sum(torch.where(ok, val, 0.0), dim=-1)
            for q, val in enumerate(maxes):
                res[body.n_sum + q, cells] = torch.amax(
                    torch.where(ok, val, float("-inf")), dim=-1)
        out.scatter_(2, rows[None].expand(n_out, C, Kl),
                     torch.where(walked[None], res, 0.0))
        slot_pairs.scatter_(1, rows, torch.where(walked, sp, 0))
    if stats is not None:
        stats["pairs"] = int(slot_pairs.sum())
        stats["slot_pairs"] = slot_pairs.reshape(C * K)
    return out.reshape(n_out, C * K)


# ---------------------------------------------------------------------------
# The kernel's walk: pairs per warp, and a model of its filter
# ---------------------------------------------------------------------------

def warp_pairs(launch: Launch27, slot_pairs: torch.Tensor) -> torch.Tensor:
    """(NW,) int64: the pairs each warp of the kernel evaluates (its walk
    statistics' ``"pairs"``), from the plain version's per-slot counts
    (``pair_apply_plain``'s ``"slot_pairs"``) over the warp's slots."""
    ws = launch.wslot.reshape(-1, WARP).long()
    return torch.sum(torch.where(ws >= 0, slot_pairs[ws.clamp_min(0)], 0),
                     dim=-1)


def walk_summary(stats: torch.Tensor) -> Dict[str, float]:
    """Totals of the kernel's per-warp walk statistics and the lane
    utilisation (accepted pairs over 32 lanes x rounds)."""
    return _walk_summary(stats, WALK_STATS)


def walk_filter(launch: Launch27, body: PairBody, offsets,
                sep: Separation) -> Dict:
    """Plain model of the kernel's warp filter.  Per warp (NW,) int64
    ``"staged"``: the rows of its cell's 27 stencil cells; ``"passed"``:
    those the filter lets through (a live row within the body's reach
    bounds, ``REACH2``, of the box around the warp's walked slots, with
    the kernel's slack); and ``"dropped"``: the pairs of walked slots
    that the body accepts on rows the filter rejects (0 for a
    conservative filter).  ``offsets`` and ``sep`` are the engine's."""
    L = launch
    dev = L.Xi.device
    C, K, KJ = L.Xi.shape[1] // L.K, L.K, L.KJ
    F = len(body.fields)
    fidx = {n: i for i, n in enumerate(body.fields)}
    ws = L.wslot.reshape(-1, WARP).long()
    NW = ws.shape[0]
    own = ws >= 0                                           # (NW, 32)
    wcell = ws[:, 0] // K
    Kl = int(L.counts.max()) if C else 0
    x_live = L.Xa.reshape(C, KJ, F)[:, :Kl]
    counts = L.counts.long()
    nbr = torch.as_tensor(nbr_cell_table(L.cdim, offsets), device=dev)
    shift = _shifts(L, offsets)
    f32 = np.float32
    slack = float(f32(BOX_SLACK) * (f32(L.edge[0]) + f32(L.edge[1])
                                    + f32(L.edge[2])))
    xi_all = L.Xi[:, ws.clamp_min(0)]                        # (F, NW, 32)
    staged = torch.zeros(NW, dtype=torch.int64, device=dev)
    passed = torch.zeros(NW, dtype=torch.int64, device=dev)
    dropped = 0
    nw_chunk = max(1, _PLAIN_PAIRS.get(dev.type, 1 << 21) // 4
                   // max(1, WARP * Kl))
    for w0 in range(0, NW, nw_chunk):
        sl = slice(w0, min(w0 + nw_chunk, NW))
        xi = xi_all[:, sl, :, None]                          # (F, n, 32, 1)
        ow = own[sl]

        def sf(name):
            return xi[fidx[name]]

        box = []
        for name in ("off0", "off1", "off2"):
            v = sf(name)[..., 0]
            lo = torch.amin(torch.where(ow, v, float("inf")), dim=-1)
            hi = torch.amax(torch.where(ow, v, float("-inf")), dim=-1)
            box.append((0.5 * (lo + hi))[:, None])
            box.append((0.5 * (hi - lo) + slack)[:, None])
        lane_r2, _ = REACH2[body.name](
            body.params, sf, lambda name: torch.zeros((), device=dev))
        lane_r2 = torch.as_tensor(lane_r2, dtype=F32, device=dev)
        lr2 = torch.amax(torch.where(ow, lane_r2.expand(xi.shape[1:])[..., 0],
                                     float("-inf")), dim=-1)[:, None]
        for o in range(27):
            jc = nbr[wcell[sl], o]                           # (n,)
            xj = x_live[jc]                                  # (n, Kl, F)
            row_ok = (torch.arange(Kl, device=dev)[None, :]
                      < counts[jc][:, None])                 # (n, Kl)
            staged[sl] += counts[jc]

            def nb(name):
                return xj[..., fidx[name]]                   # (n, Kl)

            def nf(name):
                return nb(name)[:, None, :]                  # (n, 1, Kl)

            d2 = 0.0
            for a in range(3):
                p = nb(f"off{a}") + shift[o, a]
                d = torch.clamp_min(torch.abs(box[2 * a] - p)
                                    - box[2 * a + 1], 0.0)
                d2 = d2 + d * d
            _, row_r2 = REACH2[body.name](body.params, sf, nb)
            row_r2 = torch.as_tensor(row_r2, dtype=F32, device=dev)
            keep = (row_ok & (nb("mask") > 0) & (row_r2 >= 0)
                    & (d2 <= torch.maximum(row_r2, lr2) * REACH_SLACK))
            dxv = tuple(sep(sf(f"off{a}"), nf(f"off{a}"), shift[o, a])
                        for a in range(3))
            r2 = dxv[0] * dxv[0] + dxv[1] * dxv[1] + dxv[2] * dxv[2]
            ok_extra, _, _ = body.fn(sf, nf, dxv, r2)
            ok = ((nf("mask") > 0) & (r2 > 0) & ok_extra & ow[..., None]
                  & row_ok[:, None, :])                      # (n, 32, Kl)
            passed[sl] += torch.sum(keep, dim=-1)
            dropped += int(torch.sum(ok & ~keep[:, None, :]))
    return {"staged": staged, "passed": passed, "dropped": dropped}


# ---------------------------------------------------------------------------
# CUDA kernel: bind (ctypes), launch, attributes
# ---------------------------------------------------------------------------

def bind(lib: ctypes.CDLL, prefix: str, bodies: Sequence[str]) -> None:
    for name in bodies:
        fn = getattr(lib, f"{prefix}_{name}")
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 3
                       + [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        attr = getattr(lib, f"{prefix}_{name}_attributes")
        attr.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        attr.restype = ctypes.c_int


def kernel_attributes(library: KernelLibrary, prefix: str, name: str,
                      wpb: int = MAX_WARPS) -> Dict[str, int]:
    """The compiled kernel of body ``name`` at ``wpb`` i-slot warps a
    block: registers per thread, local memory bytes per thread (spills),
    static and dynamic shared memory per block, resident blocks per SM,
    and its walk's constants (needs the card).  Raises if its statistics
    are not laid out as ``WALK_STATS`` per warp."""
    res = (ctypes.c_int * len(ATTRIBUTES))()
    err = getattr(library.load(), f"{prefix}_{name}_attributes")(res, wpb)
    if err != 0:
        raise RuntimeError(f"{prefix}_{name}_attributes: CUDA error {err}")
    a = dict(zip(ATTRIBUTES, res))
    if (a["max_warps"], a["n_stats"]) != (MAX_WARPS, len(WALK_STATS)):
        raise RuntimeError(f"{prefix}_{name}: the kernel's walk {a} is not "
                           f"laid out as MAX_WARPS and WALK_STATS")
    return a


def pair_apply_kernel(library: KernelLibrary, prefix: str,
                      bodies: Sequence[str], launches: Dict[str, int],
                      launch: Launch27, body: PairBody,
                      stats: Optional[Dict] = None) -> torch.Tensor:
    """Launch the CUDA kernel ``<prefix>_<body>`` of ``library`` on
    PyTorch's current stream and add one to ``launches[body.name]``; a
    launch with no walked slot launches nothing and counts nothing.

    Returns (n_sum + n_max, C*K).  ``stats``, when given, receives
    ``"walk"``: the (NW, 7) i32 per-warp statistics of ``WALK_STATS``.
    Raises on anything the kernel does not take and on a launch error."""
    L = launch
    if body.name not in bodies:
        raise ValueError(f"{prefix}: no kernel for body {body.name!r} "
                         f"(have {tuple(bodies)})")
    F = len(body.fields)
    C = L.cdim[0] * L.cdim[1] * L.cdim[2]
    dev = L.Xi.device
    for name, t, dt in (("counts", L.counts, I32), ("Xi", L.Xi, F32),
                        ("Xa", L.Xa, F32), ("wslot", L.wslot, I32),
                        ("blocks", L.blocks, I32)):
        if not t.is_cuda or t.device != dev or t.dtype != dt \
                or not t.is_contiguous():
            raise ValueError(f"pair_apply_kernel: {name} must be a "
                             f"contiguous {dt} tensor on {dev}")
    nw = L.wslot.numel() // WARP
    if tuple(L.Xi.shape) != (F, C * L.K) or tuple(L.Xa.shape) != (
            C * L.KJ, F) or tuple(L.counts.shape) != (C,) \
            or L.wslot.numel() != nw * WARP or L.blocks.shape[1:] != (3,):
        raise ValueError("pair_apply_kernel: inconsistent shapes")
    if L.Xa.data_ptr() % 16:
        raise ValueError("pair_apply_kernel: Xa must be 16-byte aligned "
                         "(bulk copies)")
    fn = getattr(library.load(), f"{prefix}_{body.name}")
    out = torch.zeros((body.n_sum + body.n_max, C * L.K), dtype=F32,
                      device=dev)
    walk = None
    if stats is not None:
        walk = torch.zeros((nw, len(WALK_STATS)), dtype=I32, device=dev)
        stats["walk"] = walk
    n_blocks = L.blocks.shape[0]
    if n_blocks == 0:
        return out
    prm = (ctypes.c_float * max(1, len(body.params)))(*body.params)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(L.blocks.data_ptr(), n_blocks, L.wpb, L.wslot.data_ptr(),
             L.counts.data_ptr(), L.Xi.data_ptr(), L.Xa.data_ptr(),
             out.data_ptr(), None if walk is None else walk.data_ptr(),
             *L.cdim, L.K, L.KJ, F, *L.edge, prm, len(body.params), stream)
    if err != 0:
        raise RuntimeError(f"{prefix}_{body.name}: CUDA error {err}")
    launches[body.name] = launches.get(body.name, 0) + 1
    return out

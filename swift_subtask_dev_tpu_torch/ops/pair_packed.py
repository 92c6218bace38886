"""The packed 27-cell pair engine: CUDA kernel + plain torch version.

Port of the reference's ``ops/pallas_packed.py`` (the ``backend="pallas"``
engine).  The domain is a periodic 3-d grid of cells
(``CellGrid.build_for_positions``) whose live particles fill a prefix of
each cell's K slots.  For every i slot and each of the 27 stencil cells
(``stencil.STENCIL_27``, self first), a pair body is evaluated on the j
slots with the periodic shift folded into the j offsets, and ``n_sum``
masked sums and ``n_max`` masked maxes are reduced per i slot.  The pair
mask is ``mask_j > 0 & r2 > 0 & ok_extra``.

It takes the same :class:`~.pair_flat.PairPass` objects as the flat
engine (their range fields are unused here).  ``pair_apply`` runs the
hand-written CUDA kernel (``csrc/pair_packed.cu``) on CUDA tensors and
``pair_apply_plain`` on CPU tensors; there is no other path.  Output
conventions follow the reference kernel: slots whose 8-slot block starts
at or past the cell's live count read 0 in every output; evaluated slots
with no accepted pair read 0 (sums) / -inf (maxes).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..grid.cellgrid import CellGrid
from .cuda_build import KernelLibrary
from .pair_flat import PairBody, PairPass
from .stencil import STENCIL_27

F32 = torch.float32
I32 = torch.int32
LANES = 128      # i slots per CUDA block (one thread per slot)
BLOCK = 8        # i slots skipped together past a cell's live count
# plain version: pair evaluations per cell chunk (bounds its memory)
_PLAIN_PAIRS = {"cpu": 1 << 21, "cuda": 1 << 24}
# bodies the CUDA kernel instantiates
KERNEL_BODIES = ("density", "gradient", "force")

# launches of the CUDA kernel per body name; the kernel wrapper adds one
# per launch and nothing else touches it (reset with reset_launches)
LAUNCHES: Dict[str, int] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


@dataclass
class PackedLaunch:
    """Everything the kernel and the plain version take (same contract)."""

    counts: torch.Tensor       # (C,) i32 live slots per cell
    Xi: torch.Tensor           # (F, C*K) f32, i-side SoA
    Xa: torch.Tensor           # (C*K, F) f32, j-side AoS
    cdim: Tuple[int, int, int]
    K: int
    edge: Tuple[float, float, float]


def prepare(grid: CellGrid, pp: PairPass) -> PackedLaunch:
    """Live counts per cell and the SoA/AoS field copies of one pass."""
    if any(c < 3 for c in grid.cdim):
        raise ValueError(f"packed engine needs a 3-d grid with >= 3 cells "
                         f"per axis (cdim {grid.cdim})")
    f = pp.fields
    counts = torch.sum(f["mask"] > 0, dim=1).to(I32)
    Xi = torch.stack([f[n].reshape(-1).to(F32) for n in pp.body.fields],
                     dim=0).contiguous()
    return PackedLaunch(counts=counts.contiguous(), Xi=Xi,
                        Xa=Xi.t().contiguous(), cdim=tuple(grid.cdim),
                        K=int(f["mask"].shape[1]),
                        edge=tuple(float(e) for e in grid.edge))


def pair_apply(grid: CellGrid, pp: PairPass):
    """Run ``pp.body`` over all pairs of the 27-cell stencil.

    Returns (sums, maxes) as lists of (C, K) tensors.  CUDA tensors go to
    the CUDA kernel, CPU tensors to the plain version."""
    launch = prepare(grid, pp)
    if launch.Xi.is_cuda:
        out = pair_apply_kernel(launch, pp.body)
    elif launch.Xi.device.type == "cpu":
        out = pair_apply_plain(launch, pp.body)
    else:
        raise RuntimeError(
            f"pair_apply: no path for device {launch.Xi.device}")
    C, K = grid.C, launch.K
    res = out.reshape(-1, C, K)
    body = pp.body
    return ([res[q] for q in range(body.n_sum)],
            [res[body.n_sum + q] for q in range(body.n_max)])


def nbr_cell_table(cdim, offsets=STENCIL_27) -> np.ndarray:
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


# ---------------------------------------------------------------------------
# Plain torch version (same contract as the kernel)
# ---------------------------------------------------------------------------

def pair_apply_plain(launch: PackedLaunch, body: PairBody,
                     stats: Optional[Dict] = None) -> torch.Tensor:
    """(n_sum + n_max, C*K) outputs of ``body``, evaluated densely for the
    slots of every live 8-block against the 27 stencil cells' slots
    [0, Kj), Kj the fullest cell's live count.  Every slot past a cell's
    count must be empty (the front-packing the kernel relies on): checked
    here, and a violation raises.  Chunked over cells to bound memory.

    ``stats``, when given, receives ``"pairs"``: the accepted pairs whose i
    slot is live (the work the pass needs, for a roofline bound)."""
    L = launch
    dev = L.Xi.device
    C, K = L.Xi.shape[1] // L.K, L.K
    F = len(body.fields)
    fidx = {n: i for i, n in enumerate(body.fields)}
    n_out = body.n_sum + body.n_max
    counts = L.counts.to(torch.int64)
    xa = L.Xa.reshape(C, K, F)
    slots = torch.arange(K, device=dev)
    past = slots[None, :] >= counts[:, None]
    if bool(torch.any(past & (xa[..., fidx["mask"]] > 0))):
        raise ValueError("pair_apply_plain: a live slot lies past its "
                         "cell's count (cells must be front-packed)")
    out = torch.zeros((n_out, C, K), dtype=F32, device=dev)
    Kj = int(counts.max()) if C else 0
    if Kj == 0:
        if stats is not None:
            stats["pairs"] = 0
        return out.reshape(n_out, C * K)
    Ki = min(K, BLOCK * math.ceil(Kj / BLOCK))
    nbr = torch.as_tensor(nbr_cell_table(L.cdim), device=dev)
    shift = torch.tensor([[float(np.float32(d[a] * L.edge[a]))
                           for a in range(3)] for d in STENCIL_27],
                         dtype=F32, device=dev)                # (27, 3)
    xi_all = L.Xi.reshape(F, C, K)[:, :, :Ki, None]        # (F, C, Ki, 1)
    xj_all = xa[:, :Kj]                                     # (C, Kj, F)
    live = ((torch.arange(Ki, device=dev) // BLOCK * BLOCK)[None, :]
            < counts[:, None])                              # (C, Ki)
    n_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    nc = max(1, _PLAIN_PAIRS.get(dev.type, 1 << 21) // (Ki * 27 * Kj))

    for c0 in range(0, C, nc):
        cells = slice(c0, min(c0 + nc, C))
        xi = xi_all[:, cells]                               # (F, n, Ki, 1)
        n = xi.shape[1]
        xj = xj_all[nbr[cells]]                             # (n, 27, Kj, F)
        offs = [(xj[..., fidx[f"off{a}"]] + shift[None, :, None, a])
                .reshape(n, 1, 27 * Kj) for a in range(3)]
        xj = xj.reshape(n, 1, 27 * Kj, F)

        def sf(name):
            return xi[fidx[name]]

        def nf(name):
            return xj[..., fidx[name]]                      # (n, 1, 27Kj)

        dxv = tuple(sf(f"off{a}") - offs[a] for a in range(3))
        r2 = dxv[0] * dxv[0] + dxv[1] * dxv[1] + dxv[2] * dxv[2]
        ok_extra, sums, maxes = body.fn(sf, nf, dxv, r2)
        ok = (nf("mask") > 0) & (r2 > 0) & ok_extra
        if stats is not None:
            n_pairs += torch.sum(ok & (sf("mask") > 0))
        for q, val in enumerate(sums):
            out[q, cells, :Ki] = torch.sum(torch.where(ok, val, 0.0), dim=-1)
        for q, val in enumerate(maxes):
            out[body.n_sum + q, cells, :Ki] = torch.amax(
                torch.where(ok, val, float("-inf")), dim=-1)
    out[:, :, :Ki] = torch.where(live[None], out[:, :, :Ki], 0.0)
    if stats is not None:
        stats["pairs"] = int(n_pairs)
    return out.reshape(n_out, C * K)


# ---------------------------------------------------------------------------
# CUDA kernel: build (nvcc, at first use), bind (ctypes), launch
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    for name in KERNEL_BODIES:
        fn = getattr(lib, f"pair_packed_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 3
                       + [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("pair_packed", ("pair_packed.cu", "pair_bodies.cuh"),
                        _bind)


def pair_apply_kernel(launch: PackedLaunch, body: PairBody) -> torch.Tensor:
    """Launch the CUDA kernel of ``body`` on PyTorch's current stream.

    Returns (n_sum + n_max, C*K).  Raises on anything the kernel does not
    take and on a launch error."""
    L = launch
    if body.name not in KERNEL_BODIES:
        raise ValueError(f"pair_packed: no kernel for body {body.name!r} "
                         f"(have {KERNEL_BODIES})")
    F = len(body.fields)
    C = L.cdim[0] * L.cdim[1] * L.cdim[2]
    dev = L.Xi.device
    for name, t, dt in (("counts", L.counts, I32), ("Xi", L.Xi, F32),
                        ("Xa", L.Xa, F32)):
        if not t.is_cuda or t.device != dev or t.dtype != dt \
                or not t.is_contiguous():
            raise ValueError(f"pair_apply_kernel: {name} must be a "
                             f"contiguous {dt} tensor on {dev}")
    if tuple(L.Xi.shape) != (F, C * L.K) or tuple(L.Xa.shape) != (
            C * L.K, F) or tuple(L.counts.shape) != (C,):
        raise ValueError("pair_apply_kernel: inconsistent shapes")
    fn = getattr(LIBRARY.load(), f"pair_packed_{body.name}")
    out = torch.zeros((body.n_sum + body.n_max, C * L.K), dtype=F32,
                      device=dev)
    prm = (ctypes.c_float * max(1, len(body.params)))(*body.params)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(L.counts.data_ptr(), L.Xi.data_ptr(), L.Xa.data_ptr(),
             out.data_ptr(), *L.cdim, L.K, F, *L.edge, prm,
             len(body.params), stream)
    if err != 0:
        raise RuntimeError(f"pair_packed_{body.name}: CUDA error {err}")
    LAUNCHES[body.name] = LAUNCHES.get(body.name, 0) + 1
    return out

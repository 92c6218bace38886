"""The ring-buffer 27-cell pair engine: CUDA kernel + plain torch version.

Port of the reference's ``ops/pallas_pairs.py`` (the ``--backend
pallas_ring`` engine).  The domain is a periodic 3-d grid of cells
(``CellGrid.build_for_positions``).  For every live slot of every cell
and each of the 27 stencil cells in (dx, dy, dz) lexicographic order
(``OFFSETS``: self is index 13), a pair body is evaluated on all of the
neighbour cell's slots, and ``n_sum`` masked sums and ``n_max`` masked
maxes are reduced per slot.  The separation rounds as the TPU kernel
rounds it, ``(off_i - off_j) - f32(d * edge)``; the pair mask is
``mask_j > 0 & r2 > 0 & ok_extra``.  Unlike the packed engine it relies
on no live count: a cell's slots need not be front-packed.

It takes the same :class:`~.pair_flat.PairPass` objects as the other
engines (their range fields are unused here).  ``pair_apply`` runs the
hand-written CUDA kernel (``csrc/pair_ring.cu``) on CUDA tensors and
``pair_apply_plain`` on CPU tensors; there is no other path.  Output
conventions: a live slot with no accepted pair reads 0 (sums) / -inf
(maxes), as in the reference kernel; an empty slot (mask 0) reads 0 in
every output, where the reference kernel evaluates it with its pad fills.
The loops multiply by the mask or merge into live particles only, so
their results are the reference's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..grid.cellgrid import CellGrid
from .cuda_build import KernelLibrary
from .pair_flat import PairBody, PairPass
from .pair_packed import nbr_cell_table

F32 = torch.float32
# the 27 stencil offsets in the order the TPU kernel walks them
OFFSETS = [(dx, dy, dz)
           for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
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
class RingLaunch:
    """Everything the kernel and the plain version take (same contract)."""

    Xi: torch.Tensor           # (F, C*K) f32, i-side SoA
    Xa: torch.Tensor           # (C*K, F) f32, j-side AoS
    cdim: Tuple[int, int, int]
    K: int
    edge: Tuple[float, float, float]


def prepare(grid: CellGrid, pp: PairPass) -> RingLaunch:
    """The SoA/AoS field copies of one pass."""
    f = pp.fields
    Xi = torch.stack([f[n].reshape(-1).to(F32) for n in pp.body.fields],
                     dim=0).contiguous()
    return RingLaunch(Xi=Xi, Xa=Xi.t().contiguous(), cdim=tuple(grid.cdim),
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
    res = out.reshape(-1, grid.C, launch.K)
    body = pp.body
    return ([res[q] for q in range(body.n_sum)],
            [res[body.n_sum + q] for q in range(body.n_max)])


# ---------------------------------------------------------------------------
# Plain torch version (same contract as the kernel)
# ---------------------------------------------------------------------------

def pair_apply_plain(launch: RingLaunch, body: PairBody,
                     stats: Optional[Dict] = None) -> torch.Tensor:
    """(n_sum + n_max, C*K) outputs of ``body``, evaluated densely for the
    live slots of every cell against the live slots of its 27 stencil
    cells.  Each cell's live slots are gathered first (in slot order) and
    cut to the fullest cell's count: the gathered slots past a cell's own
    count have mask 0, which the pair mask excludes, and their i outputs
    are dropped.  Empty slots read 0.  Chunked over cells to bound
    memory.

    ``stats``, when given, receives ``"pairs"``: the accepted pairs whose i
    slot is live (the work the pass needs, for a roofline bound)."""
    L = launch
    dev = L.Xi.device
    K = L.K
    C = L.Xi.shape[1] // K
    F = len(body.fields)
    fidx = {n: i for i, n in enumerate(body.fields)}
    n_out = body.n_sum + body.n_max
    xa = L.Xa.reshape(C, K, F)
    live = xa[..., fidx["mask"]] > 0                            # (C, K)
    Kl = int(live.sum(1).max()) if C else 0
    res = torch.zeros((n_out, C, Kl), dtype=F32, device=dev)
    # each cell's live slots first (stable), cut to the fullest cell's
    order = torch.argsort((~live).to(torch.int8), dim=1,
                          stable=True)[:, :Kl]
    x_live = torch.gather(xa, 1, order[..., None].expand(C, Kl, F))
    i_live = torch.gather(live, 1, order)                      # (C, Kl)
    # periodic wrap gives the reference's wrap-padded neighbours
    nbr = torch.as_tensor(nbr_cell_table(L.cdim, OFFSETS), device=dev)
    shift = torch.tensor([[float(np.float32(d[a] * L.edge[a]))
                           for a in range(3)] for d in OFFSETS],
                         dtype=F32, device=dev)                # (27, 3)
    shift = shift[:, None, :].expand(27, Kl, 3).reshape(1, 1, 27 * Kl, 3)
    xi_all = x_live.permute(2, 0, 1)[..., None]                # (F, C, Kl, 1)
    n_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    nc = max(1, _PLAIN_PAIRS.get(dev.type, 1 << 21)
             // max(1, Kl * 27 * Kl))

    for c0 in range(0, C if Kl else 0, nc):
        cells = slice(c0, min(c0 + nc, C))
        xi = xi_all[:, cells]                                  # (F, n, Kl, 1)
        n = xi.shape[1]
        xj = x_live[nbr[cells]].reshape(n, 1, 27 * Kl, F)

        def sf(name):
            return xi[fidx[name]]

        def nf(name):
            return xj[..., fidx[name]]                          # (n, 1, 27Kl)

        dxv = tuple((sf(f"off{a}") - nf(f"off{a}")) - shift[..., a]
                    for a in range(3))
        r2 = dxv[0] * dxv[0] + dxv[1] * dxv[1] + dxv[2] * dxv[2]
        ok_extra, sums, maxes = body.fn(sf, nf, dxv, r2)
        ok = (nf("mask") > 0) & (r2 > 0) & ok_extra
        if stats is not None:
            n_pairs += torch.sum(ok & (sf("mask") > 0))
        for q, val in enumerate(sums):
            res[q, cells] = torch.sum(torch.where(ok, val, 0.0), dim=-1)
        for q, val in enumerate(maxes):
            res[body.n_sum + q, cells] = torch.amax(
                torch.where(ok, val, float("-inf")), dim=-1)
    out = torch.zeros((n_out, C, K), dtype=F32, device=dev)
    out.scatter_(2, order[None].expand(n_out, C, Kl),
                 torch.where(i_live[None], res, 0.0))
    if stats is not None:
        stats["pairs"] = int(n_pairs)
    return out.reshape(n_out, C * K)


# ---------------------------------------------------------------------------
# CUDA kernel: build (nvcc, at first use), bind (ctypes), launch
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    for name in KERNEL_BODIES:
        fn = getattr(lib, f"pair_ring_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 3
                       + [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("pair_ring", ("pair_ring.cu", "pair_bodies.cuh"),
                        _bind)


def pair_apply_kernel(launch: RingLaunch, body: PairBody) -> torch.Tensor:
    """Launch the CUDA kernel of ``body`` on PyTorch's current stream.

    Returns (n_sum + n_max, C*K).  Raises on anything the kernel does not
    take and on a launch error."""
    L = launch
    if body.name not in KERNEL_BODIES:
        raise ValueError(f"pair_ring: no kernel for body {body.name!r} "
                         f"(have {KERNEL_BODIES})")
    F = len(body.fields)
    C = L.cdim[0] * L.cdim[1] * L.cdim[2]
    dev = L.Xi.device
    for name, t in (("Xi", L.Xi), ("Xa", L.Xa)):
        if not t.is_cuda or t.device != dev or t.dtype != F32 \
                or not t.is_contiguous():
            raise ValueError(f"pair_apply_kernel: {name} must be a "
                             f"contiguous {F32} tensor on {dev}")
    if tuple(L.Xi.shape) != (F, C * L.K) or tuple(L.Xa.shape) != (
            C * L.K, F):
        raise ValueError("pair_apply_kernel: inconsistent shapes")
    fn = getattr(LIBRARY.load(), f"pair_ring_{body.name}")
    out = torch.zeros((body.n_sum + body.n_max, C * L.K), dtype=F32,
                      device=dev)
    prm = (ctypes.c_float * max(1, len(body.params)))(*body.params)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(L.Xi.data_ptr(), L.Xa.data_ptr(), out.data_ptr(), *L.cdim,
             L.K, F, *L.edge, prm, len(body.params), stream)
    if err != 0:
        raise RuntimeError(f"pair_ring_{body.name}: CUDA error {err}")
    LAUNCHES[body.name] = LAUNCHES.get(body.name, 0) + 1
    return out

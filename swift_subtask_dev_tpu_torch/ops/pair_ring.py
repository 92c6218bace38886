"""The ring-buffer 27-cell pair engine: CUDA kernel + plain torch version.

Port of the reference's ``ops/pallas_pairs.py`` (the ``--backend
pallas_ring`` engine).  The domain is a periodic 3-d grid of cells
(``CellGrid.build_for_positions``).  For every walked i slot (live, and
active when the caller passes ``active_i``) and each of the 27 stencil
cells in (dx, dy, dz) lexicographic order (``OFFSETS``: self is index
13), a pair body is evaluated on the neighbour cell's live slots, and
``n_sum`` masked sums and ``n_max`` masked maxes are reduced per slot.
The separation rounds as the TPU kernel rounds it, ``(off_i - off_j) -
f32(d * edge)``; the pair mask is ``mask_j > 0 & r2 > 0 & ok_extra``.
Unlike the packed engine it relies on no front-packing: ``prepare``
copies each cell's live slots, wherever they sit, to the front of the
walk's j side, in slot order.

It takes the same :class:`~.pair_flat.PairPass` objects as the other
engines (their range fields are unused here).  ``pair_apply`` runs the
hand-written CUDA kernel (``csrc/pair_ring.cu`` on the shared walk of
``csrc/walk27.cuh``, ``ops/walk27.py``) on CUDA tensors and
``pair_apply_plain`` on CPU tensors; there is no other path.  Output
conventions: a walked slot with no accepted pair reads 0 (sums) / -inf
(maxes), as in the reference kernel; every other slot reads 0 in every
output, where the reference kernel evaluates the empty slots with their
pad fills and every active or inactive slot.  The loops multiply by the
mask or merge into live (active) particles only, so their results are the
reference's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..grid.cellgrid import CellGrid
from . import walk27
from .cuda_build import KernelLibrary
from .pair_flat import PairBody, PairPass
from .walk27 import Launch27

F32 = torch.float32
# the 27 stencil offsets in the order the TPU kernel walks them
OFFSETS = [(dx, dy, dz)
           for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
# bodies the CUDA kernel instantiates
KERNEL_BODIES = ("density", "gradient", "force")

# launches of the CUDA kernel per body name; the kernel wrapper adds one
# per launch and nothing else touches it (reset with reset_launches)
LAUNCHES: Dict[str, int] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def sep(off_i, off_j, shift):
    """The TPU kernel's separation: the offsets' difference, then the
    shift."""
    return (off_i - off_j) - shift


def live_rows(live: torch.Tensor) -> torch.Tensor:
    """(C, K) i64: each cell's live slots in slot order, then its other
    slots in slot order (a permutation of each cell's slots)."""
    C, K = live.shape
    k = torch.arange(K, device=live.device)
    incl = torch.cumsum(live, dim=1)                 # live slots up to k
    count = incl[:, -1:]
    dest = torch.where(live, incl - 1, count + k - incl)
    return torch.empty_like(dest).scatter_(1, dest, k.expand(C, K))


def prepare(grid: CellGrid, pp: PairPass,
            active_i: Optional[torch.Tensor] = None) -> Launch27:
    """The i-side SoA fields at the slots, the j side (each cell's live
    rows first, in slot order, with their count) and the warps of the
    walked slots (live, and active when ``active_i`` is given)."""
    f = pp.fields
    C, K = f["mask"].shape
    live = f["mask"] > 0
    walked = live if active_i is None else live & (active_i > 0)
    Xi = torch.stack([f[n].reshape(-1).to(F32) for n in pp.body.fields],
                     dim=0).contiguous()
    rows = live_rows(live)
    Xa = torch.gather(Xi.t().reshape(C, K, -1), 1,
                      rows[..., None].expand(C, K, Xi.shape[0]))
    return walk27.make_launch(grid, Xi, Xa, torch.sum(live, dim=1), rows,
                              walked)


def pair_apply(grid: CellGrid, pp: PairPass,
               active_i: Optional[torch.Tensor] = None):
    """Run ``pp.body`` over all pairs of the 27-cell stencil.

    Returns (sums, maxes) as lists of (C, K) tensors.  CUDA tensors go to
    the CUDA kernel, CPU tensors to the plain version.  ``active_i``
    ((C, K) bool/0-1): only its live slots are evaluated; the others read
    0 and the caller merges previous values."""
    launch = prepare(grid, pp, active_i)
    if launch.Xi.is_cuda:
        out = pair_apply_kernel(launch, pp.body)
    elif launch.Xi.device.type == "cpu":
        out = pair_apply_plain(launch, pp.body)
    else:
        raise RuntimeError(
            f"pair_apply: no path for device {launch.Xi.device}")
    return walk27.split(out, pp.body, grid.C, launch.K)


def pair_apply_plain(launch: Launch27, body: PairBody,
                     stats: Optional[Dict] = None) -> torch.Tensor:
    """``walk27.pair_apply_plain`` in OFFSETS order with this engine's
    separation."""
    return walk27.pair_apply_plain(launch, body, OFFSETS, sep, stats)


# ---------------------------------------------------------------------------
# CUDA kernel: build (nvcc, at first use), bind (ctypes), launch
# ---------------------------------------------------------------------------

LIBRARY = KernelLibrary(
    "pair_ring", ("pair_ring.cu", "walk27.cuh", "walk.cuh",
                  "pair_bodies.cuh"),
    lambda lib: walk27.bind(lib, "pair_ring", KERNEL_BODIES))


def kernel_attributes(name: str, wpb: int = walk27.MAX_WARPS):
    return walk27.kernel_attributes(LIBRARY, "pair_ring", name, wpb)


def pair_apply_kernel(launch: Launch27, body: PairBody,
                      stats: Optional[Dict] = None) -> torch.Tensor:
    """Launch the CUDA kernel of ``body`` on PyTorch's current stream
    (``walk27.pair_apply_kernel``)."""
    return walk27.pair_apply_kernel(LIBRARY, "pair_ring", KERNEL_BODIES,
                                    LAUNCHES, launch, body, stats)


def walk_filter(launch: Launch27, body: PairBody) -> Dict:
    """``walk27.walk_filter`` with this engine's order and separation."""
    return walk27.walk_filter(launch, body, OFFSETS, sep)

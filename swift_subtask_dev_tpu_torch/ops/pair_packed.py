"""The packed 27-cell pair engine: CUDA kernel + plain torch version.

Port of the reference's ``ops/pallas_packed.py`` (the ``backend="pallas"``
engine).  The domain is a periodic 3-d grid of cells
(``CellGrid.build_for_positions``) whose live particles fill a prefix of
each cell's K slots.  For every walked i slot (live, and active when the
caller passes ``active_i``) and each of the 27 stencil cells
(``stencil.STENCIL_27``, self first), a pair body is evaluated on the
cell's live slots with the periodic shift folded into the j offsets,
``off_i - (off_j + shift)``, and ``n_sum`` masked sums and ``n_max``
masked maxes are reduced per slot.  The pair mask is ``mask_j > 0 & r2 > 0
& ok_extra``.

It takes the same :class:`~.pair_flat.PairPass` objects as the flat
engine (their range fields are unused here).  ``pair_apply`` runs the
hand-written CUDA kernel (``csrc/pair_packed.cu`` on the shared walk of
``csrc/walk27.cuh``, ``ops/walk27.py``) on CUDA tensors and
``pair_apply_plain`` on CPU tensors; there is no other path.  Output
conventions: a walked slot with no accepted pair reads 0 (sums) / -inf
(maxes), as in the reference kernel; every other slot reads 0 in every
output, where the reference kernel evaluates the empty slots of a live
8-slot block with their pad fills and every active or inactive slot.  The
loops multiply by the mask or merge into live (active) particles only, so
their results are the reference's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..grid.cellgrid import CellGrid
from . import walk27
from .cuda_build import KernelLibrary
from .pair_flat import PairBody, PairPass
from .stencil import STENCIL_27
from .walk27 import Launch27

F32 = torch.float32
# bodies the CUDA kernel instantiates
KERNEL_BODIES = ("density", "gradient", "force")

# launches of the CUDA kernel per body name; the kernel wrapper adds one
# per launch and nothing else touches it (reset with reset_launches)
LAUNCHES: Dict[str, int] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def sep(off_i, off_j, shift):
    """The TPU kernel's separation: the shift folded into the j offset."""
    return off_i - (off_j + shift)


def prepare(grid: CellGrid, pp: PairPass,
            active_i: Optional[torch.Tensor] = None) -> Launch27:
    """Live counts per cell, the SoA/AoS field copies of one pass and the
    warps of its walked slots (live, and active when ``active_i`` is
    given)."""
    if any(c < 3 for c in grid.cdim):
        raise ValueError(f"packed engine needs a 3-d grid with >= 3 cells "
                         f"per axis (cdim {grid.cdim})")
    f = pp.fields
    C, K = f["mask"].shape
    live = f["mask"] > 0
    walked = live if active_i is None else live & (active_i > 0)
    Xi = torch.stack([f[n].reshape(-1).to(F32) for n in pp.body.fields],
                     dim=0).contiguous()
    return walk27.make_launch(grid, Xi, Xi.t().reshape(C, K, -1),
                              torch.sum(live, dim=1), None, walked)


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
    """``walk27.pair_apply_plain`` in STENCIL_27 order with this engine's
    separation.  Every slot past a cell's count must be empty (the
    front-packing the kernel relies on): checked here, and a violation
    raises."""
    L = launch
    C = L.Xi.shape[1] // L.K
    mask = L.Xi[body.fields.index("mask")].reshape(C, L.K)
    past = (torch.arange(L.K, device=mask.device)[None, :]
            >= L.counts[:, None].long())
    if bool(torch.any(past & (mask > 0))):
        raise ValueError("pair_apply_plain: a live slot lies past its "
                         "cell's count (cells must be front-packed)")
    return walk27.pair_apply_plain(L, body, STENCIL_27, sep, stats)


# ---------------------------------------------------------------------------
# CUDA kernel: build (nvcc, at first use), bind (ctypes), launch
# ---------------------------------------------------------------------------

LIBRARY = KernelLibrary(
    "pair_packed", ("pair_packed.cu", "walk27.cuh", "walk.cuh",
                    "pair_bodies.cuh"),
    lambda lib: walk27.bind(lib, "pair_packed", KERNEL_BODIES))


def kernel_attributes(name: str, wpb: int = walk27.MAX_WARPS):
    return walk27.kernel_attributes(LIBRARY, "pair_packed", name, wpb)


def pair_apply_kernel(launch: Launch27, body: PairBody,
                      stats: Optional[Dict] = None) -> torch.Tensor:
    """Launch the CUDA kernel of ``body`` on PyTorch's current stream
    (``walk27.pair_apply_kernel``)."""
    return walk27.pair_apply_kernel(LIBRARY, "pair_packed", KERNEL_BODIES,
                                    LAUNCHES, launch, body, stats)


def walk_filter(launch: Launch27, body: PairBody) -> Dict:
    """``walk27.walk_filter`` with this engine's order and separation."""
    return walk27.walk_filter(launch, body, STENCIL_27, sep)

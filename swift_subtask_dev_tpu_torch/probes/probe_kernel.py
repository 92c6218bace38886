"""Cost probe of the flat pair kernel: K1 with six synthetic bodies.

    python -m swift_subtask_dev_tpu_torch.probes.probe_kernel [--reach R]

Port of the reference's ``tools/probe_kernel.py``.  On the bench geometry
(``uniform_box_ic(n=36)``: 93,312 particles, z-sorted columns at reach
0.0621, h = 0.05, range words at range_scale 1) it runs the flat kernel
(``csrc/pair_flat.cu``) with the bodies of ``csrc/probe_bodies.cuh``, each
with one sum and no max:

    A00  walk only (every candidate accepted, r2 summed)
    A    walk + 1 j field          B  walk + 9 j fields
    C    B + 56 multiply-adds      D  C's fields + 2 rsqrt, divide, sqrt, exp
    E    D with an approximate reciprocal and an rsqrt-composed sqrt

and prints the visited j-granules of the range words and the kernel's ms
per body (CUDA events).  ``probe_passes`` builds the passes; each body's
plain callback runs through ``pair_flat.pair_apply_plain``.  The kernel
agrees with it to the flat kernel's tolerance (sums within 1e-5 of max):
summation order for all bodies, and for E also its approximate
reciprocal and rsqrt-composed sqrt (a few ulp per pair).
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from ..grid.cellgrid import CellGrid, bucket_fields
from ..ics import uniform_box_ic
from ..ops import pair_flat
from ..ops.pair_flat import PairBody, PairPass

N1 = 36                  # uniform_box_ic(n=36): 93,312 particles
REACH = 0.0621           # the bench geometry's hydro reach
H = 0.05
R2_CUT = 0.0036          # 0.06^2
FIELDS_A = ("mask", "off0", "off1", "off2", "h", "m")
FIELDS_B = FIELDS_A + tuple(f"x{k}" for k in range(8))


def _a00(sf, nf, dx, r2):
    return r2 > -1.0, [r2], []


def _a(sf, nf, dx, r2):
    return r2 < R2_CUT, [nf("m")], []


def _b(sf, nf, dx, r2):
    acc = nf("m")
    for k in range(8):
        acc = acc + nf(f"x{k}")
    return r2 < R2_CUT, [acc], []


def _c(sf, nf, dx, r2):
    acc = nf("m") * sf("m")
    v = r2
    for k in range(8):
        x = nf(f"x{k}")
        for _ in range(7):
            v = v * x + acc
    return r2 < R2_CUT, [v], []


def _transcendentals(sf, nf, r2):
    r_inv = torch.rsqrt(torch.clamp_min(r2, 1e-38))
    e = torch.exp(-r2)
    r2b = torch.rsqrt(torch.clamp_min(r2 + 1.0, 1e-38))
    return r2 * r_inv, e, r2b


def _d(sf, nf, dx, r2):
    r, e, r2b = _transcendentals(sf, nf, r2)
    a = 1.0 / (nf("x0") + sf("m") + 3.0)
    b = torch.sqrt(torch.abs(nf("x1") - sf("m")) * a)
    return r2 < R2_CUT, [r + a + b + e + r2b], []


def _e(sf, nf, dx, r2):
    r, e, r2b = _transcendentals(sf, nf, r2)
    a = 1.0 / (nf("x0") + sf("m") + 3.0)
    ab = torch.abs(nf("x1") - sf("m")) * a
    b = ab * torch.rsqrt(torch.clamp_min(ab, 1e-38))
    return r2 < R2_CUT, [r + a + b + e + r2b], []


BODIES = [PairBody("probe_a00", FIELDS_A, 1, 0, (), _a00),
          PairBody("probe_a", FIELDS_A, 1, 0, (), _a),
          PairBody("probe_b", FIELDS_B, 1, 0, (), _b),
          PairBody("probe_c", FIELDS_B, 1, 0, (), _c),
          PairBody("probe_d", FIELDS_B, 1, 0, (), _d),
          PairBody("probe_e", FIELDS_B, 1, 0, (), _e)]


def geometry(n1: int = N1, reach: float = REACH, device="cuda"):
    """(grid, fields): the bucketed bench IC with h = 0.05 and x_k =
    (k + 1) m, as the reference's probe builds it."""
    ic = uniform_box_ic(n=n1, jitter=0.2, seed=3)
    grid = CellGrid.build_columns(ic["box"], interaction_range=reach,
                                  pos=ic["pos"])
    base = {"m": ic["m"], "h": np.full(len(ic["pos"]), H, np.float32)}
    out, mask, off, n_over = bucket_fields(grid, ic["pos"], base,
                                           device=device, zsort=True)
    if int(n_over):
        raise RuntimeError(f"{int(n_over)} particles overflowed the columns")
    f = {"mask": mask, "off0": off[..., 0], "off1": off[..., 1],
         "off2": off[..., 2], "h": out["h"], "m": out["m"]}
    for k in range(8):
        f[f"x{k}"] = out["m"] * (k + 1.0)
    return grid, f


def probe_passes(fields: Dict[str, torch.Tensor]) -> List[PairPass]:
    return [PairPass(b, {k: fields[k] for k in b.fields}, range_scale=1.0)
            for b in BODIES]


def visited_granules(grid: CellGrid, fields) -> int:
    """j-granules (GRAN rows) the range words name, over all i-tiles."""
    rng = pair_flat._block_ranges(grid, fields["mask"], fields["off2"],
                                  fields["h"], 1.0, False,
                                  jb=pair_flat.GRAN)
    return int((((rng[..., 0] >> 16) & 0xFFFF)
                + ((rng[..., 1] >> 16) & 0xFFFF)).sum())


def time_kernel(grid: CellGrid, pp: PairPass, reps: int = 8) -> float:
    """Mean ms per kernel launch of the pass (CUDA events, after a
    warm-up; the range words and field copies are made once, before)."""
    launch = pair_flat.prepare(grid, pp)
    pair_flat.pair_apply_kernel(launch, pp.body)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        pair_flat.pair_apply_kernel(launch, pp.body)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main(argv=None) -> Dict[str, float]:
    """Run every body through the kernel on the card; prints and returns
    the kernel's ms per pass."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reach", type=float, default=REACH)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the card: no CUDA device")
    grid, f = geometry(reach=args.reach)
    nb = visited_granules(grid, f)
    print(f"grid={grid.cdim} W={grid.K} granule={pair_flat.GRAN} rows")
    print(f"visited j-granules/pass: {nb}  candidate pairs: "
          f"{nb * pair_flat.GRAN * pair_flat.LANES / 1e6:.1f} M")
    name = torch.cuda.get_device_name()
    res = {}
    for pp in probe_passes(f):
        res[pp.body.name] = time_kernel(grid, pp)
        print(f"{pp.body.name:10s} {res[pp.body.name]:8.4f} ms [{name}]")
    return res


if __name__ == "__main__":
    main()

"""Sedov-Taylor blast on the port (the reference's examples/sedov/run.py,
SWIFT's HydroTests/SedovBlast_3D).

    python -m swift_subtask_dev_tpu_torch.examples.sedov [--n 32]
        [--tend 0.05] [--cpu] [--backend pallas|pallas_ring] [--limiter]

Point-like energy injection into a uniform medium; the blast radius
follows r_sh = 1.15167 (E t^2 / rho)^(1/5).  PASS when the shock radius
(median radius of the particles above half the peak density) is within
10% of it and the total energy drifts by less than 5%.  Runs on the card
unless ``--cpu`` is given.

``--limiter`` turns on the timestep limiter (SWIFT's ``--limiter``, with
which SWIFT runs SedovBlast_3D).  ``run_blast`` is the same run as a
function, for any port backend: ``"pallas"`` (the example's 27-cell
grid, packed pair kernel), ``"pallas_ring"`` (the same grid, ring-buffer
pair kernel; the reference CLI's ``--backend pallas_ring``) or ``"flat"``
(column grid, flat pair kernel), each with or without the limiter.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..engine import Engine, EngineConfig
from ..grid.cellgrid import CellGrid, global_positions
from ..ics import sedov_ic
from ..io.statistics import gas_statistics
from ..models.sph.sphenix import SPHENIXParams

GAMMA = 1.825742   # cubic-spline kernel support / h


def make_engine(n: int, t_end: float, backend: str = "pallas",
                limiter: bool = False, device="cuda", E0: float = 1.0):
    """The example's IC, grid, params and engine, particles loaded.

    The grid is sized for blast-driven h growth and h_max is capped just
    under the stencil reach, so the coverage wall is never hit (SWIFT's
    equivalent: h_max + space_regrid); cell overflow still re-grids."""
    ic = sedov_ic(n=n, E0=E0)
    reach = float(ic["h"].max() * 3.2)
    if backend == "flat":
        grid = CellGrid.build_columns(ic["box"], reach, ic["pos"])
    else:
        grid = CellGrid.build_for_positions(ic["box"], reach, ic["pos"],
                                            headroom=2.2)
    P = SPHENIXParams(h_max=float(min(grid.edge) / GAMMA * 0.98), CFL=0.1)
    eng = Engine(grid, P,
                 EngineConfig(dt_max=1e-3, backend=backend,
                              with_timestep_limiter=limiter),
                 0.0, t_end + 1e-9, device=device)
    eng.load_particles(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
    return eng


def shock_check(eng: Engine, E0: float, st0: Dict) -> Dict:
    """The example's PASS rule on the engine's current state."""
    st1 = gas_statistics(eng.state)
    de = abs(float(st1["e_tot"]) - float(st0["e_tot"])) \
        / abs(float(st0["e_tot"]))
    s = eng.state
    mask = (s["mask"] > 0).cpu().numpy()
    pos = global_positions(eng.grid, s["off"])[mask]
    rho = s["rho"].cpu().numpy()[mask]
    r = np.linalg.norm(pos - 0.5, axis=1)
    r_expect = 1.15167 * (E0 * eng.time ** 2) ** 0.2
    r_sh = float(np.median(r[rho > 0.5 * rho.max()]))
    err = abs(r_sh - r_expect) / r_expect
    return {"r_shock": r_sh, "r_sedov": r_expect, "radius_err": err,
            "energy_drift": de, "ok": bool(err < 0.10 and de < 0.05)}


def run_blast(n: int, t_end: float, backend: str = "pallas",
              limiter: bool = False, device="cuda", E0: float = 1.0,
              engine: Optional[Engine] = None):
    """init_particles() + run(t_end) of the example; returns (engine,
    result) with the PASS check, step count, wall seconds (synchronised)
    and per-step bin occupancy, active and woken counts."""
    eng = engine or make_engine(n, t_end, backend, limiter, device, E0)
    dev = eng.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    eng.init_particles()
    st0 = gas_statistics(eng.state)
    bins = []
    n_active = []
    n_woken = []

    def on_step(diag):
        bins.append(diag["bin_counts"].cpu().numpy())
        n_active.append(int(diag["n_active"]))
        n_woken.append(int(diag["n_woken"]))

    t1 = time.perf_counter()
    steps = eng.run(t_end, on_step=on_step)
    sync()
    t2 = time.perf_counter()
    res = shock_check(eng, E0, st0)
    res.update(steps=steps, t=eng.time, init_seconds=t1 - t0,
               run_seconds=t2 - t1,
               bins_populated=max((int((b > 0).sum()) for b in bins),
                                  default=0),
               n_active=n_active, n_woken=n_woken,
               n_regrids=eng.n_regrids,
               n_regrid_retries=eng.n_regrid_retries)
    return eng, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--tend", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--backend", default="pallas",
                    choices=["pallas", "pallas_ring"])
    ap.add_argument("--limiter", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    eng = make_engine(args.n, args.tend, args.backend, args.limiter,
                      device=device)
    print(f"N = {int(eng.state['mask'].sum())}")
    print(f"grid: {eng.grid.cdim} K={eng.grid.K} h_max={eng.sph.h_max:.3f}")
    print(f"backend {args.backend}, limiter {args.limiter}")
    eng, res = run_blast(args.n, args.tend, engine=eng)
    print(f"{res['steps']} steps in {res['run_seconds']:.1f}s; "
          f"t={res['t']:.4f}; re-grids {res['n_regrids']}")
    print(f"energy drift: {res['energy_drift']:.2e}")
    print(f"shock radius: {res['r_shock']:.4f} vs Sedov "
          f"{res['r_sedov']:.4f} (err {res['radius_err']:.1%})")
    print("PASS" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

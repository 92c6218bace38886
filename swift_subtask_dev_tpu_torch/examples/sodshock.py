"""Sod shock tube on the port (the reference's examples/sodshock/run.py,
SWIFT's HydroTests/SodShock_3D).

    python -m swift_subtask_dev_tpu_torch.examples.sodshock [--n 64]
        [--tend 0.2] [--scheme sphenix] [--kernel cubic-spline] [--cpu]

A 3D periodic shock tube, (rho, P) = (1, 1) left of x = 1 and (0.125,
0.1) right of it, on the flat backend's column grid; the particle profile
at ``--tend`` is compared with the exact Riemann solution over 0.35 < x <
1.75, and the example prints L1(rho)/mean, L1(vx) and the energy drift
(kinetic + internal, float64 sums; the entropy of Gadget2 and
Pressure-Entropy converted back to internal energy).  PASS, as the
reference's, when L1(rho)/mean < 0.05 and the drift is below 1e-3.
``--scheme`` and ``--kernel`` take the reference YAML's SPH:scheme and
SPH:kernel values.  Runs on the card unless ``--cpu`` is given.

``--y-aspect`` (the IC's y and z extent, 0.5 in the reference) lets a
small ``--n`` fit three columns across the tube: the column edge must
cover the interaction range, 1.4 gamma h_max of the IC.
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
from ..ics import sod_shock_ic
from ..models.sph import SCHEMES, u_is_entropy
from ..models.sph.kernels import KERNELS
from ..validation import sod_solution

X_LO, X_HI = 0.35, 1.75     # the compared window (the reference's)


def make_engine(n: int, t_end: float, scheme: str = "sphenix",
                kernel: str = "cubic-spline", device="cuda",
                y_aspect: float = 0.5) -> Engine:
    """The example's IC, scheme, column grid and engine, particles
    loaded (an entropy scheme's u slot holds the entropy, from the IC's
    exact densities: 1 left of x = 1, 0.125 right of it)."""
    ic = sod_shock_ic(n_l=n, y_aspect=y_aspect)
    K = KERNELS[kernel]
    P = SCHEMES[scheme](kernel=K, h_max=float(ic["h"].max() * 4))
    grid = CellGrid.build_columns(
        ic["box"], interaction_range=float(ic["h"].max() * K.gamma * 1.4),
        pos=ic["pos"])
    eng = Engine(grid, P, EngineConfig(dt_max=1e-2, backend="flat"), 0.0,
                 t_end + 1e-9, device=device)
    u = ic["u"]
    if u_is_entropy(P):
        rho0 = np.where(ic["pos"][:, 0] < 1.0, 1.0, 0.125)
        u = P.mod.entropy_from_internal_energy(P, rho0, u).numpy()
    eng.load_particles(ic["pos"], ic["m"], ic["v"], u, ic["h"])
    return eng


def energy(eng: Engine) -> float:
    """Kinetic + internal energy of the live gas, float64 sums."""
    s = eng.state
    live = s["mask"] > 0
    m = s["m"][live].double()
    v = s["v_full"][live].double()
    u = s["u_full"][live]
    if u_is_entropy(eng.sph):
        u = eng.sph.mod.internal_energy_from_entropy(eng.sph, s["rho"][live],
                                                     u)
    return float((0.5 * m * (v * v).sum(-1) + m * u.double()).sum())


def profile_errors(eng: Engine) -> Dict:
    """L1(rho)/mean and L1(vx) against the exact solution at eng.time."""
    s = eng.state
    mask = (s["mask"] > 0).cpu().numpy()
    x = global_positions(eng.grid, s["off"])[mask][:, 0]
    rho = s["rho"].cpu().numpy()[mask]
    vx = s["v_full"].cpu().numpy()[mask][:, 0]
    sel = (x > X_LO) & (x < X_HI)
    rho_ex, v_ex, _ = sod_solution(x[sel], eng.time)
    return {"l1_rho": float(np.mean(np.abs(rho[sel] - rho_ex))
                            / rho_ex.mean()),
            "l1_vx": float(np.mean(np.abs(vx[sel] - v_ex)))}


def run_sod(n: int, t_end: float, scheme: str = "sphenix",
            kernel: str = "cubic-spline", device="cuda",
            y_aspect: float = 0.5, engine: Optional[Engine] = None,
            max_steps: int = 10 ** 9):
    """init_particles() + run(t_end) of the example (at most
    ``max_steps`` steps); returns (engine, result): L1(rho)/mean, L1(vx),
    energy drift, PASS, steps, t and wall seconds (synchronised)."""
    eng = engine or make_engine(n, t_end, scheme, kernel, device, y_aspect)
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    eng.init_particles()
    e0 = energy(eng)
    sync()
    t1 = time.perf_counter()
    steps = eng.run(t_end, max_steps=max_steps)
    sync()
    t2 = time.perf_counter()
    res = profile_errors(eng)
    de = abs(energy(eng) - e0) / abs(e0)
    res.update(energy_drift=de, ok=bool(res["l1_rho"] < 0.05 and de < 1e-3),
               steps=steps, t=eng.time, init_seconds=t1 - t0,
               run_seconds=t2 - t1, n_regrids=eng.n_regrids)
    return eng, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64,
                    help="left-state lattice spacings per unit length")
    ap.add_argument("--tend", type=float, default=0.2)
    ap.add_argument("--scheme", default="sphenix",
                    choices=[n for n in SCHEMES
                             if n not in ("none", "planetary")],
                    help="SPH:scheme (the hydro schemes of the flat "
                    "backend: None has no hydrodynamics, Planetary needs "
                    "its materials)")
    ap.add_argument("--kernel", default="cubic-spline",
                    choices=sorted(KERNELS), help="SPH:kernel")
    ap.add_argument("--y-aspect", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    eng = make_engine(args.n, args.tend, args.scheme, args.kernel,
                      "cpu" if args.cpu else "cuda", args.y_aspect)
    print(f"N = {int((eng.state['mask'] > 0).sum())} particles, box = "
          f"{eng.grid.box}; scheme {args.scheme}, kernel {args.kernel}")
    print(f"grid: cdim={eng.grid.cdim} K={eng.grid.K}")
    eng, res = run_sod(args.n, args.tend, engine=eng)
    print(f"{res['steps']} steps in {res['run_seconds']:.1f}s; "
          f"re-grids {res['n_regrids']}")
    print(f"energy drift: {res['energy_drift']:.2e}")
    print(f"t = {res['t']:.4f}")
    print(f"L1(rho)/mean = {res['l1_rho']:.4f}")
    print(f"L1(vx)       = {res['l1_vx']:.4f}")
    print("PASS" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

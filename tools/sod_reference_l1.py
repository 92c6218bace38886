#!/usr/bin/env python
"""The JAX reference's Sod shock L1 errors per SPH scheme, on the CPU.

Runs the reference's ``examples/sodshock/run.py`` (its IC, h_max,
interaction range, dt_max, end time and L1 measure) with the scheme and
kernel named, and prints one JSON line per run: L1(rho)/mean, L1(vx), the
energy drift (internal energy converted from the entropy for Gadget2
and Pressure-Entropy),
steps and seconds.  The port's ``chip_smoke.py`` phase 14 holds its own
Sod runs at n = 64 to these numbers at n = 32 (``SOD_REFERENCE_L1``
there).

``--backend flat`` (the default) runs the reference's flat backend on
the column grid, as the port's example does (its Pallas kernel in the
interpreter on the CPU); ``--backend xla`` is the reference example's own
27-cell grid and XLA stencil, which at n = 32 asks the CPU for ~68 GB.

    JAX_PLATFORMS=cpu python tools/sod_reference_l1.py --n 32 \\
        --runs sphenix:cubic-spline minimal:cubic-spline \\
        gadget2:cubic-spline pressure-energy:cubic-spline \\
        anarchy-pu:cubic-spline anarchy-pu:wendland-C2 \\
        pressure-entropy:cubic-spline \\
        pressure-energy-monaghan:cubic-spline phantom:cubic-spline \\
        gasoline:cubic-spline
"""

import argparse
import json
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run(scheme: str, kernel: str, n: int, t_end: float,
        backend: str = "flat"):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from swift_subtask_dev_tpu.engine import Engine, EngineConfig
    from swift_subtask_dev_tpu.grid import CellGrid, global_positions
    from swift_subtask_dev_tpu.ics import sod_shock_ic
    from swift_subtask_dev_tpu.models.sph import SCHEMES, kernels
    from swift_subtask_dev_tpu.validation import sod_solution

    ic = sod_shock_ic(n_l=n, y_aspect=0.5)
    K = kernels.KERNELS[kernel]
    P = SCHEMES[scheme](kernel=K, h_max=float(ic["h"].max() * 4))
    reach = float(ic["h"].max() * K.gamma * 1.4)
    if backend == "flat":
        grid = CellGrid.build_columns(ic["box"], interaction_range=reach,
                                      pos=ic["pos"])
    else:
        grid = CellGrid.build_for_positions(
            ic["box"], interaction_range=reach, pos=ic["pos"],
            headroom=1.8)
    eng = Engine(grid, P, EngineConfig(dt_max=1e-2, backend=backend), 0.0,
                 t_end + 1e-9)
    u = ic["u"]
    # the schemes whose u slot holds the entropic function A carry its
    # conversions in their module
    entropy = hasattr(P.mod, "entropy_from_internal_energy")
    if entropy:
        # the IC's densities are exact: 1 left of x = 1, 0.125 right
        rho0 = np.where(ic["pos"][:, 0] < 1.0, 1.0, 0.125).astype(
            np.float32)
        u = np.asarray(P.mod.entropy_from_internal_energy(P, rho0, u),
                       np.float32)
    eng.load_particles(ic["pos"], ic["m"], ic["v"], u, ic["h"])
    eng.init_particles()

    def energy():
        s = eng.state
        mask = np.asarray(s["mask"]) > 0
        m = np.asarray(s["m"])[mask].astype(np.float64)
        v = np.asarray(s["v_full"])[mask].astype(np.float64)
        uf = np.asarray(s["u_full"])[mask]
        if entropy:
            uf = np.asarray(P.mod.internal_energy_from_entropy(
                P, jnp.asarray(np.asarray(s["rho"])[mask]),
                jnp.asarray(uf)))
        return float((0.5 * m * (v * v).sum(-1)
                      + m * uf.astype(np.float64)).sum())

    e0 = energy()
    t0 = time.time()
    steps = eng.run(t_end)
    seconds = time.time() - t0
    e1 = energy()
    s = eng.state
    mask = np.asarray(s["mask"]) > 0
    pos = global_positions(grid, np.asarray(s["off"]))[mask]
    rho = np.asarray(s["rho"])[mask]
    vx = np.asarray(s["v_full"])[mask][:, 0]
    x = pos[:, 0]
    sel = (x > 0.35) & (x < 1.75)
    rho_ex, v_ex, _ = sod_solution(x[sel], eng.time)
    return {"scheme": scheme, "kernel": kernel, "n": n, "backend": backend,
            "particles": len(ic["pos"]), "t": eng.time, "steps": steps,
            "l1_rho": float(np.mean(np.abs(rho[sel] - rho_ex))
                            / rho_ex.mean()),
            "l1_vx": float(np.mean(np.abs(vx[sel] - v_ex))),
            "energy_drift": abs(e1 - e0) / abs(e0), "seconds": seconds}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--tend", type=float, default=0.2)
    ap.add_argument("--backend", default="flat", choices=["flat", "xla"])
    ap.add_argument("--runs", nargs="+", default=["sphenix:cubic-spline"],
                    help="scheme:kernel pairs (SPH:scheme, SPH:kernel)")
    args = ap.parse_args()
    for r in args.runs:
        scheme, kernel = r.split(":")
        print(json.dumps(run(scheme, kernel, args.n, args.tend,
                             args.backend)),
              flush=True)


if __name__ == "__main__":
    main()

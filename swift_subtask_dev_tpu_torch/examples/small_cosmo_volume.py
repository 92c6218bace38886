"""SmallCosmoVolume on the port: gas + dark matter in a comoving box.

    python -m swift_subtask_dev_tpu_torch.examples.small_cosmo_volume
        [--n 64] [--L 149.2537] [--steps 32] [--cpu] [--no-cooling]

The reference's ``examples/small_cosmo_volume`` (SWIFT's
SmallCosmoVolume_hydro): ``make_ics.py``'s Zel'dovich ICs (n^3 gas + n^3
DM, slope -1, amp 40, seed 1, z = 9), run as the reference CLI's multi
path builds it (``cli.py:739-900``: ``swift-tpu run.yml --hydro
--self-gravity --cosmology --cooling``) with ``run.yml``'s values as
literals: Omega_cdm 0.26, Omega_b 0.049, Omega_Lambda 0.691, h 0.67,
a_begin 0.1, a_end 1; dt_max 0.01; resolution_eta 1.2348, CFL 0.1,
minimal internal energy 1; mesh_side_length 64, eta 0.025,
comoving_baryon_softening 0.06, split mesh kicks; Lambda/n_H^2 = 1e-26
erg cm^3/s.  The columns cover max(reach, 1.15 r_cut).  The default
geometry is SWIFT's: 64^3 + 64^3 particles in 100 Mpc/h = 149.25 Mpc
(h = 0.67).  Runs on the card unless ``--cpu`` is given; prints the state
after ``init_particles()`` and the given number of steps.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..engine import EngineConfig
from ..engine_multi import MultiEngine
from ..grid.cellgrid import CellGrid
from ..ics import small_cosmo_volume_ic
from ..models.cosmology import Cosmology
from ..models.gravity import GravityParams, GravitySolver
from ..models.sph.sphenix import SPHENIXParams
from ..subgrid.cooling import ConstLambdaCooling, make_cooling_fn
from ..utils.units import COSMO_UNITS

# run.yml
OMEGA_CDM, OMEGA_B, OMEGA_LAMBDA, HUBBLE_H = 0.26, 0.049, 0.691, 0.67
A_BEGIN, A_END = 0.1, 1.0
DT_MAX, DT_MIN = 0.01, 1e-12
RESOLUTION_ETA, CFL, U_MIN = 1.2348, 0.1, 1.0
MESH_N, ETA_GRAV, EPS_BARYON = 64, 0.025, 0.06
LAMBDA_NH2_CGS = 1e-26
# SWIFT's SmallCosmoVolume_hydro: 64^3 + 64^3 in 100 Mpc/h
N_SIDE, BOX = 64, 100.0 / HUBBLE_H


def make_engine(n: int = N_SIDE, L: float = BOX, device="cuda",
                cooling: bool = True, ic=None):
    """The run's ICs, parameters, grid, solver and engine, particles
    loaded.  Returns (engine, solver, ic)."""
    ic = ic if ic is not None else small_cosmo_volume_ic(n=n, L=L)
    gas, dm = ic["gas"], ic["dm"]
    box = tuple(ic["box"])
    units = COSMO_UNITS
    phys_const = units.constants()
    cosmology = Cosmology(Omega_cdm=OMEGA_CDM, Omega_b=OMEGA_B,
                          Omega_lambda=OMEGA_LAMBDA, h=HUBBLE_H,
                          a_begin=A_BEGIN, a_end=A_END,
                          phys_const=phys_const)
    sph = SPHENIXParams(eta_neighbours=RESOLUTION_ETA, CFL=CFL,
                        minimal_internal_energy=U_MIN)
    gp = GravityParams(G=phys_const.const_newton_G, eps=EPS_BARYON,
                       mesh_N=MESH_N, eta=ETA_GRAV)
    cooling_fn = None
    if cooling:
        cooling_fn = make_cooling_fn(
            ConstLambdaCooling.from_cgs(LAMBDA_NH2_CGS, units, phys_const),
            u_minimal=U_MIN)

    h0 = np.asarray(gas["h"], np.float32)
    pos_all = np.concatenate([gas["pos"], dm["pos"]])
    # h_max is not set: size the columns from the IC h (cli.py)
    reach = float(h0.max()) * sph.kernel.gamma * 1.3
    r_cut = gp.r_cut_ratio * gp.a_smooth * float(box[0]) / gp.mesh_N
    grid = CellGrid.build_columns(box, max(reach, r_cut * 1.15), pos_all)
    solver = GravitySolver(gp, grid, device=device)
    cfg = EngineConfig(dt_min=DT_MIN, dt_max=DT_MAX, with_self_gravity=True,
                       eta_grav=gp.eta, eps_soft=gp.eps,
                       p2p_reach=solver.pm.r_cut, backend="flat")
    eps_dm = gp.eps_dm or gp.eps
    # per-species softenings in the engine's species order (gas, dm)
    solver.eps_per_species = [gp.eps, eps_dm]
    eng = MultiEngine(grid, sph, cfg, A_BEGIN, A_END, device=device,
                      gravity_fn=solver.short_range_accelerations,
                      eps_soft=(gp.eps, eps_dm), cosmology=cosmology,
                      cooling_fn=cooling_fn,
                      mesh_fn=solver.mesh_accelerations,
                      mesh_dt_scale=solver.pm.r_s)

    def build_solver(g, eps=tuple(solver.eps_per_species)):
        s = GravitySolver(gp, g, device=device)
        s.eps_per_species = list(eps)   # survives re-grids
        return s

    eng.solver_builder = build_solver
    eng.load_gas(gas["pos"], gas["m"], gas["v"], gas["u"], h0,
                 pid=gas["pid"].astype(np.int32))
    eng.load_dm(dm["pos"], dm["m"], dm["v"], pid=dm["pid"].astype(np.int32))
    return eng, solver, ic


def summary(eng) -> dict:
    """Live counts, a, and the gas's u and rho ranges (host floats)."""
    out = {"a": eng.cosmology.a_of_ti(eng.timeline.ti_current),
           "steps": eng.step_count}
    for name, sp in eng.state.items():
        live = sp["mask"] > 0
        out[f"n_{name}"] = int(live.sum())
        out[f"vmax_{name}"] = float(sp["v_full"][live].abs().max())
    gas = eng.state["gas"]
    live = gas["mask"] > 0
    out["u_min"] = float(gas["u_full"][live].min())
    out["rho_mean"] = float(gas["rho"][live].double().mean())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N_SIDE)
    ap.add_argument("--L", type=float, default=BOX, help="box [Mpc]")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-cooling", action="store_true")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device (use --cpu)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.cpu else "cuda")
    eng, _, ic = make_engine(args.n, args.L, device,
                             cooling=not args.no_cooling)
    print(f"{2 * args.n ** 3} particles, box {args.L:.4f} Mpc, grid "
          f"cdim={list(eng.grid.cdim)} K={eng.grid.K}; rms Zel'dovich "
          f"displacement {ic['psi_rms'] / (args.L / args.n):.4g} mean "
          f"spacings")
    t0 = time.perf_counter()
    eng.init_particles()
    for _ in range(args.steps):
        eng.step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"{args.steps} steps in {time.perf_counter() - t0:.3f} s: "
          f"{summary(eng)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

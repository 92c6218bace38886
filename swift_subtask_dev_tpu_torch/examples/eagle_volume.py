"""The EAGLE volume on the port, with or without its black hole.

    python -m swift_subtask_dev_tpu_torch.examples.eagle_volume
        [--n 64] [--L 25] [--z 9] [--steps 16] [--black-holes] [--cpu]

The reference's ``examples/eagle_volume`` (the analog of SWIFT's
examples/EAGLE_low_z/EAGLE_25): ``make_ics.py``'s gas + DM + stars volume
(the SmallCosmoVolume Zel'dovich ICs with 2% of the gas sites carved out
as stars; ``ics.eagle_volume_ic``), run as the reference CLI's multi path
builds ``swift-tpu run.yml --eagle`` (``cli.py:457-461`` and
``cli.py:739-960``: hydro, self-gravity, cosmology, EAGLE table cooling
with the entropy floor, EAGLE chemistry, pressure-law star formation,
stochastic SNII thermal feedback with enrichment, and the timestep
limiter) with ``run.yml``'s values as literals (``RUN_YML``): Planck13
cosmology, a_begin 0.1, a_end 1; dt_max 0.01; resolution_eta 1.2348,
CFL 0.1, minimal internal energy 1; mesh_side_length 64, eta 0.025,
comoving_baryon_softening 0.06, split mesh kicks; and its EAGLE
sections.  ``Scheduler:cell_extra_sparts`` is absent, so the stars keep
8 free slots a column beyond the grid's capacity.

With ``--black-holes`` it is ``swift-tpu run.yml --eagle --black-holes``
(the reference's ``examples/eagle_volume/run.sh``): ``make_ics.py``'s
seed black hole at the box centre, loaded as the CLI loads it (h the
median of the gas's, the subgrid mass its mass; ``cli.py:962-974``), and
the EAGLE black holes of run.yml's EAGLEAGN section (``cli.py:341-356``):
Bondi accretion, gas swallowing, AGN heating, repositioning and BH-BH
mergers, the last two on by the section's defaults.

The one cut: EAGLE_25 has 2 x 376^3 particles and its IC file is a
download; the default here is ``--n 64 --L 25 --z 9`` (256,902 gas,
262,144 DM and 5,242 stars: 524,288 particles in 25 Mpc), one particle
spacing per cell of run.yml's 64^3 mesh.  Runs on the card unless
``--cpu`` is given; prints the state after ``init_particles()`` and the
given number of steps.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from ..engine import EngineConfig
from ..engine_multi import MultiEngine
from ..grid.cellgrid import CellGrid
from ..ics import eagle_volume_ic
from ..models.cosmology import Cosmology
from ..models.gravity import GravityParams, GravitySolver
from ..models.sph.sphenix import SPHENIXParams
from ..subgrid.black_holes import EagleBlackHoles
from ..subgrid.chemistry import EagleChemistry
from ..subgrid.eagle_cooling import EagleCooling, make_eagle_cooling_fn
from ..subgrid.enrichment import EagleEnrichment
from ..subgrid.entropy_floor import EagleEntropyFloor
from ..subgrid.feedback import EagleThermalFeedback
from ..subgrid.star_formation import EagleStarFormation
from ..utils.params import Params
from ..utils.units import COSMO_UNITS

# examples/eagle_volume/run.yml (the sections the run reads)
RUN_YML = {
    "Cosmology": {"Omega_cdm": 0.2587481, "Omega_b": 0.0482519,
                  "Omega_lambda": 0.693, "h": 0.6777, "a_begin": 0.1,
                  "a_end": 1.0},
    "TimeIntegration": {"dt_max": 0.01, "dt_min": 1e-12},
    "SPH": {"resolution_eta": 1.2348, "CFL_condition": 0.1,
            "minimal_temperature": 100.0, "minimal_internal_energy": 1.0},
    "Gravity": {"mesh_side_length": 64, "eta": 0.025,
                "comoving_baryon_softening": 0.06, "split_mesh_kicks": 1},
    "EAGLECooling": {"H_mass_fraction": 0.752},
    "EAGLEChemistry": {"init_abundance_metal": 0.006,
                       "init_abundance_Hydrogen": 0.752,
                       "init_abundance_Helium": 0.242},
    "EAGLEEntropyFloor": {
        "Jeans_density_threshold_H_p_cm3": 0.1,
        "Jeans_over_density_threshold": 10.0,
        "Jeans_temperature_norm_K": 8000.0,
        "Jeans_gamma_effective": 1.3333333,
        "Cool_density_threshold_H_p_cm3": 1e-5,
        "Cool_over_density_threshold": 10.0,
        "Cool_temperature_norm_K": 8000.0,
        "Cool_gamma_effective": 1.0},
    "EAGLEStarFormation": {
        "KS_normalisation": 1.515e-4, "KS_exponent": 1.4,
        "KS_high_density_threshold_H_p_cm3": 1e3,
        "KS_high_density_exponent": 2.0, "gas_fraction": 0.3,
        "threshold_norm_H_p_cm3": 0.1, "threshold_Z0": 0.002,
        "threshold_slope": -0.64, "threshold_max_density_H_p_cm3": 10.0,
        "EOS_entropy_margin_dex": 0.5},
    "EAGLEAGN": {
        "subgrid_seed_mass_Msun": 1.5e5, "seed_halo_mass_Msun": 1.0e10,
        "radiative_efficiency": 0.1, "coupling_efficiency": 0.15,
        "AGN_delta_T_K": 3.16228e8, "AGN_num_ngb_to_heat": 1.0,
        "max_eddington_fraction": 1.0},
    "EAGLEFeedback": {
        "SNII_energy_erg": 1.0e51, "SNII_energy_fraction": 1.0,
        "SNII_delta_T_K_log10": 7.5, "SNII_delay": 0.03,
        "with_enrichment": 1, "SNII_min_mass_Msun": 8.0,
        "SNII_max_mass_Msun": 100.0, "SNIa_DTD_exp_norm_p_Msun": 2e-3,
        "SNIa_DTD_exp_timescale_Gyr": 2.0},
}
N_SIDE, BOX, Z_START, STAR_FRAC, SEED = 64, 25.0, 9.0, 0.02, 42


def build_models(params: Params, units, cosmology: Cosmology):
    """The subgrid stack as the reference's ``cli.build_subgrid`` wires it
    for ``--eagle``: (cooling_fn, star_formation, entropy_floor,
    feedback, enrichment)."""
    pc = units.constants()
    G = pc.const_newton_G
    # the comoving critical baryon density anchors the over-densities
    rho_crit_baryon_0 = cosmology.Omega_b * (
        3.0 * cosmology.H0 ** 2 / (8.0 * math.pi * G))
    floor = EagleEntropyFloor.from_params(
        params, units, pc, rho_crit_baryon_0=rho_crit_baryon_0)
    cooling_fn = make_eagle_cooling_fn(
        EagleCooling.from_params(params, units, pc), floor,
        u_minimal=params.opt_float("SPH", "minimal_internal_energy", 0.0))
    sf = EagleStarFormation.from_params(
        params, units, pc, G, rho_crit_baryon_0=rho_crit_baryon_0,
        floor=floor)
    sec = "EAGLEFeedback"
    feedback = EagleThermalFeedback.from_physical(
        units, pc,
        delta_T_K=10.0 ** params.opt_float(sec, "SNII_delta_T_K_log10", 7.5),
        f_E=params.opt_float(sec, "SNII_energy_fraction", 1.0),
        E_SNII_cgs=params.opt_float(sec, "SNII_energy_erg", 1.0e51),
        snii_delay=params.opt_float(sec, "SNII_delay", 0.0))
    enrichment = (EagleEnrichment.from_params(params, units)
                  if params.opt_int(sec, "with_enrichment", 1) else None)
    return cooling_fn, sf, floor, feedback, enrichment


def make_engine(n: int = N_SIDE, L: float = BOX, device="cuda", ic=None,
                z: float = Z_START, black_holes: bool = False):
    """The run's ICs, parameters, grid, solver and engine, particles
    loaded; with ``black_holes`` the EAGLE black holes and the ICs' BHs
    (the seed black hole when the ICs are made here).  Returns (engine,
    solver, ic)."""
    ic = ic if ic is not None else eagle_volume_ic(
        n=n, L=L, z=z, star_frac=STAR_FRAC, seed=SEED,
        black_hole=black_holes)
    gas, dm, stars = ic["gas"], ic["dm"], ic["stars"]
    box = tuple(ic["box"])
    params = Params(RUN_YML)
    units = COSMO_UNITS
    pc = units.constants()
    g = lambda k: params.get_float("Cosmology", k)   # noqa: E731
    cosmology = Cosmology(Omega_cdm=g("Omega_cdm"), Omega_b=g("Omega_b"),
                          Omega_lambda=g("Omega_lambda"), h=g("h"),
                          a_begin=g("a_begin"), a_end=g("a_end"),
                          phys_const=pc)
    sph = SPHENIXParams(
        eta_neighbours=params.get_float("SPH", "resolution_eta"),
        CFL=params.get_float("SPH", "CFL_condition"),
        minimal_internal_energy=params.opt_float(
            "SPH", "minimal_internal_energy", 0.0))
    gp = GravityParams(
        G=pc.const_newton_G,
        eps=params.get_float("Gravity", "comoving_baryon_softening"),
        mesh_N=params.opt_int("Gravity", "mesh_side_length", 64),
        eta=params.get_float("Gravity", "eta"))
    cooling_fn, sf, floor, feedback, enrichment = build_models(
        params, units, cosmology)
    bh_model = (EagleBlackHoles.from_params(params, units, pc,
                                            pc.const_newton_G)
                if black_holes else None)

    h0 = np.asarray(gas["h"], np.float32)
    pos_all = np.concatenate([gas["pos"], dm["pos"], stars["pos"]])
    # SPH:h_max is not set: size the columns from the IC h (cli.py:768)
    reach = float(h0.max()) * sph.kernel.gamma * 1.3
    r_cut = gp.r_cut_ratio * gp.a_smooth * float(box[0]) / gp.mesh_N
    grid = CellGrid.build_columns(box, max(reach, r_cut * 1.15), pos_all)
    solver = GravitySolver(gp, grid, device=device)
    cfg = EngineConfig(
        dt_min=params.get_float("TimeIntegration", "dt_min"),
        dt_max=params.get_float("TimeIntegration", "dt_max"),
        with_self_gravity=True, with_timestep_limiter=True,
        eta_grav=gp.eta, eps_soft=gp.eps, p2p_reach=solver.pm.r_cut,
        backend="flat")
    eps_dm = gp.eps_dm or gp.eps
    # per-species softenings in the engine's species order (gas, dm,
    # stars, bh)
    solver.eps_per_species = [gp.eps, eps_dm, gp.eps, gp.eps]
    eng = MultiEngine(grid, sph, cfg, cosmology.a_begin, cosmology.a_end,
                      device=device,
                      gravity_fn=solver.short_range_accelerations,
                      eps_soft=(gp.eps, eps_dm), cosmology=cosmology,
                      cooling_fn=cooling_fn, star_formation=sf,
                      entropy_floor=floor, feedback=feedback,
                      enrichment=enrichment, bh_model=bh_model,
                      mesh_fn=solver.mesh_accelerations,
                      mesh_dt_scale=solver.pm.r_s)

    def build_solver(gr, eps=tuple(solver.eps_per_species)):
        s = GravitySolver(gp, gr, device=device)
        s.eps_per_species = list(eps)   # survives re-grids
        return s

    eng.solver_builder = build_solver
    Z, ef = EagleChemistry.from_params(params).particle_arrays(
        len(gas["pos"]))
    eng.load_gas(gas["pos"], gas["m"], gas["v"], gas["u"], h0,
                 pid=gas["pid"].astype(np.int32), Z=Z, elem_frac=ef)
    eng.load_dm(dm["pos"], dm["m"], dm["v"], pid=dm["pid"].astype(np.int32))
    eng.load_stars(stars["pos"], stars["m"], stars["v"],
                   pid=stars["pid"].astype(np.int32))
    if black_holes and "bh" in ic:
        bh = ic["bh"]
        eng.load_bh(bh["pos"], bh["m"], bh["v"],
                    h=np.full(len(bh["pos"]), float(np.median(h0)),
                              np.float32),
                    pid=bh["pid"].astype(np.int32), m_subgrid=bh["m"])
    return eng, solver, ic


def summary(eng) -> dict:
    """Live counts, a, and the gas's u, rho and Z ranges (host floats)."""
    out = {"a": eng.cosmology.a_of_ti(eng.timeline.ti_current),
           "steps": eng.step_count}
    for name, sp in eng.state.items():
        live = sp["mask"] > 0
        out[f"n_{name}"] = int(live.sum())
    gas = eng.state["gas"]
    live = gas["mask"] > 0
    out["u_min"] = float(gas["u_full"][live].min())
    out["rho_mean"] = float(gas["rho"][live].double().mean())
    out["Z_max"] = float(gas["Z"][live].max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N_SIDE)
    ap.add_argument("--L", type=float, default=BOX, help="box [Mpc]")
    ap.add_argument("--z", type=float, default=Z_START,
                    help="start redshift")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--black-holes", action="store_true",
                    help="the seed black hole and EAGLE's BH model")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device (use --cpu)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.cpu else "cuda")
    eng, _, _ = make_engine(args.n, args.L, device, z=args.z,
                            black_holes=args.black_holes)
    print(f"{eng.n_particles} particles, box {args.L:.4f} Mpc, grid "
          f"cdim={list(eng.grid.cdim)} K={eng.grid.K}")
    t0 = time.perf_counter()
    eng.init_particles()
    seen = {k: 0 for k in ("n_heated", "n_converted", "n_lost",
                           "n_swallowed", "n_agn", "n_bh_merged")}

    def on_step(diag):
        for k in seen:
            seen[k] += int(diag[k])
    # up to --steps steps; the run ends earlier when it reaches a_end
    steps = eng.run(max_steps=args.steps, on_step=on_step)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"{steps} steps in {time.perf_counter() - t0:.3f} s: "
          f"{summary(eng)}; {seen}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

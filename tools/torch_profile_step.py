#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port, on one GPU.

    python3 tools/torch_profile_step.py
        [--path main|sedov-a|sedov-c|cosmo|dmo|eagle|eagle-bh]
        [--out PATH]

``--path main`` (the default) runs bench.py's default geometry (2*80^3 =
1,024,000 particles, SPHENIX + P3M on the flat column grid, mesh_N =
192, the PM mesh on its own step) through the port, and measures, in
this order:

1. init: ``init_particles()`` wall time (cold: first use of every torch
   and CUDA kernel), its ghost iterations, and peak device memory over
   ``load_particles`` and ``init_particles``;
2. steady: ``run_fixed_dt(16, per_launch=16)`` three times (host clock,
   ending in a synchronize), as particle-steps/s;
3. trace: ``torch.profiler`` over ``run_fixed_dt(4, per_launch=4)``:
   device kernels per step, device busy time (the union of the kernel
   intervals) and its share of the traced wall, and device ms per step of
   each pair body's kernel and of everything else;
4. phases: ``run_fixed_dt(8)`` with each phase wrapped in a synchronize
   at both edges (ghost, gradient loop, force+gravity loop, rebucket
   check, kick/timestep; inside the loops ``pair_flat.prepare`` and the
   kernel launch): ms per step of each;
5. rebucket: single steps, each synchronised, alternating blocks with
   the rebucket forced every step (``rebucket_safety = 0``) and left to
   its trigger; ms per step, with steps that crossed a mesh boundary
   left out of the medians;
6. mesh: three ``_mesh_boundary()`` calls (TSC deposit, FFTs, gather),
   ms each.

``--path sedov-a`` and ``--path sedov-c`` run chip_smoke.py's Sedov
paths A (27-cell grid, backend "pallas": the packed kernel K2, no
limiter) and C (backend "pallas_ring": the ring-buffer kernel K3, the
timestep limiter and its 27-cell wake scan) at 2*51^3 = 265,302
particles: init_particles(), steps up to t = 0.025 (half the run; the
blast has spread and the bins are populated), then (1) steady: three
windows of 64 steps (host clock, synchronised), ms per step; (2) trace:
``torch.profiler`` over 32 steps: device kernels per step, busy share,
each pair body's device ms and launches per step, and all other device
kernels' ms and count per step; (3) phases over 64 steps (each
synchronised at both edges: ghost, density, gradient and force loops,
the rebucket check, kick/timestep, the wake scan on path C; inside them
the pair engine's ``prepare`` and kernel launch), ms per step.

``--path cosmo`` runs chip_smoke.py's SmallCosmoVolume (the port's
example: 2*64^3 = 524,288 gas + DM particles in 100 Mpc/h, comoving,
split mesh, constant-Lambda cooling, the multi engine), ``--path eagle``
its EAGLE volume (the port's example: 256,902 gas, 262,144 DM and 5,242
stars in 25 Mpc, EAGLE cooling, chemistry, star formation, feedback and
enrichment, the limiter), ``--path eagle-bh`` that volume with its seed
black hole (``--black-holes``: the BH's ghost, density, reposition,
accretion, swallow, AGN and merger loops; 16 P2P launches a step) and
``--path dmo`` bench.py's BENCH_MODE=dmo
geometry (1,024,000 particles, mesh_N = 192, DMEngine):
init_particles() and a warm-up window, then (1) steady: three windows,
ms per step; (2) trace over a window, as above, with K1's one-species and
cross-species P2P launches per step; (3) phases over a window (ghost,
density, gradient, force, P2P gravity, timebin and chemistry loops,
rebucket check, cooling, the gas and collisionless kicks, the mesh
update; the EAGLE layers: the stars' ghost (with the BHs' ghost on
``eagle-bh``), feedback and enrichment with their star loops, star
formation, the BH block; inside them ``pair_flat.prepare`` and the
kernel launch), ms per step.  A DMO window is 8 steps of one engine;
the volumes reach a = 1 in ~13-14 steps, so each of their windows is a
whole run() of a fresh engine after its init_particles() (the EAGLE
volume's at most chip_smoke.py's EAGLE_STEPS).

The last line printed is a JSON object with every number; it is also
written to ``--out`` (default ``chiprun_out/torch_profile_step.json``,
``torch_profile_<path>.json`` for the other paths).  Imports nothing of
JAX.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import SyncTimer  # noqa: E402

from swift_subtask_dev_tpu_torch import engine as eng_mod  # noqa: E402
from swift_subtask_dev_tpu_torch import engine_multi  # noqa: E402
from swift_subtask_dev_tpu_torch.ops import (hydro_flat, pair_flat,  # noqa
                                             pair_packed, pair_ring,
                                             stencil)

N1, MESH_N = 80, 192      # bench.py's default geometry
BODIES = ("Density", "Gradient", "ForceGravity", "Force", "P2PGravity",
          "Timebin", "ChemSmooth")
# the Sedov paths: (backend, limiter, pair engine module)
SEDOV_PATHS = {"sedov-a": ("pallas", False, pair_packed),
               "sedov-c": ("pallas_ring", True, pair_ring)}
SEDOV_N, SEDOV_T_END, SEDOV_T_WARM = 51, 0.05, 0.025
GRAVITY_PATHS = ("cosmo", "dmo", "eagle", "eagle-bh")
VOLUMES = ("cosmo", "eagle", "eagle-bh")


def pair_body(kernel_name: str):
    """The pair body a device kernel evaluates (K1's or the 27-cell
    walk's), or None for any other kernel."""
    for b in BODIES:
        if f"pair_flat_kernel<{b}," in kernel_name or (
                "walk27_kernel<" in kernel_name
                and f", {b}," in kernel_name):
            return b
    return None


def card_name() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0].strip()


def sync_s() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def steady(eng, n_part, n_steps=16, reps=3):
    rates = []
    for _ in range(reps):
        t0 = sync_s()
        eng.run_fixed_dt(n_steps, per_launch=n_steps)
        dt = sync_s() - t0
        rates.append({"seconds": dt, "ms_per_step": 1e3 * dt / n_steps,
                      "particle_steps_per_s": n_steps * n_part / dt})
    return rates


def _merged_busy(intervals):
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def trace(eng, n_steps=4, run=None):
    """Device kernels of ``run()`` (default: ``n_steps`` fixed steps)."""
    from torch.profiler import ProfilerActivity, profile
    if run is None:
        def run():
            eng.run_fixed_dt(n_steps, per_launch=n_steps)
    torch.cuda.synchronize()
    # device activity only: host-side op tracing would slow the launches
    # and so lower the busy share it is meant to read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.elapsed_us() >= 0]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = _merged_busy(intervals) / 1e3
    per_body = {b: 0.0 for b in BODIES}
    per_body_n = {b: 0 for b in BODIES}
    other_ms, other_n = 0.0, 0
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        body = pair_body(e.name)
        if body is None:
            other_ms += ms
            other_n += 1
        else:
            per_body[body] += ms
            per_body_n[body] += 1
    return {
        "steps": n_steps, "wall_ms": wall_ms,
        "device_kernels_per_step": len(kernels) / n_steps,
        "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms if wall_ms > 0 else None,
        "pair_kernel_ms_per_step": {b: v / n_steps
                                    for b, v in per_body.items()},
        "pair_kernel_launches_per_step": {b: v / n_steps
                                          for b, v in per_body_n.items()},
        "other_kernels_ms_per_step": other_ms / n_steps,
        "other_kernels_per_step": other_n / n_steps,
    }


def phases(eng, n_steps=8):
    pt = SyncTimer()
    pt.wrap(eng_mod, "_ghost_density", "ghost")
    pt.wrap(hydro_flat, "density_loop", "density_loop")
    pt.wrap(hydro_flat, "gradient_loop", "gradient_loop")
    pt.wrap(hydro_flat, "force_gravity_loop", "force_gravity_loop")
    pt.wrap(eng_mod, "_rebucket_phase", "rebucket_phase")
    pt.wrap(eng_mod, "_gas_kdk", "kick_timestep")
    pt.wrap(pair_flat, "prepare", "pair_prepare")
    pt.wrap(pair_flat, "pair_apply_kernel", "pair_kernel")
    try:
        t0 = sync_s()
        eng.run_fixed_dt(n_steps, per_launch=n_steps)
        wall = 1e3 * (sync_s() - t0)
    finally:
        pt.restore()
    return {"steps": n_steps, "ms_per_step": wall / n_steps,
            "phase_ms_per_step": {k: v / n_steps for k, v in pt.ms.items()},
            "phase_calls": pt.calls}


def rebucket(eng, n_steps=4, rounds=2):
    """Per-step ms with the rebucket forced and left to its trigger.  A
    step fired the rebucket iff it left ``drift_accum`` at 0."""
    cfg = eng.cfg
    steps = []
    for _ in range(rounds):
        for label, safety in (("trigger", cfg.rebucket_safety),
                              ("forced", 0.0)):
            eng.cfg = dataclasses.replace(cfg, rebucket_safety=safety)
            for _ in range(n_steps):
                n_mesh = eng.n_mesh_updates
                t0 = sync_s()
                eng.run_fixed_dt(1, per_launch=1)
                ms = 1e3 * (sync_s() - t0)
                steps.append({
                    "mode": label, "ms": ms,
                    "fired": bool(eng.state["drift_accum"] == 0),
                    "mesh_update": eng.n_mesh_updates != n_mesh})
    eng.cfg = cfg

    def median(rows):
        v = sorted(r["ms"] for r in rows)
        return v[len(v) // 2] if v else None

    clean = [r for r in steps if not r["mesh_update"]]
    return {"steps": steps,
            "median_ms_fired": median([r for r in clean if r["fired"]]),
            "median_ms_not_fired": median(
                [r for r in clean if not r["fired"]])}


def mesh(eng, reps=3):
    times = []
    for _ in range(reps):
        t0 = sync_s()
        eng._mesh_boundary()
        times.append(1e3 * (sync_s() - t0))
    return {"mesh_update_ms": times}


def sedov_phases(eng, module, n_steps=64):
    """ms per step of the Sedov step's phases over ``n_steps`` steps."""
    pt = SyncTimer()
    pt.wrap(eng_mod, "_ghost_density", "ghost")
    pt.wrap(hydro_flat, "density_loop", "density_loop")
    pt.wrap(hydro_flat, "gradient_loop", "gradient_loop")
    pt.wrap(hydro_flat, "force_loop", "force_loop")
    pt.wrap(eng_mod, "_rebucket_phase", "rebucket_phase")
    pt.wrap(eng_mod, "_gas_kdk", "kick_timestep")
    pt.wrap(stencil, "timebin_loop", "wake_scan")
    pt.wrap(module, "prepare", "pair_prepare")
    pt.wrap(module, "pair_apply_kernel", "pair_kernel")
    try:
        t0 = sync_s()
        n_steps = eng.run(max_steps=n_steps)
        wall = 1e3 * (sync_s() - t0)
    finally:
        pt.restore()
    return {"steps": n_steps, "ms_per_step": wall / n_steps,
            "phase_ms_per_step": {k: v / n_steps for k, v in pt.ms.items()},
            "phase_calls": pt.calls}


def sedov_profile(path, card, device):
    """Path A or C of chip_smoke.py's Sedov blast, from half its run."""
    from swift_subtask_dev_tpu_torch.examples import sedov
    backend, limiter, module = SEDOV_PATHS[path]
    module.LIBRARY.load()
    eng = sedov.make_engine(SEDOV_N, SEDOV_T_END, backend, limiter, device)
    n = int(eng.state["mask"].sum())
    res = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "path": path, "backend": backend,
           "limiter": limiter, "n_particles": n,
           "cdim": list(eng.grid.cdim), "K": eng.grid.K}
    t0 = sync_s()
    eng.init_particles()
    warm = eng.run(SEDOV_T_WARM)
    res["warm"] = {"seconds": sync_s() - t0, "steps": warm,
                   "t": eng.time}
    print("warm", json.dumps(res["warm"]), flush=True)
    rates = []
    for _ in range(3):
        t0 = sync_s()
        steps = eng.run(max_steps=64)
        dt = sync_s() - t0
        rates.append({"seconds": dt, "steps": steps,
                      "ms_per_step": 1e3 * dt / steps})
    res["steady"] = rates
    print("steady", json.dumps(res["steady"]), flush=True)
    res["trace"] = trace(eng, 32, lambda: eng.run(max_steps=32))
    print("trace", json.dumps(res["trace"]), flush=True)
    res["phases"] = sedov_phases(eng, module)
    print("phases", json.dumps(res["phases"]), flush=True)
    res["t"] = eng.time
    return res


def gravity_phases(eng, n_steps):
    """ms per step of the multi-species or DM step's phases over
    ``n_steps`` steps (None: to the end of the run)."""
    from swift_subtask_dev_tpu_torch.ops import species_ghost
    from swift_subtask_dev_tpu_torch.subgrid.star_formation import (
        EagleStarFormation)
    pt = SyncTimer()
    pt.wrap(eng_mod, "_ghost_density", "ghost")
    for name in ("density_loop", "gradient_loop", "force_loop",
                 "p2p_gravity_loop", "timebin_loop",
                 "chemistry_smooth_loop"):
        pt.wrap(hydro_flat, name, name)
    for mod in (eng_mod, engine_multi):
        # each module's own binding (engine_multi imports them by name)
        for name, label in (("_rebucket_phase", "rebucket_phase"),
                            ("_gas_kdk", "kick_timestep_gas"),
                            ("_dm_kdk", "kick_timestep_dm_stars")):
            if hasattr(mod, name):
                pt.wrap(mod, name, label)
    if eng.cooling_fn is not None:
        pt.wrap(eng, "cooling_fn", "cooling")
    # the EAGLE layers: the stars' ghost, feedback and enrichment (their
    # star loops inside them), star formation
    pt.wrap(species_ghost, "species_h_iterate", "star_ghost")
    for name in ("star_ngb_mass_loop", "feedback_apply_loop",
                 "star_kernel_weight_loop", "enrichment_apply_loop"):
        pt.wrap(stencil, name, name)
    pt.wrap(engine_multi, "_feedback", "feedback")
    pt.wrap(engine_multi, "_enrich", "enrichment")
    pt.wrap(engine_multi, "_black_holes", "black_holes")
    pt.wrap(EagleStarFormation, "conversion_mask", "star_formation")
    pt.wrap(engine_multi, "_convert_gas_to_stars", "star_formation")
    pt.wrap(engine_multi, "_mesh_update_multi", "mesh_update")
    pt.wrap(eng_mod, "_mesh_update", "mesh_update")
    pt.wrap(pair_flat, "prepare", "pair_prepare")
    pt.wrap(pair_flat, "pair_apply_kernel", "pair_kernel")
    try:
        t0 = sync_s()
        n_steps = (eng.run() if n_steps is None
                   else eng.run(max_steps=n_steps))
        wall = 1e3 * (sync_s() - t0)
    finally:
        pt.restore()
    return {"steps": n_steps, "ms_per_step": wall / n_steps,
            "phase_ms_per_step": {k: v / n_steps for k, v in pt.ms.items()},
            "phase_calls": pt.calls}


def gravity_profile(path, card, device, n_steps=8):
    """The SmallCosmoVolume or the DMO configuration of chip_smoke.py.

    The volume's nearly uniform IC reaches a = 1 in ~13 steps, so each of
    its windows is a whole run of a fresh engine (init_particles(), then
    run() to a_end, the init left out of the window); the DMO run's
    windows are ``n_steps`` consecutive steps of one engine."""
    import chip_smoke
    pair_flat.LIBRARY.load()

    def build():
        if path in VOLUMES:
            from swift_subtask_dev_tpu_torch.examples import (
                eagle_volume, small_cosmo_volume)
            if path == "cosmo":
                e = small_cosmo_volume.make_engine(device=device)[0]
            else:
                e = eagle_volume.make_engine(
                    device=device, black_holes=path == "eagle-bh")[0]
            return e, sum(int((sp["mask"] > 0).sum())
                          for sp in e.state.values())
        return dmo_engine(device)

    eng, n = build()
    res = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "path": path, "n_particles": n,
           "cdim": list(eng.grid.cdim), "K": eng.grid.K,
           "chip_smoke_steps": {"cosmo": chip_smoke.COSMO_STEPS,
                                "dmo": chip_smoke.DMO_STEPS,
                                "eagle": chip_smoke.EAGLE_STEPS,
                                "eagle-bh": chip_smoke.EAGLE_STEPS}[path]}
    torch.cuda.reset_peak_memory_stats()
    t0 = sync_s()
    eng.init_particles()
    seen = {"n_active": 0}

    def count(d):
        seen["n_active"] += int(d["n_active"])

    def window(e, on_step=None):
        """One window's steps (counted); a volume's: a fresh engine (the
        EAGLE volume's at most chip_smoke's EAGLE_STEPS)."""
        if path in VOLUMES:
            if e is None:
                e = build()[0]
                e.init_particles()
                torch.cuda.synchronize()
            most = res["chip_smoke_steps"] if path != "cosmo" else 10 ** 9
            return e, lambda: e.run(max_steps=most, on_step=on_step)
        return e, lambda: e.run(max_steps=n_steps, on_step=on_step)

    _, run = window(eng)
    steps = run()
    res["warm"] = {"seconds": sync_s() - t0, "steps": steps,
                   "peak_device_GiB":
                       torch.cuda.max_memory_allocated() / 2 ** 30}
    print("warm", json.dumps(res["warm"]), flush=True)
    rates = []
    for _ in range(3):
        seen["n_active"] = 0
        e, run = window(None if path != "dmo" else eng, count)
        t0 = sync_s()
        steps = run()
        dt = sync_s() - t0
        rates.append({"seconds": dt, "steps": steps,
                      "ms_per_step": 1e3 * dt / steps,
                      "particle_steps_per_s": steps * n / dt,
                      "active_updates_per_s": seen["n_active"] / dt})
    res["steady"] = rates
    print("steady", json.dumps(res["steady"]), flush=True)
    e, run = window(None if path != "dmo" else eng)
    pair_flat.reset_launches()
    box = {}

    def traced():
        box["steps"] = run()
    res["trace"] = trace(e, 1, traced)
    k = box["steps"]
    tr = res["trace"]
    tr["steps"] = k
    for key in ("device_kernels_per_step", "other_kernels_ms_per_step",
                "other_kernels_per_step"):
        tr[key] /= k
    for key in ("pair_kernel_ms_per_step", "pair_kernel_launches_per_step"):
        tr[key] = {b: v / k for b, v in tr[key].items()}
    tr["flat_launches_per_step"] = {
        name: v / k for name, v in pair_flat.LAUNCHES.items()}
    print("trace", json.dumps(tr), flush=True)
    e, _ = window(None if path != "dmo" else eng)
    res["phases"] = gravity_phases(
        e, None if path == "cosmo" else res["chip_smoke_steps"]
        if path in VOLUMES else n_steps)
    print("phases", json.dumps(res["phases"]), flush=True)
    return res


def dmo_engine(device):
    """bench.py's BENCH_MODE=dmo configuration on the port (chip_smoke.py
    phase 10)."""
    from swift_subtask_dev_tpu_torch.grid import CellGrid
    from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
    from swift_subtask_dev_tpu_torch.models.gravity import (GravityParams,
                                                            GravitySolver)
    ic = uniform_box_ic(n=N1, jitter=0.2, seed=3)
    gp = GravityParams(G=1.0, eps=0.5 / N1, mesh_N=MESH_N)
    r_cut = gp.r_cut_ratio * gp.a_smooth * 1.0 / gp.mesh_N
    grid = CellGrid.build_columns(ic["box"], interaction_range=r_cut * 1.25,
                                  pos=ic["pos"], headroom=1.4)
    solver = GravitySolver(gp, grid, device=device)
    eng = eng_mod.DMEngine(
        grid, eng_mod.EngineConfig(dt_min=1e-9, dt_max=2e-4,
                                   eta_grav=gp.eta,
                                   p2p_reach=solver.pm.r_cut,
                                   mesh_dt_max=64 * 2e-4),
        0.0, 1.0, gravity_fn=solver.gas_short_range_fn(), eps_soft=gp.eps,
        mesh_fn=solver.gas_mesh_fn(), mesh_dt_scale=solver.pm.r_s,
        device=device)
    eng.solver_builder = lambda g: GravitySolver(gp, g, device=device)
    eng.load_dm(ic["pos"], ic["m"], ic["v"])
    return eng, len(ic["pos"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", default="main",
                    choices=["main"] + sorted(SEDOV_PATHS)
                    + list(GRAVITY_PATHS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = args.out or os.path.join(
        ROOT, "chiprun_out", "torch_profile_step.json" if args.path == "main"
        else f"torch_profile_{args.path}.json")
    if not torch.cuda.is_available():
        print("torch_profile_step: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.path != "main":
        res = (gravity_profile(args.path, card, device)
               if args.path in GRAVITY_PATHS
               else sedov_profile(args.path, card, device))
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps(res))
        return 0
    from chip_smoke import bench_engine
    pair_flat.LIBRARY.load()

    torch.cuda.reset_peak_memory_stats()
    eng, _, _, n = bench_engine(N1, MESH_N, device)
    res = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "n_particles": n,
           "cdim": list(eng.grid.cdim), "W": eng.grid.K,
           "mesh_N": MESH_N}
    t0 = sync_s()
    diag = eng.init_particles()
    res["init"] = {"seconds": sync_s() - t0,
                   "ghost_iterations": int(diag["n_ghost_iter"]),
                   "peak_device_GiB":
                       torch.cuda.max_memory_allocated() / 2 ** 30}
    print("init", json.dumps(res["init"]), flush=True)
    res["steady"] = steady(eng, n)
    print("steady", json.dumps(res["steady"]), flush=True)
    res["trace"] = trace(eng)
    print("trace", json.dumps(res["trace"]), flush=True)
    res["phases"] = phases(eng)
    print("phases", json.dumps(res["phases"]), flush=True)
    res["rebucket"] = rebucket(eng)
    print("rebucket", json.dumps(res["rebucket"]), flush=True)
    res["mesh"] = mesh(eng)
    print("mesh", json.dumps(res["mesh"]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit and no result):

1. Card: require a CUDA device; print its name and power limit
   (nvidia-smi) and the torch/CUDA versions.
2. Build: compile the flat pair kernel (csrc/pair_flat.cu) with nvcc into
   build/ and load it.
3. Kernel vs plain: on the bench IC at n1=24 (27,648 particles), mesh_N=64,
   after init_particles(), run each of the five pair bodies through the
   CUDA kernel and through its plain torch version on the same tensors:
   sums within 1e-5 of max |plain|, maxes equal to 1e-6 relative.  Both
   are timed with CUDA events.
4. Main path at full size: bench.py's default geometry (2*80^3 =
   1,024,000 particles, mesh_N=192): init_particles() + run_fixed_dt(8)
   with every kernel launch counter reset just before.  Checks: finite
   state, converged init ghost, every body launched, the density of a
   sample of particles against a float64 brute-force SPH sum (at the
   engine's h), and the mean neighbour count against the ghost's target
   (which a wrong h would miss).  Then each
   body's kernel against its plain version once more, on the final state
   at the main path's shapes, with the tolerances of phase 3.
5. Prints {"kernels": [...]} (the full-size launches, errors and times)
   and, as the last line, the result object.

Imports nothing of JAX and nothing of the JAX package.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPLACES = "swift_subtask_dev_tpu/ops/pallas_flat.py:268"
SOURCE = "swift_subtask_dev_tpu_torch/csrc/pair_flat.cu"


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def phase_card():
    import torch
    check(torch.cuda.is_available(), "no CUDA device: this script needs a "
          "GPU and has no CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    lib = pair_flat.build_kernels(force=True)
    pair_flat._library()
    print(f"build: nvcc {pair_flat._Lib.build_seconds:.2f} s -> {lib}")
    for line in pair_flat._Lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def bench_engine(n1, mesh_N, device):
    """bench.py:141-183 (uniform IC, SPHENIX + P3M, flat columns)."""
    from swift_subtask_dev_tpu_torch.engine import Engine, EngineConfig
    from swift_subtask_dev_tpu_torch.grid import CellGrid
    from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
    from swift_subtask_dev_tpu_torch.models.gravity import (GravityParams,
                                                            GravitySolver)
    from swift_subtask_dev_tpu_torch.models.sph.sphenix import SPHENIXParams

    ic = uniform_box_ic(n=n1, jitter=0.2, seed=3)
    P = SPHENIXParams(h_max=float(ic["h"].max() * 3))
    gp = GravityParams(G=1.0, eps=0.5 / n1, mesh_N=mesh_N)
    r_cut = gp.r_cut_ratio * gp.a_smooth * 1.0 / gp.mesh_N
    hydro_reach = float(ic["h"].max() * P.kernel.gamma * 1.25)
    grid = CellGrid.build_columns(
        ic["box"], interaction_range=max(hydro_reach, r_cut * 1.15),
        pos=ic["pos"])
    solver = GravitySolver(gp, grid, device=device)
    eng = Engine(grid, P,
                 EngineConfig(dt_max=2e-4, with_self_gravity=True,
                              eps_soft=gp.eps, eta_grav=gp.eta,
                              mesh_dt_max=64 * 2e-4,
                              p2p_reach=solver.pm.r_cut),
                 0.0, 1.0, device=device,
                 gravity_fn=solver.gas_short_range_fn(),
                 mesh_fn=solver.gas_mesh_fn(),
                 mesh_dt_scale=solver.pm.r_s)
    eng.load_particles(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
    return eng, P, solver, len(ic["pos"])


def body_passes(eng, P, solver):
    """The five bodies' passes on the engine's current state."""
    from swift_subtask_dev_tpu_torch.models.sph.sphenix import CosmoFactors
    from swift_subtask_dev_tpu_torch.ops import hydro_flat
    s, cosmo = eng.state, CosmoFactors.no_cosmo()
    fs = solver.gas_short_range_fn().fuse_spec
    return [
        hydro_flat.density_pass(s, P),
        hydro_flat.gradient_pass(s, P, cosmo),
        hydro_flat.force_pass(s, P, cosmo),
        hydro_flat.force_gravity_pass(s, P, cosmo, **fs),
        hydro_flat.p2p_gravity_pass(s, **fs),
    ]


def time_ms(fn, reps, warmup=True):
    """(last result, mean ms per call) over ``reps`` calls, CUDA events."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1) / reps


def compare(out_k, out_p, body):
    """(ok, max_abs_err, worst relative error per output)."""
    import torch
    errs, max_abs = [], 0.0
    ok = True
    for q in range(body.n_sum + body.n_max):
        a, b = out_k[q].double(), out_p[q].double()
        if q < body.n_sum:
            d = (a - b).abs().max().item()
            rel = d / max(b.abs().max().item(), 1e-30)
            ok &= rel <= 1e-5
        else:
            fa, fb = torch.isfinite(a), torch.isfinite(b)
            same_inf = bool(torch.equal(fa, fb)) and bool(
                torch.equal(a[~fa], b[~fb]))
            d = (a[fa] - b[fa]).abs().max().item() if fa.any() else 0.0
            rel = ((a[fa] - b[fa]).abs()
                   / b[fa].abs().clamp_min(1e-30)).max().item() \
                if fa.any() else 0.0
            ok &= same_inf and rel <= 1e-6
        errs.append(rel)
        max_abs = max(max_abs, d)
    return ok, max_abs, errs


def phase_kernel_vs_plain(device, card):
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    eng, P, solver, n = bench_engine(24, 64, device)
    eng.init_particles()
    print(f"phase 3: {n} particles, grid {list(eng.grid.cdim)} "
          f"W={eng.grid.K}")
    results = {}
    for pp in body_passes(eng, P, solver):
        launch = pair_flat.prepare(eng.grid, pp)
        body = pp.body
        out_k, ms = time_ms(
            lambda: pair_flat.pair_apply_kernel(launch, body), 20)
        out_p, plain_ms = time_ms(
            lambda: pair_flat.pair_apply_plain(launch, body), 3)
        ok, max_abs, errs = compare(out_k, out_p, body)
        print(f"  {body.name:14s} ok={ok} max_abs_err={max_abs:.3e} "
              f"rel_errs={[float(f'{e:.2e}') for e in errs]} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms [{card}]")
        check(ok, f"{body.name}: kernel and plain version disagree")
        results[body.name] = ms
    return results


def brute_density(eng, P, n_sample=1024, seed=0):
    """float64 brute-force SPH density of sampled live particles at their
    converged h (all N particles as neighbours, periodic minimum image),
    against the engine's rho: returns (max relative error, sample mean)."""
    import torch
    s = eng.state
    dev = s["mask"].device
    live = (s["mask"] > 0).reshape(-1)
    corners = torch.as_tensor(eng.grid.cell_corners(), dtype=torch.float64,
                              device=dev)
    pos = (corners[:, None, :] + s["off"].double()).reshape(-1, 3)[live]
    box = torch.tensor(eng.grid.box, dtype=torch.float64, device=dev)
    pos = torch.remainder(pos, box)
    m = s["m"].reshape(-1)[live].double()
    h = s["h"].reshape(-1)[live].double()
    rho = s["rho"].reshape(-1)[live].double()
    g = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randperm(pos.shape[0], generator=g)[:n_sample].to(dev)
    gamma = P.kernel.gamma
    norm = 16.0 / math.pi
    out = []
    for c in range(0, n_sample, 32):
        i = idx[c:c + 32]
        d = pos[i][:, None, :] - pos[None, :, :]
        d = d - box * torch.round(d / box)
        r = torch.sqrt((d * d).sum(-1))
        H = gamma * h[i][:, None]
        x = r / H
        w = torch.clamp(1 - x, min=0) ** 3 - 4 * torch.clamp(0.5 - x,
                                                             min=0) ** 3
        out.append((m[None, :] * norm * w / H ** 3).sum(-1))
    ref = torch.cat(out)
    err = ((rho[idx] - ref).abs() / ref).max().item()
    return err, ref.mean().item()


def phase_main_path(device, card, bodies):
    import torch
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    eng, P, solver, n = bench_engine(80, 192, device)
    print(f"phase 4: {n} particles, grid cdim={list(eng.grid.cdim)} "
          f"W={eng.grid.K}, mesh_N=192")
    torch.cuda.synchronize()
    pair_flat.reset_launches()
    t0 = time.perf_counter()
    diag = eng.init_particles()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.run_fixed_dt(8)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(pair_flat.LAUNCHES)
    rate = 8 * n / (t2 - t1)
    print(f"  init_particles {t1 - t0:.3f} s (ghost iterations "
          f"{diag['n_ghost_iter']}), run_fixed_dt(8) {t2 - t1:.3f} s: "
          f"{rate:.1f} particle-steps/s [{card}]")
    print(f"  kernel launches in the main path: {launches}")
    print(f"  peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    s = eng.state
    bad = [k for k, v in s.items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    check(not bad, f"non-finite state fields: {bad}")
    check(diag["n_ghost_iter"] < eng.cfg.max_ghost_iterations,
          f"init ghost did not converge ({diag['n_ghost_iter']} iter)")
    for name in bodies:
        check(launches.get(name, 0) > 0, f"{name}: kernel never launched "
              "in the main path")
    live = s["mask"] > 0
    rho_mean = s["rho"][live].double().mean().item()
    err, ref_mean = brute_density(eng, P)
    print(f"  mean rho {rho_mean:.6f} (IC rho 1); brute-force float64 "
          f"density on 1024 sampled particles: mean {ref_mean:.6f}, max "
          f"relative error {err:.3e}")
    check(err <= 1e-4, "density disagrees with the float64 brute force")

    # candidate j-rows per true neighbour (bench.py:69-88 arithmetic)
    gran = pair_flat.GRAN
    rng = pair_flat._block_ranges(
        eng.grid, s["mask"], s["off"][..., 2], s["h"],
        float(P.kernel.gamma), True, jb=gran,
        reach_floor=float(solver.pm.r_cut))
    cand = ((rng[..., 0] >> 16) & 0xFFFF) + ((rng[..., 1] >> 16) & 0xFFFF)
    live_tiles = int((s["mask"].reshape(eng.grid.C, -1, 128).sum(2)
                      > 0).sum())
    rows_per_tile = float(cand.sum().item()) / max(live_tiles, 1) * gran
    ngb = float((s["wcount"] * (4 / 3 * math.pi)
                 * (s["h"] * P.kernel.gamma) ** 3 * s["mask"]).sum()
                / s["mask"].sum())
    # the ghost's target: 4/3 pi (gamma eta)^3 neighbours; a converged h
    # (|dh| <= h_tolerance h) puts each particle within ~3 h_tolerance of
    # it, so a mean off by more than 1e-3 means a wrong h
    ngb_target = 4 / 3 * math.pi * (P.kernel.gamma * P.eta_neighbours) ** 3
    ngb_err = abs(ngb - ngb_target) / ngb_target
    print(f"  candidate rows per i-tile {rows_per_tile:.1f}, true "
          f"neighbours {ngb:.4f} (target {ngb_target:.4f}, relative "
          f"error {ngb_err:.3e}), candidates per true neighbour "
          f"{rows_per_tile / ngb:.1f}")
    check(ngb_err <= 1e-3, "mean neighbour count is off the ghost's target")

    # kernel vs plain version again, at the main path's own shapes (its
    # final state); the plain version runs once per body (seconds each)
    kernels = []
    for pp in body_passes(eng, P, solver):
        launch, body = pair_flat.prepare(eng.grid, pp), pp.body
        out_k, ms = time_ms(
            lambda: pair_flat.pair_apply_kernel(launch, body), 5)
        out_p, plain_ms = time_ms(
            lambda: pair_flat.pair_apply_plain(launch, body), 1,
            warmup=False)
        ok, max_abs, errs = compare(out_k, out_p, body)
        del out_k, out_p
        print(f"  {body.name:14s} full size: ok={ok} max_abs_err="
              f"{max_abs:.3e} rel_errs={[float(f'{e:.2e}') for e in errs]}"
              f" kernel {ms:.3f} ms plain {plain_ms:.1f} ms [{card}]")
        check(ok, f"{body.name}: kernel and plain version disagree at "
              "the main path's shapes")
        kernels.append({"name": f"pair_flat_{body.name}", "route": "cuda",
                        "source": SOURCE, "replaces": REPLACES,
                        "launches": launches[body.name],
                        "max_abs_err": max_abs, "ms": ms,
                        "plain_ms": plain_ms})
    return kernels


def main():
    try:
        card = phase_card()
        import torch
        sys.path.insert(0, ROOT)
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_build()
        bodies = phase_kernel_vs_plain(device, card)
        kernels = phase_main_path(device, card, bodies)
    except (PhaseFailed, ImportError, RuntimeError, ValueError,
            OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

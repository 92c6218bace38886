#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's main path, on one GPU.

    python3 tools/torch_profile_step.py [--out PATH]

Runs bench.py's default geometry (2*80^3 = 1,024,000 particles, SPHENIX
+ P3M on the flat column grid, mesh_N = 192, the PM mesh on its own
step) through the port, and
measures, in this order:

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

The last line printed is a JSON object with every number; it is also
written to ``--out`` (default ``chiprun_out/torch_profile_step.json``).  Imports nothing of JAX.
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

from swift_subtask_dev_tpu_torch import engine as eng_mod  # noqa: E402
from swift_subtask_dev_tpu_torch.ops import hydro_flat, pair_flat  # noqa

N1, MESH_N = 80, 192      # bench.py's default geometry
BODIES = ("Density", "Gradient", "ForceGravity", "Force", "P2PGravity")


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


def trace(eng, n_steps=4):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # device activity only: host-side op tracing would slow the launches
    # and so lower the busy share it is meant to read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_fixed_dt(n_steps, per_launch=n_steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.elapsed_us() >= 0]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = _merged_busy(intervals) / 1e3
    per_body = {b: 0.0 for b in BODIES}
    other_ms, other_n = 0.0, 0
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        body = next((b for b in BODIES
                     if f"pair_flat_kernel<{b}," in e.name), None)
        if body is None:
            other_ms += ms
            other_n += 1
        else:
            per_body[body] += ms
    return {
        "steps": n_steps, "wall_ms": wall_ms,
        "device_kernels_per_step": len(kernels) / n_steps,
        "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms if wall_ms > 0 else None,
        "pair_kernel_ms_per_step": {b: v / n_steps
                                    for b, v in per_body.items()},
        "other_kernels_ms_per_step": other_ms / n_steps,
        "other_kernels_per_step": other_n / n_steps,
    }


class PhaseTimer:
    """Wraps module functions so each call is synchronised at both edges
    and its wall time is summed per name."""

    def __init__(self):
        self.ms = {}
        self.calls = {}
        self._undo = []

    def wrap(self, module, attr, name):
        orig = getattr(module, attr)

        def timed(*a, **kw):
            t0 = sync_s()
            out = orig(*a, **kw)
            dt = sync_s() - t0
            self.ms[name] = self.ms.get(name, 0.0) + 1e3 * dt
            self.calls[name] = self.calls.get(name, 0) + 1
            return out

        setattr(module, attr, timed)
        self._undo.append((module, attr, orig))

    def restore(self):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()


def phases(eng, n_steps=8):
    pt = PhaseTimer()
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "torch_profile_step.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_step: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import bench_engine
    card = card_name()
    print(card)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
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
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit and no result):

1. Card: require a CUDA device; print its name and power limit
   (nvidia-smi) and the torch/CUDA versions.
2. Build: compile the flat pair kernel (csrc/pair_flat.cu, with the cost
   probe's bodies, and once more for each of its SPH modes: a scheme
   struct under a smoothing kernel, 59 libraries for the 65 modes, as
   Planetary's modes run Minimal's), the packed 27-cell pair kernel
   (csrc/pair_packed.cu),
   the ring-buffer 27-cell pair kernel (csrc/pair_ring.cu; both on the
   walk of csrc/walk27.cuh) and the FP32 probe (csrc/vpu_peak.cu) with
   nvcc into build/, one nvcc process each, started together, and load
   them all.  For each entry of the flat kernel print its registers,
   spills (ptxas), local memory, shared memory per block and resident
   blocks per SM (the 27-cell kernels' at each hold, phases 5 and 7).
3. Kernel vs plain: on the bench IC at n1=24 (27,648 particles), mesh_N=64,
   after init_particles(), run each of the five flat pair bodies through
   the CUDA kernel and through its plain torch version on the same
   tensors: sums within 1e-5 of max |plain|, maxes equal to 1e-6
   relative.  Both are timed with CUDA events.  The pairs each warp of
   the kernel evaluates (its walk statistics) equal the plain version's
   accepted pairs over the slots the warp walks (``pair_flat.warp_pairs``):
   its filter drops no accepted pair and it evaluates no other; a launch
   with statistics gives the same bits.  So does every later flat hold.
4. Main path at full size: bench.py's default geometry (2*80^3 =
   1,024,000 particles, mesh_N=192): init_particles() + run_fixed_dt(8)
   with every kernel launch counter reset just before.  Checks: finite
   state, converged init ghost, every body launched, the density of a
   sample of particles against a float64 brute-force SPH sum (at the
   engine's h), and the mean neighbour count against the ghost's target
   (which a wrong h would miss).  Then each body's kernel against its
   plain version once more, on the final state at the main path's
   shapes, with the tolerances of phase 3, its walk statistics and lane
   utilisation (accepted pairs over 32 lanes x rounds) and, for
   force+gravity and density, two launches on the same inputs that must
   give the same bits.
5. Sedov blast, path A (the example's configuration: 27-cell grid,
   backend "pallas", the packed kernel K2, no timestep limiter): the
   port's example at n = 51 (2*51^3 = 265,302 particles, dt_max = 1e-3),
   init_particles() + run(SEDOV_T_END) with the launch counters reset
   just before.  Checks: finite state, the example's shock radius rule
   (within 10% of Sedov's), >= 3 time bins populated at some step, every
   re-grid made through the step's retry or its occupancy trigger, every
   K2 body launched; each K2 body's kernel against its plain version
   (tolerances of phase 3) on the final state, all active, and on the
   particles active one smallest step before the end, through the active
   subset (``hold_27``): its pairs per warp equal the plain version's, a
   launch with statistics and a second launch give the same bits, and
   its kept-row share, lane utilisation and build are printed.  Without
   the limiter the
   blast loses ~50% of its energy in its first steps at this resolution,
   on either backend, so the example's energy rule (drift below 5%) is
   held on path B, and path A's drift and shock radius are held within
   1% of the same run on the flat backend without the limiter.
6. Sedov blast, path B (the CLI's --hydro --limiter configuration: column
   grid, backend "flat" with the timestep limiter, as SWIFT runs
   SedovBlast_3D): the same IC and run, the same checks plus the
   example's energy rule, wakes (sum of n_woken > 0) and the timebin
   body launched; then the flat bodies the path runs against their plain
   versions on its final state, the timebin body bit for bit (on the
   particles active one smallest step before the end).
7. Sedov blast, path C (the CLI's --hydro --limiter --backend
   pallas_ring configuration: 27-cell grid, the ring-buffer kernel K3,
   the limiter's 27-cell stencil.timebin_loop): the same IC and run, the
   checks of path B (energy rule, wakes) and every K3 body launched; then
   each K3 body's kernel against its plain version as K2's on path A.
8. Probes: the FP32 probe's kernel against its plain version on the
   reference's (256, 128) tile at 2 x 64 steps (relative tolerance
   vpu_peak.tolerance), then its entry point (tile and full-card rates);
   the cost probe's six synthetic bodies on the flat kernel against their
   plain versions on the bench geometry (93,312 particles), then its
   entry point (ms per body).  The launch counters are reset just before
   each entry point and read just after.
9. SmallCosmoVolume (gas + DM, comoving, P3M with split mesh kicks,
   constant-Lambda cooling, flat backend): the port's example at
   SWIFT's SmallCosmoVolume_hydro size (2 x 64^3 = 524,288 particles in
   100 Mpc/h), init_particles() and run() with the launch counters
   reset just before (at most COSMO_STEPS steps; this IC reaches a = 1
   in fewer).  Checks: finite state, every K1 body of
   the path launched (density, gradient, force, P2P on one species and
   across species), a advanced, physical u at or above the minimal
   internal energy, a float64 brute-force density on 1,024 gas particles
   active in the last step (<= 1e-4), the float64 brute-force
   erfc-truncated short-range acceleration (within r_cut over periodic
   images) of 1,024 DM from the gas and of 1,024 gas from the DM against
   the port's cross-species P2P loop (<= 1e-4 of max); then the
   cross-species kernel against its plain version in both directions at
   the path's final state (tolerances of phase 3, pairs per warp equal,
   a statistics launch and a second launch bit for bit).
10. DMO: bench.py's BENCH_MODE=dmo geometry (1,024,000 particles,
   mesh_N 192, headroom 1.4) through DMEngine, init_particles() and
   DMO_STEPS steps: ms per step and particle-steps/s, only K1's P2P body
   launched, and the brute-force acceleration check of phase 9 on 1,024
   particles.
11. EAGLE volume without black holes (the port's example at run.yml's
   size: 256,902 gas, 262,144 DM and 5,242 stars in 25 Mpc; EAGLE
   cooling with the entropy floor, chemistry smoothing on K1's chemistry
   body, the stars' ghost, star formation, thermal feedback, enrichment,
   the limiter): init_particles() and run() for at most EAGLE_STEPS
   steps with the launch counters reset just before; ms per step,
   particle-steps/s, active-particle updates/s, wakes, heating events,
   conversions, n_lost and peak memory.  Checks: finite state, every K1
   body of the path launched (the timebin and chemistry bodies among
   them), float64 brute force on the final state (density of 1,024 gas
   particles active in the last step <= 1e-4; the chemistry-smoothed Z
   of 1,024 gas particles <= 1e-4 of max; the short-range accelerations
   of 1,024 stars from the gas and of 1,024 gas from the stars <= 1e-4
   of max; every star's
   neighbour mass <= 1e-5 outside pairs at rounding distance from the
   kernel's edge); the chemistry body against its pair plain version
   (tolerances of phase 3, pairs per warp equal, a statistics launch and
   a second launch bit for bit) and against the stencil-form plain
   version (<= 1e-5 of max).  Then the aged-stars pass: a fresh volume
   whose loaded stars, after init, are just older than the SNII delay
   and in the gas's smallest bin, 2 steps with each layer timed
   (synchronised): heated gas > 0 with each jump heating events x
   delta_u exactly, enriched mass > 0, total mass conserved to 1e-6.
   Last, the committed table of the reference's RNG draws
   (``utils/rng_table.json``) reproduced bit for bit on the card.
12. EAGLE volume with its black hole (``--black-holes``: the example's
   volume with make_ics.py's seed BH, 524,289 particles, the BH K1's
   fourth species, 16 P2P launches a gravity pass): init_particles() and
   run() for at most EAGLE_STEPS steps with the launch counters reset
   just before; ms per step and the BH block's (synchronised).  Checks:
   finite state, every K1 body of the path launched and 16 P2P launches
   a pass, total mass (float64) unchanged to 1e-6, the BH's density sums
   (rho, mom0-2, cs_w) against a float64 brute force over the gas (1e-5
   of max) and its neighbour mass (1e-5 outside pairs at rounding
   distance from the kernel's edge).  Then the active-BH pass: a fresh
   volume with 48 BHs beside gas particles (3 gas masses short of their
   subgrid masses), 8 bound pairs 0.05 Mpc apart and the seed, every
   reservoir 1.5 x the AGN threshold, all in the gas's smallest bin, 2
   steps with each layer timed: swallows, AGN events, one merger a pair,
   repositions within max_reposition_distance_ratio x eps; in float64
   the BHs' gain equals the swallowed mass (1e-6), the total mass is
   unchanged (1e-6) and each BH's momentum is its momentum before plus
   its swallowed gas's (1e-5 of the largest); each heated particle's
   jump events x delta_u exactly; no swallowed particle became a star;
   K1's density on the compacted gas near the BHs against the float64
   brute force (1e-4).
13. K1's SPH modes on the main path: bench.py's geometry (1,024,000
   particles, P3M, split mesh) under each of SCHEME_RUNS (Minimal,
   Gadget2, Pressure-Energy, Pressure-Entropy, Pressure-Energy-Monaghan,
   Phantom, Gasoline and None with the cubic spline, Anarchy-PU with
   Wendland C2), init_particles() + run_fixed_dt(SCHEME_STEPS) with the
   launch counters reset just before: ms per step, finite state, total
   mass unchanged, every body of the mode launched, the float64
   brute-force density of 1,024 particles (<= 1e-4; the kernel's own
   polynomial) and, for the pressure-energy schemes, the smoothed
   pressure of a fresh density pass (Pressure-Entropy: its weighted
   density rho_bar; <= 1e-4); for None, a_hydro and u_dt exactly 0 and
   u unchanged per particle (gravity alone moves the particles); each
   body (density, gradient where the scheme has one, force, force +
   gravity) against its plain version (phase 3's tolerances,
   hold_walk).
   Then the Planetary phase: the reference's mixed-material box
   (tests/test_planetary.py:102) at the main path's size
   (uniform_box_ic(n=80, jitter=0.05, seed=11): 1,024,000 particles in
   1 m^3, masses x 998, ideal gas and Tillotson water alternating, u =
   1e3, dt_max = 1e-7, no gravity), init_particles() + PLANETARY_STEPS
   steps with the launch counters reset just before, then one step with
   its rebucket forced and a re-grid: finite state, P >= 0, energy drift
   < 2e-4 (the reference test's rule), mass unchanged, mat_id int32 and
   its multiset unchanged after each rebucket, Minimal's bodies (its
   libraries) launched and held against their plain versions on
   Planetary's fields.
14. The Sod shock (the port's examples/sodshock.py, flat backend, n =
   SOD_N = 64: 147,456 particles, to t = 0.2) for each hydro scheme with
   the cubic spline and Anarchy-PU with Wendland C2: steps, ms per step,
   L1(rho)/mean, L1(vx), energy drift; L1(rho) no larger than the
   reference's own at n = 32 (SOD_REFERENCE_L1); finite state, mass
   unchanged, every body launched, each held against its plain version
   on the final state (each slot's sums within (2 n + 8) 2^-24 of its
   sum_j |term_j|, n its pairs: the f32 sums' rounding bound, ``compare``;
   maxes as phase 3: the tube's transverse sums cancel to ~0), with
   force + gravity where no earlier phase holds that mode's.  Then each
   scheme's cubic-spline Sod at SOD_HOLD_N = 32 to t = 0.2, and each
   scheme under each of the five other kernels on its final state (None
   on SPHENIX's): the particles on a column grid for the kernel,
   init_particles() (every body launched), each body and force + gravity
   held the same way.
15. Prints {"kernels": [...]} (each kernel's launches on its path, errors,
   times, and its bound: the larger of the bytes it must move -- the
   particles' fields it reads, the output slots it writes and the index
   words it reads -- over 3.35 TB/s and its FP32 operations on the run's
   true pairs over 67 TFLOP/s; K2's and K3's at the final state; one
   entry per K1 mode and body, from the first path that held it) and,
   as the last line, the result object.

Imports nothing of JAX and nothing of the JAX package.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAT_SOURCE = "swift_subtask_dev_tpu_torch/csrc/pair_flat.cu"
FLAT_REPLACES = "swift_subtask_dev_tpu/ops/pallas_flat.py:268"
PACKED_SOURCE = "swift_subtask_dev_tpu_torch/csrc/pair_packed.cu"
PACKED_REPLACES = "swift_subtask_dev_tpu/ops/pallas_packed.py:48"
RING_SOURCE = "swift_subtask_dev_tpu_torch/csrc/pair_ring.cu"
RING_REPLACES = "swift_subtask_dev_tpu/ops/pallas_pairs.py:93"
VPU_SOURCE = "swift_subtask_dev_tpu_torch/csrc/vpu_peak.cu"
VPU_REPLACES = "tools/vpu_peak.py:19"
PROBE_SOURCE = "swift_subtask_dev_tpu_torch/csrc/probe_bodies.cuh"
PROBE_REPLACES = "tools/probe_kernel.py:26"

SEDOV_N = 51            # 2 * 51^3 = 265,302 particles
COSMO_STEPS = 32        # the SmallCosmoVolume phase's most steps
# the K1 bodies the SmallCosmoVolume path runs (the multi engine does not
# fuse gravity into the force pass)
COSMO_BODIES = ("density", "gradient", "force", "p2p_gravity",
                "p2p_gravity_cross")
DMO_STEPS = 8
EAGLE_STEPS = 16        # the EAGLE volume phase's most steps
# the K1 bodies of the EAGLE volume's path (the limiter's timebin body and
# the chemistry body among them)
EAGLE_BODIES = COSMO_BODIES + ("timebin", "chem_smooth")
CHEM_REPLACES = "swift_subtask_dev_tpu/ops/stencil.py:597"
# the example's default end time: the shock radius is 0.347 (18 h of
# the IC); much later the shell nears the periodic box's faces
SEDOV_T_END = 0.05

# H100 SXM published peaks (NVIDIA's data sheet, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# the SPH modes phase 13 drives on the main path (SPH:scheme, SPH:kernel)
SCHEME_RUNS = (("minimal", "cubic-spline"), ("gadget2", "cubic-spline"),
               ("pressure-energy", "cubic-spline"),
               ("anarchy-pu", "wendland-C2"),
               ("pressure-entropy", "cubic-spline"),
               ("pressure-energy-monaghan", "cubic-spline"),
               ("phantom", "cubic-spline"), ("gasoline", "cubic-spline"),
               ("none", "cubic-spline"))
SCHEME_STEPS = 8
# phase 14: the Sod shock at SOD_N (the reference example's default) to
# SOD_T_END for each hydro scheme with the cubic spline and Anarchy-PU
# with Wendland C2; every other mode (scheme and kernel) on the developed
# state of its scheme's cubic-spline Sod at SOD_HOLD_N (None's on
# SPHENIX's: it has no hydrodynamics to develop one).  At SOD_N those
# holds took 677 s of the card (the plain versions are dense over a
# column's rows: their cost grows as n^4), at 48 355 s for 24 modes; at
# 32, ~0.2 of that, they leave room for the 25 modes of the last five
# schemes inside the script's 1,200 s limit.
SOD_N = 64              # 147,456 particles
SOD_HOLD_N = 32         # 18,432 particles
SOD_T_END = 0.2
SOD_RUNS = (("sphenix", "cubic-spline"), ("minimal", "cubic-spline"),
            ("gadget2", "cubic-spline"), ("pressure-energy", "cubic-spline"),
            ("anarchy-pu", "cubic-spline"), ("anarchy-pu", "wendland-C2"),
            ("pressure-entropy", "cubic-spline"),
            ("pressure-energy-monaghan", "cubic-spline"),
            ("phantom", "cubic-spline"), ("gasoline", "cubic-spline"))
# the developed state each scheme's other modes are held on, when not its
# own Sod's
HOLD_STATE_OF = {"none": "sphenix"}
# The reference's own L1(rho)/mean at n = 32, t = 0.2, per (scheme,
# kernel), measured once by tools/sod_reference_l1.py (the JAX package's
# engine, flat backend on the column grid, on a CPU); phase 14's runs at
# n = 64 must not exceed them
SOD_REFERENCE_L1 = {
    ("sphenix", "cubic-spline"): 0.021402254045508138,
    ("minimal", "cubic-spline"): 0.020912282075643485,
    ("gadget2", "cubic-spline"): 0.02202661753953336,
    ("pressure-energy", "cubic-spline"): 0.018364279939943665,
    ("anarchy-pu", "cubic-spline"): 0.019490807267347223,
    ("anarchy-pu", "wendland-C2"): 0.02535542262843186,
    ("pressure-entropy", "cubic-spline"): 0.020823598528212767,
    ("pressure-energy-monaghan", "cubic-spline"): 0.018554056471902197,
    ("phantom", "cubic-spline"): 0.028636457208474575,
    ("gasoline", "cubic-spline"): 0.026240660470888064}
# the Planetary phase: the reference's mixed-material box
# (tests/test_planetary.py:102) at the main path's size, SI units
PLANETARY_N = 80        # 1,024,000 particles in 1 m^3
PLANETARY_STEPS = 8
# FP32 operations per accepted pair of each body, counted from
# csrc/pair_bodies.cuh: each add, multiply, compare, select, min/max,
# divide, sqrt, rsqrt and exp counts one; the separation and r2, the
# pair mask and the accumulation into the outputs are included
OPS_PER_PAIR = {"density": 78, "gradient": 63, "force": 167,
                "force_gravity": 243, "p2p_gravity": 82, "timebin": 22,
                # 14 separation + r2, 2 pair mask, 3 range test, 2 u2,
                # 1 sqrt, 17 cubic spline, 1 m w, 10 products + 10 sums
                "chem_smooth": 60,
                # the cost probe's bodies (csrc/probe_bodies.cuh): 14 for
                # the separation and r2, 2 for the pair mask, 1 for the
                # sum, plus each body's own
                "probe_a00": 18, "probe_a": 18, "probe_b": 26,
                "probe_c": 131, "probe_d": 37, "probe_e": 39}
# K1's SPH modes, counted from csrc/pair_bodies.cuh as above.  A mode's
# body is a frame that every scheme shares (MODE_FRAME_OPS: the
# separation and r2, the pair mask, the range test; density's eight sums
# and gradient's two maxes; force's neighbour bin and the sums of its
# outputs; force + gravity's gravity) and its scheme struct's hooks
# (MODE_HOOK_OPS).  A hook's entry is its operations beside the smoothing
# kernel and its kernel evaluations, each DEVAL_OPS of the mode's kernel
# (x = u gamma_inv and the two normalisations, 3; a truncated-power term
# of degree d, d + 3, and 2 to add each further term; a Wendland branch
# of N coefficients, 4 (N - 1) for Horner and 5 for the clamps).
# SPHENIX with the cubic spline gives OPS_PER_PAIR's counts.
DEVAL_OPS = {"cubic-spline": 17, "quartic-spline": 28,
             "quintic-spline": 31, "wendland-C2": 28, "wendland-C4": 40,
             "wendland-C6": 52}
MODE_FRAME_OPS = {"density": 61, "gradient": 39, "force": 27,
                  "force_gravity": 103}
# (scheme struct, hook): "density", the density's kernel evaluation and
# the scheme's extra sums (each product, the sum into the output; a
# product that several outputs share counted once; Pressure-Entropy's
# A_j^{1/gamma}: a max and a pow); "gradient", its sums (SPHENIX's
# laplace_u; Phantom's 0, with no kernel evaluation; Gasoline's shock
# limiter and correction weight); "force", for force and force + gravity
# alike, pair_kinematics (44 beside its two kernel evaluations) and the
# scheme's force terms (None has neither)
MODE_HOOK_OPS = {
    ("Sphenix", "density"): (0, 1), ("Sphenix", "gradient"): (7, 1),
    ("Sphenix", "force"): (106, 2),
    ("Minimal", "density"): (0, 1), ("Minimal", "force"): (75, 2),
    ("Gadget2", "density"): (0, 1), ("Gadget2", "force"): (64, 2),
    ("PressureEnergy", "density"): (6, 1),
    ("PressureEnergy", "force"): (88, 2),
    ("AnarchyPU", "density"): (6, 1), ("AnarchyPU", "gradient"): (7, 1),
    ("AnarchyPU", "force"): (103, 2),
    ("PressureEntropy", "density"): (8, 1),
    ("PressureEntropy", "force"): (86, 2),
    ("PressureEnergyMM", "density"): (6, 1),
    ("PressureEnergyMM", "force"): (92, 2),
    ("Phantom", "density"): (0, 1), ("Phantom", "gradient"): (1, 0),
    ("Phantom", "force"): (90, 2),
    ("Gasoline", "density"): (30, 1), ("Gasoline", "gradient"): (13, 1),
    ("Gasoline", "force"): (85, 2),
    ("NoneScheme", "density"): (0, 1), ("NoneScheme", "force"): (0, 0)}


def ops_per_pair(body):
    """FP32 operations per accepted pair of ``body`` in its mode."""
    if not body.mode:
        return OPS_PER_PAIR[body.name]
    from swift_subtask_dev_tpu_torch.ops.pair_flat import SCHEME_STRUCTS
    scheme, kernel = body.mode.split("/")
    hook = "force" if body.name == "force_gravity" else body.name
    ops, devals = MODE_HOOK_OPS[SCHEME_STRUCTS[scheme], hook]
    return MODE_FRAME_OPS[body.name] + ops + devals * DEVAL_OPS[kernel]


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


# the flat kernel's body structs (csrc/pair_bodies.cuh, probe_bodies.cuh;
# the SPH bodies are templates over the scheme and the kernel)
FLAT_STRUCTS = {"DensityT": "density", "GradientT": "gradient",
                "ForceT": "force", "ForceGravityT": "force_gravity",
                "P2PGravity": "p2p_gravity", "Timebin": "timebin",
                "ProbeA00": "probe_a00", "ProbeA": "probe_a",
                "ProbeB": "probe_b", "ProbeC": "probe_c",
                "ProbeD": "probe_d", "ProbeE": "probe_e"}


def _skip_template_args(rest, i):
    """Past a mangled template argument list I<len><name>...E at i."""
    import re
    if not rest[i:].startswith("I"):
        return i
    i += 1
    while i < len(rest) and rest[i] != "E":
        d = re.match(r"\d+", rest[i:])
        if d is None:
            return i
        i += len(d.group(0)) + int(d.group(0))
    return i + 1


def ptxas_spills(log):
    """{body name: ptxas's stack/spill line} of one flat kernel library's
    production instantiations (a mangled name holds the body, its
    template arguments and the statistics flag:
    pair_flat_kernelI<length><struct>[I...E]Lb0)."""
    import re
    out, body = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"pair_flat_kernelI(\d+)", m.group(1))
            body = None
            if k:
                rest = m.group(1)[k.end():]
                n = int(k.group(1))
                if rest[_skip_template_args(rest, n):].startswith("Lb0"):
                    body = FLAT_STRUCTS.get(rest[:n])
        elif body and "spill stores" in line:
            out[body] = line.strip()
            body = None
    return out


def phase_build(card):
    from swift_subtask_dev_tpu_torch.ops import cuda_build, pair_flat
    from swift_subtask_dev_tpu_torch.ops import pair_packed, pair_ring
    from swift_subtask_dev_tpu_torch.probes import vpu_peak
    modes = pair_flat.all_modes()
    mode_libs = pair_flat.mode_libraries()
    libs = [pair_flat.LIBRARY, pair_packed.LIBRARY, pair_ring.LIBRARY,
            vpu_peak.LIBRARY] + mode_libs
    t0 = time.perf_counter()
    paths = cuda_build.build_all(libs, force=True)
    for lib, path in zip(libs, paths):
        lib.load()
        print(f"build: nvcc {lib.build_seconds:.2f} s -> {path}")
        if lib in (pair_packed.LIBRARY, pair_ring.LIBRARY,
                   vpu_peak.LIBRARY):
            for line in lib.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip())
    print(f"build: {len(libs)} libraries (K1's {len(mode_libs)} SPH mode "
          f"libraries among them, for its {len(modes)} modes) in "
          f"{time.perf_counter() - t0:.2f} s, one nvcc each, all started "
          f"together")
    print(f"flat kernel entries [{card}]:")
    printed = set()
    for mode in ("",) + modes:
        lib = pair_flat.mode_library(mode)
        if id(lib) in printed:      # a mode sharing another's library
            print(f"  mode {mode}: the library of "
                  f"{pair_flat.SCHEME_STRUCTS[mode.split('/')[0]]}")
            continue
        printed.add(id(lib))
        spills = ptxas_spills(lib.build_log)
        names = (pair_flat.BODY_NAMES + pair_flat.PROBE_BODY_NAMES
                 if not mode else pair_flat.mode_body_names(mode))
        for name in names:
            a = pair_flat.kernel_attributes(name, mode)
            key = name + (f"[{mode}]" if mode else "")
            print(f"  pair_flat_{key}: {a['registers']} registers, "
                  f"{a['local_bytes']} local bytes/thread, shared "
                  f"{a['static_smem']} static + {a['dynamic_smem']} "
                  f"dynamic bytes/block, {a['blocks_per_sm']} blocks/SM, "
                  f"window {a['window']} rows, {a['stages']} stages of "
                  f"{a['chunk_rows']} rows; ptxas: "
                  f"{spills.get(name, 'not found')}")


def bench_engine(n1, mesh_N, device, scheme="sphenix",
                 kernel="cubic-spline"):
    """bench.py:141-183 (uniform IC, SPH + P3M, flat columns), SPHENIX
    with the cubic spline as bench.py runs it, or another SPH:scheme and
    SPH:kernel in its place (the entropy schemes' u slot holds the
    entropy, from the IC's density 1)."""
    from swift_subtask_dev_tpu_torch.engine import Engine, EngineConfig
    from swift_subtask_dev_tpu_torch.grid import CellGrid
    from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
    from swift_subtask_dev_tpu_torch.models.gravity import (GravityParams,
                                                            GravitySolver)
    from swift_subtask_dev_tpu_torch.models.sph import SCHEMES, u_is_entropy
    from swift_subtask_dev_tpu_torch.models.sph.kernels import KERNELS
    import numpy as np

    ic = uniform_box_ic(n=n1, jitter=0.2, seed=3)
    P = SCHEMES[scheme](kernel=KERNELS[kernel],
                        h_max=float(ic["h"].max() * 3))
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
    eng.solver_builder = lambda g: GravitySolver(gp, g, device=device)
    u = ic["u"]
    if u_is_entropy(P):
        u = P.mod.entropy_from_internal_energy(
            P, np.ones_like(u), u).numpy()
    eng.load_particles(ic["pos"], ic["m"], ic["v"], u, ic["h"])
    return eng, P, solver, len(ic["pos"])


def body_passes(eng, P, solver):
    """The five bodies' passes on the engine's current state."""
    from swift_subtask_dev_tpu_torch.models.sph.sphenix import CosmoFactors
    from swift_subtask_dev_tpu_torch.ops import hydro_flat
    fs = solver.gas_short_range_fn().fuse_spec
    return (sph_passes(eng.state, P, CosmoFactors.no_cosmo(), fs)
            + [hydro_flat.p2p_gravity_pass(eng.state, **fs)])


def sph_passes(s, P, cosmo, fuse_spec=None):
    """The SPH bodies of P's mode on the state ``s``: density, gradient
    (when the scheme has one), force and, with ``fuse_spec``, force +
    gravity."""
    from swift_subtask_dev_tpu_torch.ops import hydro_flat
    out = [hydro_flat.density_pass(s, P)]
    if P.mod.HAS_GRADIENT_LOOP:
        out.append(hydro_flat.gradient_pass(s, P, cosmo))
    out.append(hydro_flat.force_pass(s, P, cosmo))
    if fuse_spec is not None:
        out.append(hydro_flat.force_gravity_pass(s, P, cosmo, **fuse_spec))
    return out


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


F32_U = 2.0 ** -24      # the unit roundoff of float32


def compare(out_k, out_p, body, abs_sums=None, slot_pairs=None):
    """(ok, max_abs_err, worst relative error per output).  Sums within
    1e-5 of max |plain|; or, with ``abs_sums`` (the plain version's
    sum_j |term_j| per slot, ``abs_body``) and ``slot_pairs`` (its
    accepted pairs per slot), each slot within (2 n + 8) u of its own sum
    of magnitudes (the relative error printed is in that unit), n the
    slot's pairs and u = 2^-24.  Both versions evaluate the same f32 pair
    terms (bit for bit: tools/torch_sum_order.py), and an f32 sum of n
    terms parts from the exact sum by at most (n - 1) u sum|t| (the
    kernel adds a slot's terms one by one, the plain version each
    offset's rows by torch.sum).  Where a state's sums cancel (a shock
    tube's transverse accelerations) a fraction of max would hold that
    rounding to the wrong scale.  A live Sod slot accepts ~60 pairs
    (<= 7.6e-6 of sum|t|); an empty one, pad-filled (h = 1), every row of
    its nine columns: thousands, summed one by one."""
    import torch
    errs, max_abs = [], 0.0
    ok = True
    for q in range(body.n_sum + body.n_max):
        a, b = out_k[q].double(), out_p[q].double()
        if q < body.n_sum:
            d = (a - b).abs().max().item()
            if abs_sums is None:
                rel = d / max(b.abs().max().item(), 1e-30)
                ok &= rel <= 1e-5
            else:
                scale = abs_sums[q].double()
                rel = ((a - b).abs() / scale.clamp_min(1e-30)).max().item()
                tol = (2.0 * slot_pairs.double() + 8.0) * F32_U * scale
                ok &= bool(torch.all((a - b).abs() <= tol))
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


def bound(body, work, pairs):
    """(bound_ms, bound_by): the least time the card could take for one
    pass: the live particles' fields read once, the output slots the
    kernel writes written once and the index words it reads (counts,
    range words) read once over the memory rate, against the FP32
    operations of the pass's true pairs over the FP32 rate.  ``work`` is
    (live particles, written output slots, index bytes); padded slots,
    which the kernels never read, are not counted."""
    n_live, n_written, index_bytes = work
    n_bytes = 4 * (n_live * len(body.fields)
                   + n_written * (body.n_sum + body.n_max)) + index_bytes
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = pairs * ops_per_pair(body) / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def body_key(body):
    """A body's name with its SPH mode (``pair_flat.body_key``)."""
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    return pair_flat.body_key(body)


def abs_body(body):
    """``body`` with the absolute value of each pair term in its sums: its
    plain version gives each slot's sum_j |term_j| (``compare``)."""
    import dataclasses
    import torch

    def fn(sf, nf, dx, r2):
        ok, sums, maxes = body.fn(sf, nf, dx, r2)
        return ok, [torch.abs(v) for v in sums], maxes
    return dataclasses.replace(body, fn=fn)


def hold_against_plain(module, launch, body, card, exact=False, reps=5,
                       per_slot=False):
    """Kernel vs plain version on one launch: times (CUDA events), the
    comparison (``per_slot``: each sum against its slot's sum of
    magnitudes, ``compare``), the true pairs the plain version counts,
    and the kernel's walk (``hold_walk``)."""
    import torch
    out_k, ms = time_ms(lambda: module.pair_apply_kernel(launch, body),
                        reps)
    stats = {}
    out_p, plain_ms = time_ms(
        lambda: module.pair_apply_plain(launch, body, stats), 1,
        warmup=False)
    if exact:
        ok = bool(torch.equal(out_k, out_p))
        max_abs = 0.0 if ok else float("inf")
        errs = [0.0 if ok else float("inf")]
    else:
        abs_sums = (module.pair_apply_plain(launch, abs_body(body))
                    if per_slot else None)
        ok, max_abs, errs = compare(out_k, out_p, body, abs_sums,
                                    stats.get("slot_pairs"))
        del abs_sums
    del out_p
    key = body_key(body)
    print(f"  {key:14s} ok={ok} max_abs_err={max_abs:.3e} "
          f"rel_errs{'_per_slot' if per_slot else ''}="
          f"{[float(f'{e:.2e}') for e in errs]} kernel "
          f"{ms:.4f} ms plain {plain_ms:.1f} ms true pairs "
          f"{stats['pairs']} [{card}]")
    check(ok, f"{key}: kernel and plain version disagree"
          + (" (must be bit-identical)" if exact else ""))
    hold_walk(module, launch, body, out_k, stats, card)
    del out_k
    return ms, plain_ms, max_abs, stats["pairs"]


def entry(name, route_source, replaces, launches, max_abs, ms, plain_ms,
          bound_ms, bound_by):
    """One kernel of the {"kernels": ...} line."""
    return {"name": name, "route": "cuda", "source": route_source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}   # no single PyTorch call computes these


def flat_work(launch, body):
    """Live particles, written slots and index bytes of one flat launch:
    the kernel reads each column's live-tile count and the 9 x 2 range
    words of each live tile, and writes all 128 slots of a live tile.  A
    cross-species launch also reads the j species' live rows."""
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    live_tiles = int(launch.tcounts.sum())
    mask = body.fields.index("mask")
    n_live = int((launch.Xi[mask] > 0).sum())
    if launch.cross:
        n_live += int((launch.Xa[:, mask] > 0).sum())
    return (n_live, live_tiles * pair_flat.LANES,
            4 * (launch.tcounts.numel() + 18 * live_tiles))


def work27(launch):
    """Live particles, written slots and index bytes of one launch of a
    27-cell kernel (K2, K3): it reads the live rows of every cell (each
    walked slot is one of them), writes the walked slots, and reads the
    cells' live counts, the warps' slot words and the block words."""
    return (int(launch.counts.sum()), int(launch.walked.sum()),
            4 * (launch.counts.numel() + launch.wslot.numel()
                 + launch.blocks.numel()))


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
        stats = {}
        out_p, plain_ms = time_ms(
            lambda: pair_flat.pair_apply_plain(launch, body, stats), 3)
        ok, max_abs, errs = compare(out_k, out_p, body)
        print(f"  {body.name:14s} ok={ok} max_abs_err={max_abs:.3e} "
              f"rel_errs={[float(f'{e:.2e}') for e in errs]} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms [{card}]")
        check(ok, f"{body.name}: kernel and plain version disagree")
        hold_walk(pair_flat, launch, body, out_k, stats, card)
        results[body.name] = ms
    return results


def hold_walk(module, launch, body, out_k, plain_stats, card):
    """A pair kernel's walk on one launch: a launch with statistics gives
    ``out_k``'s bits, and the pairs each warp evaluates equal the plain
    version's accepted pairs over the slots that warp walks, so its filter
    drops no accepted pair and it evaluates no other.  Prints the walk's
    totals, the share of staged rows it kept and its lane utilisation.
    For the 27-cell kernels also two launches without statistics must
    give the same bits, and their build (registers, spills, shared memory,
    blocks per SM at the launch's warps a block) is printed."""
    import torch
    from swift_subtask_dev_tpu_torch.ops import pair_flat, walk27
    flat = module is pair_flat
    st = {}
    out_s = module.pair_apply_kernel(launch, body, st)
    walk = st["walk"].long()
    slot_pairs = plain_stats["slot_pairs"]
    if flat:
        got = walk[..., pair_flat.WALK_STATS.index("pairs")]
        want = pair_flat.warp_pairs(launch, body, slot_pairs)
        summary = pair_flat.walk_summary(walk)
    else:
        got = walk[..., walk27.WALK_STATS.index("pairs")]
        want = walk27.warp_pairs(launch, slot_pairs)
        summary = walk27.walk_summary(walk)
    same = bool(torch.equal(got, want))
    kept = summary["kept"] / max(summary["staged"], 1)
    print(f"    walk: {summary}; kept share {kept:.4f}; pairs per warp "
          f"{'equal to' if same else 'DIFFERENT from'} the plain "
          f"version's [{card}]")
    check(same, f"{body_key(body)}: the kernel's pairs per warp "
          "differ from the plain version's")
    check(torch.equal(out_s, out_k), f"{body_key(body)}: a launch "
          "with walk statistics gave other outputs")
    if not flat:
        again = bool(torch.equal(module.pair_apply_kernel(launch, body),
                                 out_k))
        a = module.kernel_attributes(body.name, launch.wpb)
        print(f"    two launches on the same inputs: "
              f"{'bit-identical' if again else 'DIFFER'}; {launch.wpb} "
              f"warps a block ({launch.blocks.shape[0]} blocks, "
              f"{launch.wslot.numel() // 32} warps): {a['registers']} "
              f"registers, {a['local_bytes']} local (spill) bytes/thread, "
              f"shared {a['static_smem']} static + {a['dynamic_smem']} "
              f"dynamic bytes/block, {a['blocks_per_sm']} blocks/SM "
              f"[{card}]")
        check(again, f"{body.name}: two launches gave other bits")


def live_f64(grid, s):
    """(positions (N, 3), live mask (C*K,)) of a tiled state, float64,
    wrapped into the box."""
    import torch
    dev = s["mask"].device
    live = (s["mask"] > 0).reshape(-1)
    corners = torch.as_tensor(grid.cell_corners(), dtype=torch.float64,
                              device=dev)
    pos = (corners[:, None, :] + s["off"].double()).reshape(-1, 3)[live]
    box = torch.tensor(grid.box, dtype=torch.float64, device=dev)
    return torch.remainder(pos, box), live


def near_live(grid, s, centres, radius):
    """(N,) bool over the live particles of ``s``: within ``radius`` of a
    live particle of ``centres`` (periodic minimum image)."""
    import torch
    pos, _ = live_f64(grid, s)
    pos_c, _ = live_f64(grid, centres)
    box = torch.tensor(grid.box, dtype=torch.float64, device=pos.device)
    near = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    for c in range(0, pos_c.shape[0], 16):
        d = pos[:, None, :] - pos_c[None, c:c + 16, :]
        d = d - box * torch.round(d / box)
        near |= ((d * d).sum(-1) < radius * radius).any(1)
    return near


def hold_bh_p2p(solver, grid, state, card):
    """K1's P2P on the BHs (the fourth species) against the float64 brute
    force: the BHs from the gas, the DM and the stars (one cross-species
    launch each) and, with more than one BH, from the BHs (the
    one-species launch); and the gas within r_cut of a BH from the BHs."""
    gp, pm = solver.gp, solver.pm
    H = solver._H_list(4)
    names = (("gas", "gas"), ("dm", "DM"), ("stars", "stars"), ("bh", "BHs"))
    bh = state["bh"]
    for j in range(4 if int((bh["mask"] > 0).sum()) > 1 else 3):
        hold_p2p_brute(f"BHs from the {names[j][1]}", grid, bh,
                       state[names[j][0]], gp.G, H[3], H[j], pm.r_s,
                       pm.r_cut, card)
    gas = state["gas"]
    hold_p2p_brute("gas within r_cut of a BH from the BHs", grid, gas, bh,
                   gp.G, H[0], H[3], pm.r_s, pm.r_cut, card,
                   among=near_live(grid, gas, bh, pm.r_cut))


def sample(n, n_sample, seed, dev, among=None):
    """``n_sample`` seeded indices of range(n) (of ``among``'s true
    entries when given)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    pool = (torch.arange(n) if among is None
            else torch.nonzero(among.cpu()).reshape(-1))
    return pool[torch.randperm(pool.numel(), generator=g)[:n_sample]].to(dev)


def brute_density(eng, P, n_sample=1024, seed=0, state=None, among=None):
    """float64 brute-force SPH density of sampled live particles at their
    converged h (all N particles as neighbours, periodic minimum image),
    against the engine's rho: returns (max relative error, sample mean).
    ``state`` defaults to the engine's; ``among`` ((N,) bool over the live
    particles) limits the sample."""
    import torch
    s = eng.state if state is None else state
    dev = s["mask"].device
    pos, live = live_f64(eng.grid, s)
    box = torch.tensor(eng.grid.box, dtype=torch.float64, device=dev)
    m = s["m"].reshape(-1)[live].double()
    h = s["h"].reshape(-1)[live].double()
    rho = s["rho"].reshape(-1)[live].double()
    idx = sample(pos.shape[0], n_sample, seed, dev, among)
    ref = brute_kernel_sum(pos, box, h, m, idx, P.kernel)
    err = ((rho[idx] - ref).abs() / ref).max().item()
    return err, ref.mean().item()


def brute_kernel_sum(pos, box, h, q, idx, kernel):
    """float64 sum_j q_j W(r_ij, h_i) over every particle j (self
    included, periodic minimum image) for the particles ``idx``, with the
    kernel's own polynomial (models/sph/kernels.py) in float64."""
    import torch
    out = []
    for c in range(0, idx.numel(), 32):
        i = idx[c:c + 32]
        d = pos[i][:, None, :] - pos[None, :, :]
        d = d - box * torch.round(d / box)
        r = torch.sqrt((d * d).sum(-1))
        hi = h[i][:, None]
        w, _ = kernel.deval(r / hi)
        out.append((q[None, :] * w / hi ** 3).sum(-1))
    return torch.cat(out)


def finite_state(s):
    return [k for k, v in s.items()
            if v.is_floating_point() and not bool(v.isfinite().all())]


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
    bad = finite_state(s)
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
        ms, plain_ms, max_abs, pairs = hold_against_plain(
            pair_flat, launch, body, card)
        if body.name in ("force_gravity", "density"):
            same = bool(torch.equal(
                pair_flat.pair_apply_kernel(launch, body),
                pair_flat.pair_apply_kernel(launch, body)))
            print(f"    two launches on the same inputs: "
                  f"{'bit-identical' if same else 'DIFFER'}")
            check(same, f"{body.name}: two launches gave other bits")
        b_ms, b_by = bound(body, flat_work(launch, body), pairs)
        kernels.append(entry(f"pair_flat_{body.name}", FLAT_SOURCE,
                             FLAT_REPLACES, launches[body.name], max_abs,
                             ms, plain_ms, b_ms, b_by))
    return kernels


def sedov_run(backend, limiter, device, card, label):
    """The example's blast at SEDOV_N through init_particles() + run(),
    with the launch counters reset just before; the checks every path
    shares (finite state, shock radius within 10% of Sedov's, >= 3 time
    bins, re-grids only through the step).  Returns (engine, result,
    launches)."""
    import torch
    from swift_subtask_dev_tpu_torch.examples import sedov
    from swift_subtask_dev_tpu_torch.ops import (pair_flat, pair_packed,
                                                 pair_ring)
    eng = sedov.make_engine(SEDOV_N, SEDOV_T_END, backend, limiter, device)
    n = int(eng.state["mask"].sum())
    print(f"{label}: {n} particles, backend {backend!r}, limiter "
          f"{limiter}, grid cdim={list(eng.grid.cdim)} K={eng.grid.K}, "
          f"dt_max {eng.cfg.dt_max}, t_end {SEDOV_T_END}")
    check(n == 2 * SEDOV_N ** 3, f"expected {2 * SEDOV_N ** 3} particles")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pair_flat.reset_launches()
    pair_packed.reset_launches()
    pair_ring.reset_launches()
    eng, res = sedov.run_blast(SEDOV_N, SEDOV_T_END, engine=eng)
    launches = {"flat": dict(pair_flat.LAUNCHES),
                "packed": dict(pair_packed.LAUNCHES),
                "ring": dict(pair_ring.LAUNCHES)}
    steps, wall = res["steps"], res["run_seconds"]
    n_act = sum(res["n_active"])
    print(f"  init_particles {res['init_seconds']:.3f} s; run({SEDOV_T_END})"
          f" {steps} steps in {wall:.3f} s, t = {res['t']:.6f}: "
          f"{n_act / wall:.1f} active-particle updates/s "
          f"(sum n_active {n_act}), {wall / max(steps, 1) * 1e3:.2f} ms/step"
          f" [{card}]")
    print(f"  peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    print(f"  time bins populated (most at one step) "
          f"{res['bins_populated']}; woken {sum(res['n_woken'])}; "
          f"re-grids {eng.n_regrids} (retries {eng.n_regrid_retries}, "
          f"occupancy {eng.n_shrink_regrids}), final grid "
          f"cdim={list(eng.grid.cdim)} K={eng.grid.K}")
    print(f"  shock radius {res['r_shock']:.5f} vs Sedov "
          f"{res['r_sedov']:.5f} (err {res['radius_err']:.4f}), energy "
          f"drift {res['energy_drift']:.4e}")
    print(f"  kernel launches in the run: {launches}")
    bad = finite_state(eng.state)
    check(not bad, f"non-finite state fields: {bad}")
    check(res["radius_err"] < 0.10,
          "shock radius off Sedov's by 10% or more (the example's rule)")
    check(res["bins_populated"] >= 3,
          f"only {res['bins_populated']} time bins ever populated")
    check(eng.n_regrids == eng.n_regrid_retries + eng.n_shrink_regrids,
          "a re-grid happened outside the step's retry and shrink trigger")
    return eng, res, launches


def sedov_passes(eng):
    from swift_subtask_dev_tpu_torch.engine import NO_COSMO
    from swift_subtask_dev_tpu_torch.ops import hydro_flat
    s, P = eng.state, eng.sph
    return [hydro_flat.density_pass(s, P),
            hydro_flat.gradient_pass(s, P, NO_COSMO),
            hydro_flat.force_pass(s, P, NO_COSMO)]


def hold_27(module, eng, launches, source, replaces, card):
    """Each body of a Sedov path's 27-cell kernel (K2 or K3) against its
    plain version, with its walk (``hold_walk``): at the final state, with
    every particle active (the {"kernels"} entries), and on the particles
    active one smallest step before the end, through the active subset."""
    prefix = module.__name__.rsplit(".", 1)[-1]
    live = eng.state["mask"] > 0
    kernels = []
    for label, active in (("the final state, all active", None),
                          ("the particles active one smallest step before "
                           "the end", last_step_active(eng))):
        n_on = int((live if active is None else active).sum())
        print(f"  {prefix} on {label}: {n_on} of {int(live.sum())} "
              f"particles")
        for pp in sedov_passes(eng):
            launch, body = module.prepare(eng.grid, pp, active), pp.body
            ms, plain_ms, max_abs, pairs = hold_against_plain(
                module, launch, body, card)
            b_ms, b_by = bound(body, work27(launch), pairs)
            print(f"    bound {b_ms:.4f} ms ({b_by}); the kernel at "
                  f"{ms / b_ms:.1f}x it [{card}]")
            if active is None:
                kernels.append(entry(f"{prefix}_{body.name}", source,
                                     replaces, launches[body.name], max_abs,
                                     ms, plain_ms, b_ms, b_by))
    return kernels


def phase_sedov_pallas(device, card):
    """Path A.  The example runs without the timestep limiter; at this
    resolution that costs ~50% of the total energy in the first steps,
    on either backend, so the example's energy rule (< 5%) is held on
    path B (with the limiter, as SWIFT runs the blast) and path A's drift
    is held against the same run on the flat backend (K1 on columns)."""
    from swift_subtask_dev_tpu_torch.examples import sedov
    from swift_subtask_dev_tpu_torch.ops import pair_packed
    eng, res, launches = sedov_run("pallas", False, device, card,
                                   "phase 5 (Sedov, path A)")
    for name in pair_packed.KERNEL_BODIES:
        check(launches["packed"].get(name, 0) > 0,
              f"pair_packed_{name}: kernel never launched on path A")
    kernels = hold_27(pair_packed, eng, launches["packed"], PACKED_SOURCE,
                      PACKED_REPLACES, card)
    del eng
    _, twin = sedov.run_blast(SEDOV_N, SEDOV_T_END, "flat", False, device)
    d_a, d_f = res["energy_drift"], twin["energy_drift"]
    print(f"  the same blast on the flat backend without the limiter: "
          f"{twin['steps']} steps, shock radius {twin['r_shock']:.5f} "
          f"(err {twin['radius_err']:.4f}), energy drift {d_f:.4e}; "
          f"path A's drift {d_a:.4e}, relative difference "
          f"{abs(d_a - d_f) / d_f:.2e}; the example's energy rule (< 5%) "
          f"is {'met' if d_a < 0.05 else 'not met'} without the limiter")
    check(abs(d_a - d_f) <= 0.01 * d_f,
          "path A's energy drift differs from the flat backend's on the "
          "same configuration by more than 1%")
    check(abs(res["r_shock"] - twin["r_shock"]) <= 0.01 * twin["r_shock"],
          "path A's shock radius differs from the flat backend's by more "
          "than 1%")
    return kernels


def last_step_active(eng):
    """The particles active one smallest step before the end: at the end
    every bin is active, so the timebin pass is compared on this mix."""
    import torch
    from swift_subtask_dev_tpu_torch.utils import timeline as tl
    s = eng.state
    live = s["mask"] > 0
    b_min = int(s["time_bin"][live].min())
    ti = eng.timeline.ti_current - tl.get_integer_timestep(b_min)
    on = torch.as_tensor(eng.timeline.active_bins_mask(ti),
                         device=s["mask"].device)
    return live & on[s["time_bin"].clamp(0, tl.NUM_TIME_BINS).long()]


def phase_sedov_flat(device, card):
    """Path B: the flat backend with the timestep limiter."""
    from swift_subtask_dev_tpu_torch.ops import hydro_flat, pair_flat
    eng, res, launches = sedov_run("flat", True, device, card,
                                   "phase 6 (Sedov, path B)")
    check(res["energy_drift"] < 0.05,
          "energy drift of 5% or more (the example's rule)")
    check(sum(res["n_woken"]) > 0, "the limiter woke no particle")
    for name in ("density", "gradient", "force", "timebin"):
        check(launches["flat"].get(name, 0) > 0,
              f"pair_flat_{name}: kernel never launched on path B")
    active = last_step_active(eng)
    print(f"  timebin pass on the particles active one smallest step "
          f"before the end: {int(active.sum())} of "
          f"{int((eng.state['mask'] > 0).sum())}")
    kernels = []
    passes = sedov_passes(eng) + [hydro_flat.timebin_pass(
        {**eng.state, "active": active.float()}, eng.sph)]
    for pp in passes:
        launch, body = pair_flat.prepare(eng.grid, pp), pp.body
        exact = body.name == "timebin"
        ms, plain_ms, max_abs, pairs = hold_against_plain(
            pair_flat, launch, body, card, exact=exact)
        if exact:
            b_ms, b_by = bound(body, flat_work(launch, body), pairs)
            kernels.append(entry("pair_flat_timebin", FLAT_SOURCE,
                                 FLAT_REPLACES, launches["flat"]["timebin"],
                                 max_abs, ms, plain_ms, b_ms, b_by))
    return kernels


def phase_sedov_ring(device, card):
    """Path C: the 27-cell grid with the ring-buffer kernel K3 and the
    timestep limiter (its wake scan is the 27-cell stencil.timebin_loop)."""
    from swift_subtask_dev_tpu_torch.ops import pair_ring
    eng, res, launches = sedov_run("pallas_ring", True, device, card,
                                   "phase 7 (Sedov, path C)")
    check(res["energy_drift"] < 0.05,
          "energy drift of 5% or more (the example's rule)")
    check(sum(res["n_woken"]) > 0, "the limiter woke no particle")
    for name in pair_ring.KERNEL_BODIES:
        check(launches["ring"].get(name, 0) > 0,
              f"pair_ring_{name}: kernel never launched on path C")
    check(not launches["packed"] and not launches["flat"],
          f"path C launched another pair kernel: {launches}")
    return hold_27(pair_ring, eng, launches["ring"], RING_SOURCE,
                   RING_REPLACES, card)


def brute_p2p(grid, s_i, s_j, G, H, r_s, r_cut, n_sample=1024, seed=1,
              among=None):
    """float64 brute-force short-range acceleration of ``n_sample`` live
    particles of ``s_i`` (of ``among``'s, a bool over them, when given)
    from every live particle of ``s_j``: the softened kernel (H = the
    pair's softening) times the exact erfc truncation (torch.special.erfc),
    pairs within r_cut over periodic images (the minimum image: r_cut <
    box / 2).  Returns (sample slots of s_i in its live order, (n, 3)
    accelerations)."""
    import torch
    pos_i, _ = live_f64(grid, s_i)
    pos_j, live_j = live_f64(grid, s_j)
    m_j = s_j["m"].reshape(-1)[live_j].double()
    dev = pos_i.device
    box = torch.tensor(grid.box, dtype=torch.float64, device=dev)
    idx = sample(pos_i.shape[0], n_sample, seed, dev, among)
    out = []
    for c in range(0, idx.numel(), 16):
        d = pos_i[idx[c:c + 16]][:, None, :] - pos_j[None, :, :]
        d = d - box * torch.round(d / box)
        r2 = (d * d).sum(-1)
        r = torch.sqrt(r2)
        u = r / H
        W = ((((21.0 * u - 90.0) * u + 140.0) * u - 84.0) * u) * u + 14.0
        F = torch.where(u < 1.0, W / H ** 3,
                        1.0 / torch.clamp_min(r2 * r, 1e-300))
        x = 0.5 * r / r_s
        F = F * (torch.special.erfc(x)
                 + 2.0 / math.sqrt(math.pi) * x * torch.exp(-x * x))
        ok = (r2 > 0) & (r2 < r_cut * r_cut)
        w = torch.where(ok, -G * m_j[None, :] * F, 0.0)
        out.append((w[..., None] * d).sum(1))
    return idx, torch.cat(out)


def hold_p2p_brute(label, grid, s_i, s_j, G, H_i, H_j, r_s, r_cut, card,
                   among=None):
    """The port's P2P loop (K1: one-species when ``s_j`` is ``s_i``, else
    cross-species) on ``s_i`` from ``s_j`` against the float64 brute
    force: max error over 1024 sampled particles (of ``among``'s, a bool
    over the live ones of ``s_i``, when given) within 1e-4 of the largest
    sampled acceleration."""
    from swift_subtask_dev_tpu_torch.ops import hydro_flat
    acc, _ = hydro_flat.p2p_gravity_loop(grid, s_i, [s_j], G, H_i, r_s,
                                         r_cut, H_soft_j=[H_j])
    live = (s_i["mask"] > 0).reshape(-1)
    idx, ref = brute_p2p(grid, s_i, s_j, G, max(H_i, H_j), r_s, r_cut,
                         among=among)
    got = acc.reshape(-1, 3)[live][idx].double()
    check(ref.abs().max().item() > 0, f"{label}: no pair within r_cut, so "
          "the check holds nothing")
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    print(f"  short-range acceleration of {idx.numel()} {label}: float64 "
          f"brute force, max |a| {ref.abs().max().item():.6e}, "
          f"max error {err:.3e} of it [{card}]")
    check(err <= 1e-4, f"{label}: the P2P acceleration disagrees with the "
          "float64 brute force")


def phase_cosmo(device, card, n_side=None):
    """The gas + DM comoving volume (SmallCosmoVolume_hydro's 64^3 + 64^3
    in 100 Mpc/h; ``n_side`` cuts it at the same spacing) through the
    port's example: init_particles() and run() for at most COSMO_STEPS
    steps (the run reaches a_end = 1 before that), the launch counters
    reset just before."""
    import torch
    from swift_subtask_dev_tpu_torch.examples import small_cosmo_volume as scv
    from swift_subtask_dev_tpu_torch.ops import hydro_flat, pair_flat
    n_side = n_side or scv.N_SIDE
    eng, solver, ic = scv.make_engine(n_side, scv.BOX * n_side / scv.N_SIDE,
                                      device=device)
    gas, dm = eng.state["gas"], eng.state["dm"]
    n = int((gas["mask"] > 0).sum()) + int((dm["mask"] > 0).sum())
    spacing = ic["box"][0] / n_side
    print(f"phase 9 (SmallCosmoVolume): {n} particles, box "
          f"{ic['box'][0]:.4f} Mpc, grid cdim={list(eng.grid.cdim)} "
          f"K={eng.grid.K}, r_cut {solver.pm.r_cut:.4f} Mpc, mesh_N "
          f"{scv.MESH_N}; rms Zel'dovich displacement "
          f"{ic['psi_rms'] / spacing:.6f} mean spacings")
    check(n == 2 * n_side ** 3, f"expected {2 * n_side ** 3} particles")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pair_flat.reset_launches()
    t0 = time.perf_counter()
    diag = eng.init_particles()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    seen = {"n_active": 0, "bins": set()}

    def on_step(d):
        seen["n_active"] += int(d["n_active"])
        seen["bins"] |= {b for b, c in enumerate(d["bin_counts"].tolist())
                         if c}
    # up to COSMO_STEPS steps; the run ends earlier when it reaches a_end
    steps = eng.run(max_steps=COSMO_STEPS, on_step=on_step)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(pair_flat.LAUNCHES)
    a_now = eng.cosmology.a_of_ti(eng.timeline.ti_current)
    n_active, bins = seen["n_active"], seen["bins"]
    print(f"  init_particles {t1 - t0:.3f} s (ghost iterations "
          f"{diag['n_ghost_iter']}); {steps} steps in {t2 - t1:.3f} s"
          f" ({1e3 * (t2 - t1) / steps:.2f} ms/step, "
          f"{n_active / (t2 - t1):.1f} active-particle updates/s, sum "
          f"n_active {n_active}), a {scv.A_BEGIN} -> {a_now:.6f}, bins "
          f"{sorted(bins)}, mesh updates {eng.n_mesh_updates}, re-grids "
          f"{eng.n_regrids} [{card}]")
    print(f"  peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    print(f"  kernel launches in the run: {launches}")
    for name, sp in eng.state.items():
        bad = finite_state(sp)
        check(not bad, f"{name}: non-finite state fields: {bad}")
    for name in COSMO_BODIES:
        check(launches.get(name, 0) > 0, f"pair_flat_{name}: kernel never "
              "launched on the SmallCosmoVolume path")
    check(a_now > scv.A_BEGIN, "the run did not advance a")
    gas, dm = eng.state["gas"], eng.state["dm"]
    live = gas["mask"] > 0
    a_u = eng.cosmology.factors_at(
        eng.timeline.ti_current).a_factor_internal_energy
    u_phys = float(gas["u_full"][live].double().min()) * a_u
    print(f"  min physical u {u_phys:.6e} (minimal internal energy "
          f"{scv.U_MIN})")
    check(u_phys >= scv.U_MIN, "u fell below the minimal internal energy")
    # rho of the particles active in the last step is at their current
    # positions and h (every particle drifted to now)
    act = live & torch.as_tensor(
        eng.timeline.active_bins_mask(), device=device)[
        gas["time_bin"].clamp(0, 56).long()]
    err, ref_mean = brute_density(eng, eng.sph, state=gas,
                                  among=act.reshape(-1)[live.reshape(-1)])
    print(f"  brute-force float64 density on {min(1024, int(act.sum()))} "
          f"gas particles active in the last step (of {int(act.sum())}): "
          f"mean {ref_mean:.6e}, max relative error {err:.3e}")
    check(err <= 1e-4, "density disagrees with the float64 brute force")
    gp = solver.gp
    H_gas, H_dm = solver._H_list(2)
    hold_p2p_brute("DM from the gas", eng.grid, dm, gas, gp.G, H_dm, H_gas,
                   solver.pm.r_s, solver.pm.r_cut, card)
    hold_p2p_brute("gas from the DM", eng.grid, gas, dm, gp.G, H_gas, H_dm,
                   solver.pm.r_s, solver.pm.r_cut, card)

    # the cross-species kernel against its plain version, both directions,
    # at the path's shapes (the final state)
    kernel = None
    for i, j, H_i, H_j in (("gas", "dm", H_gas, H_dm),
                           ("dm", "gas", H_dm, H_gas)):
        pp = hydro_flat.p2p_gravity_pass(
            eng.state[i], gp.G, max(H_i, H_j), solver.pm.r_s,
            solver.pm.r_cut, s_j=eng.state[j])
        launch, body = pair_flat.prepare(eng.grid, pp), pp.body
        print(f"  cross-species P2P, {i} from {j} (W {launch.W}, Wj "
              f"{launch.Wj}):")
        ms, plain_ms, max_abs, pairs = hold_against_plain(
            pair_flat, launch, body, card)
        same = bool(torch.equal(pair_flat.pair_apply_kernel(launch, body),
                                pair_flat.pair_apply_kernel(launch, body)))
        print(f"    two launches on the same inputs: "
              f"{'bit-identical' if same else 'DIFFER'}")
        check(same, "p2p_gravity_cross: two launches gave other bits")
        b_ms, b_by = bound(body, flat_work(launch, body), pairs)
        print(f"    bound {b_ms:.4f} ms ({b_by}); the kernel at "
              f"{ms / b_ms:.1f}x it [{card}]")
        if kernel is None:
            kernel = entry("pair_flat_p2p_gravity_cross", FLAT_SOURCE,
                           FLAT_REPLACES, launches["p2p_gravity_cross"],
                           max_abs, ms, plain_ms, b_ms, b_by)
    return [kernel]


def phase_dmo(device, card, n1=80, mesh_N=192):
    """bench.py's BENCH_MODE=dmo geometry (n1 = 80: 1,024,000 particles,
    mesh_N = 192) through the port's DMEngine: init_particles() and
    DMO_STEPS steps (counters reset just before)."""
    import torch
    from swift_subtask_dev_tpu_torch.engine import DMEngine, EngineConfig
    from swift_subtask_dev_tpu_torch.grid import CellGrid
    from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
    from swift_subtask_dev_tpu_torch.models.gravity import (GravityParams,
                                                            GravitySolver)
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    ic = uniform_box_ic(n=n1, jitter=0.2, seed=3)
    gp = GravityParams(G=1.0, eps=0.5 / n1, mesh_N=mesh_N)
    r_cut = gp.r_cut_ratio * gp.a_smooth * 1.0 / gp.mesh_N
    grid = CellGrid.build_columns(ic["box"], interaction_range=r_cut * 1.25,
                                  pos=ic["pos"], headroom=1.4)
    solver = GravitySolver(gp, grid, device=device)
    eng = DMEngine(grid, EngineConfig(dt_min=1e-9, dt_max=2e-4,
                                      eta_grav=gp.eta,
                                      p2p_reach=solver.pm.r_cut,
                                      mesh_dt_max=64 * 2e-4),
                   0.0, 1.0, gravity_fn=solver.gas_short_range_fn(),
                   eps_soft=gp.eps, mesh_fn=solver.gas_mesh_fn(),
                   mesh_dt_scale=solver.pm.r_s, device=device)
    eng.solver_builder = lambda g: GravitySolver(gp, g, device=device)
    eng.load_dm(ic["pos"], ic["m"], ic["v"])
    n = int((eng.state["mask"] > 0).sum())
    print(f"phase 10 (DMO): {n} particles, grid cdim={list(grid.cdim)} "
          f"K={grid.K}, mesh_N {mesh_N}")
    torch.cuda.synchronize()
    pair_flat.reset_launches()
    t0 = time.perf_counter()
    eng.init_particles()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(DMO_STEPS):
        eng.step()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(pair_flat.LAUNCHES)
    print(f"  init_particles {t1 - t0:.3f} s; {DMO_STEPS} steps in "
          f"{t2 - t1:.3f} s: {1e3 * (t2 - t1) / DMO_STEPS:.2f} ms/step, "
          f"{DMO_STEPS * n / (t2 - t1):.1f} particle-steps/s, mesh "
          f"updates {eng.n_mesh_updates} [{card}]")
    print(f"  kernel launches in the run: {launches}")
    bad = finite_state(eng.state)
    check(not bad, f"non-finite state fields: {bad}")
    check(launches.get("p2p_gravity", 0) > 0 and set(launches)
          == {"p2p_gravity"}, f"the DMO path launched {launches}")
    s = eng.state
    hold_p2p_brute("DM", grid, s, s, gp.G, gp.H_soft, gp.H_soft,
                   solver.pm.r_s, solver.pm.r_cut, card)


def brute_z_smooth(grid, s, Z_sm, gamma, n_sample=1024, seed=2):
    """float64 brute-force chemistry-smoothed metallicity of sampled live
    gas particles, (sum_j m_j Z_j W(r_ij, h_i)) / rho_i over every live
    particle j, the particle itself included (W(0): the self term), at
    the state's h and rho; against ``Z_sm``: max error relative to the
    largest sampled value."""
    import torch
    pos, live = live_f64(grid, s)
    dev = pos.device
    box = torch.tensor(grid.box, dtype=torch.float64, device=dev)
    m = s["m"].reshape(-1)[live].double()
    Z = s["Z"].reshape(-1)[live].double()
    h = s["h"].reshape(-1)[live].double()
    rho = s["rho"].reshape(-1)[live].double()
    idx = sample(pos.shape[0], n_sample, seed, dev)
    norm = 16.0 / math.pi
    out = []
    for c in range(0, idx.numel(), 32):
        i = idx[c:c + 32]
        d = pos[i][:, None, :] - pos[None, :, :]
        d = d - box * torch.round(d / box)
        r = torch.sqrt((d * d).sum(-1))
        H = gamma * h[i][:, None]
        x = r / H
        w = torch.clamp(1 - x, min=0) ** 3 - 4 * torch.clamp(0.5 - x,
                                                             min=0) ** 3
        out.append((m[None, :] * Z[None, :] * norm * w / H ** 3).sum(-1)
                   / rho[i])
    ref = torch.cat(out)
    got = Z_sm.reshape(-1)[live][idx].double()
    return (got - ref).abs().max().item() / ref.abs().max().item(), \
        ref.mean().item()


def brute_ngb_mass(grid, stars, gas, ngb_mass, gamma, band=1e-5):
    """Each live star's gas neighbour mass (r < gamma h_star) in float64
    over every live gas particle, against ``ngb_mass``.  A pair within
    ``band`` (relative, on r^2) of the kernel's edge can fall either side
    in f32: the port's value must lie within [the sum without them, the
    sum with them], each widened by ``band``.  Returns (worst relative
    excess outside that interval, stars, pairs in the band)."""
    import torch
    pos_s, live_s = live_f64(grid, stars)
    pos_g, live_g = live_f64(grid, gas)
    dev = pos_s.device
    box = torch.tensor(grid.box, dtype=torch.float64, device=dev)
    m = gas["m"].reshape(-1)[live_g].double()
    h = stars["h"].reshape(-1)[live_s].double()
    got = ngb_mass.reshape(-1)[live_s].double()
    worst, n_band = 0.0, 0
    for c in range(0, pos_s.shape[0], 32):
        d = pos_s[c:c + 32][:, None, :] - pos_g[None, :, :]
        d = d - box * torch.round(d / box)
        r2 = (d * d).sum(-1)
        edge2 = (gamma * h[c:c + 32]) ** 2
        q = r2 / edge2[:, None]
        lo = (m[None, :] * (q < 1 - band)).sum(-1)
        hi = (m[None, :] * (q < 1 + band)).sum(-1)
        n_band += int(((q >= 1 - band) & (q < 1 + band)).sum())
        g = got[c:c + 32]
        excess = torch.clamp(lo * (1 - band) - g, min=0) + torch.clamp(
            g - hi * (1 + band), min=0)
        worst = max(worst, (excess / hi.clamp_min(1e-300)).max().item())
    return worst, pos_s.shape[0], n_band


class SyncTimer:
    """Wraps functions of modules, classes or objects so that each call is
    synchronised at both edges and its wall time (the device's, for work
    that the call waits for) and its calls are summed per label."""

    def __init__(self):
        self.ms, self.calls, self._undo = {}, {}, []

    def wrap(self, owner, attr, label):
        import torch
        orig = getattr(owner, attr)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            self.ms[label] = self.ms.get(label, 0.0) \
                + 1e3 * (time.perf_counter() - t0)
            self.calls[label] = self.calls.get(label, 0) + 1
            return out
        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))

    def restore(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def eagle_phase_timer(eng):
    """A SyncTimer over the EAGLE step's layers (the phases of PERF.md
    section 5): the gas loops, chemistry smoothing, the stars' ghost,
    short-range gravity, feedback, enrichment, cooling, the gas KDK,
    star formation, the collisionless KDK, rebuckets and the mesh."""
    from swift_subtask_dev_tpu_torch import engine_multi as em
    from swift_subtask_dev_tpu_torch.ops import hydro_flat, species_ghost
    from swift_subtask_dev_tpu_torch.subgrid.star_formation import (
        EagleStarFormation)
    pt = SyncTimer()
    pt.wrap(em, "_gas_loops", "gas_loops")
    pt.wrap(hydro_flat, "chemistry_smooth_loop", "chemistry_smoothing")
    pt.wrap(species_ghost, "species_h_iterate", "star_ghost")
    pt.wrap(hydro_flat, "p2p_gravity_loop", "p2p_gravity")
    pt.wrap(em, "_feedback", "feedback")
    pt.wrap(em, "_enrich", "enrichment")
    pt.wrap(eng, "cooling_fn", "cooling")
    pt.wrap(em, "_gas_kdk", "kick_timestep_limiter_gas")
    pt.wrap(EagleStarFormation, "conversion_mask", "star_formation")
    pt.wrap(em, "_convert_gas_to_stars", "star_formation")
    pt.wrap(em, "_dm_kdk", "kick_timestep_dm_stars")
    pt.wrap(em, "_rebucket_phase", "rebucket")
    pt.wrap(em, "_mesh_update_multi", "mesh")
    return pt


def phase_eagle(device, card):
    """The EAGLE volume without black holes (the port's example at
    run.yml's size: 256,902 gas, 262,144 DM and 5,242 stars in 25 Mpc):
    init_particles() and run() for at most EAGLE_STEPS steps with the
    launch counters reset just before, the checks, the chemistry body
    against its plain versions, the layers' synchronised ms over two
    more steps, the aged-stars pass and the RNG table."""
    import numpy as np
    import torch
    from swift_subtask_dev_tpu_torch.examples import eagle_volume as ev
    from swift_subtask_dev_tpu_torch.ops import hydro_flat, pair_flat
    from swift_subtask_dev_tpu_torch.ops import stencil
    from swift_subtask_dev_tpu_torch.utils import prng
    eng, solver, ic = ev.make_engine(device=device)
    counts = {n: int((sp["mask"] > 0).sum()) for n, sp in eng.state.items()}
    n = sum(counts.values())
    print(f"phase 11 (EAGLE volume): {counts} = {n} particles, box "
          f"{ic['box'][0]} Mpc, grid cdim={list(eng.grid.cdim)} "
          f"K={eng.grid.K} (stars {eng.state['stars']['mask'].shape[1]}), "
          f"r_cut {solver.pm.r_cut:.4f} Mpc, mesh_N {solver.gp.mesh_N}")
    check(counts == {"gas": 256902, "dm": 262144, "stars": 5242},
          f"expected 256,902 gas, 262,144 DM and 5,242 stars: {counts}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pair_flat.reset_launches()
    t0 = time.perf_counter()
    diag = eng.init_particles()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    seen = {k: 0 for k in ("n_active", "n_woken", "n_heated",
                           "n_converted", "n_lost")}
    seen["m_enriched"] = 0.0

    def on_step(d):
        for k in seen:
            seen[k] += float(d[k]) if k == "m_enriched" else int(d[k])
    steps = eng.run(max_steps=EAGLE_STEPS, on_step=on_step)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(pair_flat.LAUNCHES)
    a_now = eng.cosmology.a_of_ti(eng.timeline.ti_current)
    print(f"  init_particles {t1 - t0:.3f} s (ghost iterations "
          f"{diag['n_ghost_iter']}); {steps} steps in {t2 - t1:.3f} s "
          f"({1e3 * (t2 - t1) / steps:.2f} ms/step, "
          f"{steps * n / (t2 - t1):.1f} particle-steps/s, "
          f"{seen['n_active'] / (t2 - t1):.1f} active-particle updates/s), "
          f"a {ev.RUN_YML['Cosmology']['a_begin']} -> {a_now:.6f}, mesh "
          f"updates {eng.n_mesh_updates}, re-grids {eng.n_regrids} [{card}]")
    print(f"  wakes {seen['n_woken']}, feedback heating events "
          f"{seen['n_heated']}, conversions {seen['n_converted']}, n_lost "
          f"{seen['n_lost']}, enriched mass {seen['m_enriched']:.6e}")
    print(f"  peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    print(f"  kernel launches in the run: {launches}")
    for name, sp in eng.state.items():
        bad = finite_state(sp)
        check(not bad, f"{name}: non-finite state fields: {bad}")
    for name in EAGLE_BODIES:
        check(launches.get(name, 0) > 0, f"pair_flat_{name}: kernel never "
              "launched on the EAGLE volume's path")
    check(a_now > ev.RUN_YML["Cosmology"]["a_begin"],
          "the run did not advance a")

    gas, stars = eng.state["gas"], eng.state["stars"]
    P = eng.sph
    live = gas["mask"] > 0
    act = live & torch.as_tensor(
        eng.timeline.active_bins_mask(), device=device)[
        gas["time_bin"].clamp(0, 56).long()]
    err, ref_mean = brute_density(eng, P, state=gas,
                                  among=act.reshape(-1)[live.reshape(-1)])
    print(f"  brute-force float64 density on {min(1024, int(act.sum()))} "
          f"gas particles active in the last step (of {int(act.sum())}): "
          f"mean {ref_mean:.6e}, max relative error {err:.3e}")
    check(err <= 1e-4, "density disagrees with the float64 brute force")
    Z_k, _ = hydro_flat.chemistry_smooth_loop(eng.grid, gas, P)
    err, z_mean = brute_z_smooth(eng.grid, gas, Z_k, P.kernel.gamma)
    print(f"  chemistry-smoothed Z of 1024 gas particles: float64 brute "
          f"force, mean {z_mean:.6e}, max error {err:.3e} of the largest")
    check(err <= 1e-4, "smoothed Z disagrees with the float64 brute force")
    H = solver._H_list(3)
    gp = solver.gp
    hold_p2p_brute("stars from the gas", eng.grid, stars, gas, gp.G, H[2],
                   H[0], solver.pm.r_s, solver.pm.r_cut, card)
    hold_p2p_brute("gas from the stars", eng.grid, gas, stars, gp.G, H[0],
                   H[2], solver.pm.r_s, solver.pm.r_cut, card)
    ngb = stencil.star_ngb_mass_loop(eng.grid, stars, gas, P)
    worst, n_s, n_band = brute_ngb_mass(eng.grid, stars, gas, ngb,
                                        P.kernel.gamma)
    print(f"  ngb_mass of all {n_s} stars: float64 brute force, worst "
          f"relative excess {worst:.3e} ({n_band} pairs within 1e-5 of "
          f"the kernel's edge)")
    check(worst <= 1e-5, "stars' ngb_mass disagrees with the brute force")

    # the chemistry body against its plain versions at the final state
    pp = hydro_flat.chem_smooth_pass(gas, P)
    launch, body = pair_flat.prepare(eng.grid, pp), pp.body
    print(f"  chemistry smoothing (W {launch.W}), K1 against its plain "
          "pair version:")
    ms, k1_plain_ms, max_abs, pairs = hold_against_plain(
        pair_flat, launch, body, card)
    same = bool(torch.equal(pair_flat.pair_apply_kernel(launch, body),
                            pair_flat.pair_apply_kernel(launch, body)))
    print(f"    two launches on the same inputs: "
          f"{'bit-identical' if same else 'DIFFER'}")
    check(same, "chem_smooth: two launches gave other bits")
    (Z_p, e_p), plain_ms = time_ms(
        lambda: stencil.chemistry_smooth_loop(eng.grid, gas, P), 1,
        warmup=False)
    (Z_k, e_k), loop_ms = time_ms(
        lambda: hydro_flat.chemistry_smooth_loop(eng.grid, gas, P), 5)
    errs = []
    for a, b in ((Z_k, Z_p), (e_k, e_p)):
        errs.append(((a.double() - b.double()).abs().max()
                     / b.double().abs().max()).item())
    print(f"    against the stencil-form plain version "
          f"(ops/stencil.chemistry_smooth_loop): Z {errs[0]:.3e}, element "
          f"fractions {errs[1]:.3e} of max; loop {loop_ms:.4f} ms, stencil "
          f"plain {plain_ms:.1f} ms, pair plain {k1_plain_ms:.1f} ms "
          f"[{card}]")
    check(max(errs) <= 1e-5, "chem_smooth: the kernel and the stencil-form "
          "plain version disagree")
    b_ms, b_by = bound(body, flat_work(launch, body), pairs)
    print(f"    bound {b_ms:.4f} ms ({b_by}); the kernel at "
          f"{ms / b_ms:.1f}x it [{card}]")
    kernel = entry("pair_flat_chem_smooth", FLAT_SOURCE,
                   CHEM_REPLACES + " (XLA in the reference, no Pallas "
                   "kernel; a port-only body of K1, which replaces "
                   + FLAT_REPLACES + ")", launches["chem_smooth"], max_abs,
                   ms, plain_ms, b_ms, b_by)
    del Z_p, e_p, Z_k, e_k, eng, gas, stars, launch, pp
    hold_aged_stars(device, card)

    rows, bad = prng.check_table(device)
    print(f"  RNG table: {rows} reference draws (threefry and pair hash), "
          f"{bad} differ on the card")
    check(rows >= 128 and bad == 0, "the card's draws differ from the "
          "reference's table")
    return [kernel]


def hold_aged_stars(device, card, n_steps=2):
    """A fresh EAGLE volume whose loaded stars, after init_particles(),
    are given a birth time just older than the SNII delay and the gas's
    smallest time bin (so they are active, fire and enrich in the first
    step), then ``n_steps`` steps with each layer of the step timed
    (synchronised at both edges).  Checks the heated gas, each heated
    particle's jump (heating events x delta_u, f32 exact), the enriched
    mass and the total mass of gas, stars and DM across the pass."""
    import numpy as np
    import torch
    from swift_subtask_dev_tpu_torch.examples import eagle_volume as ev
    from swift_subtask_dev_tpu_torch.ops import stencil
    eng, _, _ = ev.make_engine(device=device)
    eng.init_particles()
    st, gas = eng.state["stars"], eng.state["gas"]
    delay = eng.feedback.snii_delay
    a0 = eng.cosmology.a_of_ti(eng.timeline.ti_current)
    born = float(np.float32(a0 - 1.05 * delay))
    loaded = (st["mask"] > 0) & (st["birth_time"] <= 0)
    bin_ = int(gas["time_bin"][gas["mask"] > 0].min())
    st["birth_time"] = torch.where(loaded, born, st["birth_time"])
    st["time_bin"] = torch.where(loaded, bin_, st["time_bin"]).to(
        st["time_bin"].dtype)

    def total_mass():
        return sum(float((sp["m"] * sp["mask"]).double().sum())
                   for sp in eng.state.values())
    m0 = total_mass()
    captured = []
    orig = stencil.feedback_apply_loop

    def capture(*a, **kw):
        out = orig(*a, **kw)
        captured.append(out)
        return out
    stencil.feedback_apply_loop = capture
    pt = eagle_phase_timer(eng)
    n_heated, m_enr = [], []
    try:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            d = eng.step()
            n_heated.append(int(d["n_heated"]))
            m_enr.append(float(d["m_enriched"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        stencil.feedback_apply_loop = orig
        pt.restore()
    m1 = total_mass()
    du_step = float(np.float32(eng.feedback.delta_u))
    exact = heated_n = 0
    for du, nev in captured:
        hot = nev > 0
        heated_n += int(hot.sum())
        exact += int((du[hot] == nev[hot].to(torch.float32)
                      * du_step).sum())
    fb_done = int((eng.state["stars"]["fb_done"] > 0).sum())
    print(f"  aged stars (birth time a = {born:.6f} at a = {a0:.6f}, SNII "
          f"delay {delay}, bin {bin_}): {n_steps} steps in {wall:.3f} s; "
          f"heated gas per step {n_heated} ({exact} of {heated_n} jumps "
          f"equal to events x delta_u), {fb_done} stars done, enriched "
          f"mass per step {m_enr}; total mass {m0:.9e} -> {m1:.9e} "
          f"(relative change {abs(m1 - m0) / m0:.3e}) [{card}]")
    print(f"  layers of those steps, synchronised ms per step (of "
          f"{1e3 * wall / n_steps:.2f}): "
          + ", ".join(f"{lb} {v / n_steps:.3f}"
                      for lb, v in sorted(pt.ms.items(),
                                          key=lambda kv: -kv[1]))
          + f" [{card}]")
    check(n_heated[0] > 0, "the aged stars heated no gas")
    check(exact == heated_n, "a heated particle's jump is not events x "
          "delta_u")
    check(m_enr[0] > 0, "the aged stars enriched no gas")
    check(abs(m1 - m0) <= 1e-6 * m0, "the pass did not conserve mass")


def brute_bh_density(grid, bh, gas, dens, gamma, P):
    """Each live BH's gas sums (rho = sum m w(r/h), mom = sum m w v, cs_w
    = sum m w cs) in float64 over every live gas particle within gamma
    h_bh, against ``dens`` (``ops.black_holes.bh_gas_density_loop``):
    max error relative to each sum's largest value.  The kernel w(u) is
    the port's own, evaluated in float64."""
    import torch
    pos_b, live_b = live_f64(grid, bh)
    pos_g, live_g = live_f64(grid, gas)
    box = torch.tensor(grid.box, dtype=torch.float64, device=pos_b.device)
    m = gas["m"].reshape(-1)[live_g].double()
    v = gas["v"].reshape(-1, 3)[live_g].double()
    cs = gas["soundspeed"].reshape(-1)[live_g].double()
    h = bh["h"].reshape(-1)[live_b].double()
    ref = {k: [] for k in ("rho", "mom0", "mom1", "mom2", "cs_w")}
    for c in range(0, pos_b.shape[0], 32):
        d = pos_b[c:c + 32][:, None, :] - pos_g[None, :, :]
        d = d - box * torch.round(d / box)
        u = torch.sqrt((d * d).sum(-1)) / h[c:c + 32][:, None]
        w, _ = P.kernel.deval(u)
        mw = torch.where(u < gamma, m[None, :] * w, 0.0)
        ref["rho"].append(mw.sum(-1))
        for a in range(3):
            ref[f"mom{a}"].append((mw * v[None, :, a]).sum(-1))
        ref["cs_w"].append((mw * cs[None, :]).sum(-1))
    worst = 0.0
    for k, parts in ref.items():
        r = torch.cat(parts)
        got = dens[k].reshape(-1)[live_b].double()
        worst = max(worst, ((got - r).abs().max()
                            / r.abs().max().clamp_min(1e-300)).item())
    return worst


def phase_eagle_bh(device, card, n_side=None):
    """The EAGLE volume with its seed black hole (``swift-tpu run.yml
    --eagle --black-holes``: the example with ``black_holes``, 256,902
    gas, 262,144 DM, 5,242 stars and 1 BH in 25 Mpc): init_particles()
    and run() for at most EAGLE_STEPS steps with the launch counters reset
    just before, the BH block timed; the checks, K1's P2P on and from the
    one BH (``hold_bh_p2p``) among them; then the active-BH pass."""
    import torch
    from swift_subtask_dev_tpu_torch import engine_multi as em
    from swift_subtask_dev_tpu_torch.examples import eagle_volume as ev
    from swift_subtask_dev_tpu_torch.ops import black_holes as bh_ops
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    n_side = n_side or ev.N_SIDE
    eng, solver, ic = ev.make_engine(n=n_side, device=device,
                                     black_holes=True)
    counts = {n: int((sp["mask"] > 0).sum()) for n, sp in eng.state.items()}
    n = sum(counts.values())
    print(f"phase 12 (EAGLE volume with its black hole): {counts} = {n} "
          f"particles, grid cdim={list(eng.grid.cdim)} K={eng.grid.K} "
          f"(BH columns {eng.state['bh']['mask'].shape[1]}), "
          f"{eng.bh_model}")
    if n_side == ev.N_SIDE:
        check(counts == {"gas": 256902, "dm": 262144, "stars": 5242,
                         "bh": 1}, f"expected 256,902 gas, 262,144 DM, "
              f"5,242 stars and 1 BH: {counts}")

    def total_mass():
        return sum(float((sp["m"] * sp["mask"]).double().sum())
                   for sp in eng.state.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pair_flat.reset_launches()
    t0 = time.perf_counter()
    eng.init_particles()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m0 = total_mass()
    keys = ("n_active", "n_woken", "n_heated", "n_converted", "n_lost",
            "n_swallowed", "n_agn", "n_bh_merged")
    seen = dict.fromkeys(keys, 0)

    def on_step(d):
        for k in seen:
            seen[k] += int(d[k])
    pt = SyncTimer()
    pt.wrap(em, "_black_holes", "black_holes")
    try:
        t2 = time.perf_counter()
        steps = eng.run(max_steps=EAGLE_STEPS, on_step=on_step)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        pt.restore()
    launches = dict(pair_flat.LAUNCHES)
    a_now = eng.cosmology.a_of_ti(eng.timeline.ti_current)
    m1 = total_mass()
    print(f"  init_particles {t1 - t0:.3f} s; {steps} steps in "
          f"{t3 - t2:.3f} s ({1e3 * (t3 - t2) / steps:.2f} ms/step, "
          f"{steps * n / (t3 - t2):.1f} particle-steps/s), the BH block "
          f"{pt.ms.get('black_holes', 0.0) / steps:.3f} ms/step "
          f"(synchronised), a {ev.RUN_YML['Cosmology']['a_begin']} -> "
          f"{a_now:.6f}, re-grids {eng.n_regrids} [{card}]")
    print(f"  {seen}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; kernel "
          f"launches in the run: {launches}")
    p2p = launches.get("p2p_gravity", 0) + launches.get(
        "p2p_gravity_cross", 0)
    print(f"  K1 P2P launches {p2p} over {steps + 1} gravity passes "
          f"(16 a pass: 4 one-species, 12 cross-species)")
    for name, sp in eng.state.items():
        bad = finite_state(sp)
        check(not bad, f"{name}: non-finite state fields: {bad}")
    for name in EAGLE_BODIES:
        check(launches.get(name, 0) > 0, f"pair_flat_{name}: kernel never "
              "launched on the EAGLE + BH path")
    check(launches["p2p_gravity"] >= 4 * (steps + 1)
          and launches["p2p_gravity_cross"] >= 12 * (steps + 1),
          "fewer than 16 P2P launches a gravity pass")
    check(a_now > ev.RUN_YML["Cosmology"]["a_begin"],
          "the run did not advance a")
    check(int((eng.state["bh"]["mask"] > 0).sum()) >= 1, "the BH is gone")
    print(f"  total mass (gas + DM + stars + BH, float64) {m0:.12e} -> "
          f"{m1:.12e}: relative change {abs(m1 - m0) / m0:.3e}")
    check(abs(m1 - m0) <= 1e-6 * m0, "the run did not conserve mass")
    gas, bh, P = eng.state["gas"], eng.state["bh"], eng.sph
    dens = bh_ops.bh_gas_density_loop(eng.grid, bh, gas, P)
    err = brute_bh_density(eng.grid, bh, gas, dens, P.kernel.gamma, P)
    worst, n_b, n_band = brute_ngb_mass(eng.grid, bh, gas, dens["ngb_mass"],
                                        P.kernel.gamma)
    live = bh["mask"] > 0
    print(f"  the BH's density sums (rho {float(dens['rho'][live][0]):.6e}, "
          f"ngb_mass {float(dens['ngb_mass'][live][0]):.6e}, h "
          f"{float(bh['h'][live][0]):.6f}) against the float64 brute "
          f"force over the gas: rho, mom0-2, cs_w within {err:.3e} of "
          f"max, ngb_mass worst relative excess {worst:.3e} ({n_band} "
          f"pairs within 1e-5 of the kernel's edge)")
    check(err <= 1e-5, "the BH's density sums disagree with the brute "
          "force")
    check(worst <= 1e-5, "the BH's ngb_mass disagrees with the brute force")
    hold_bh_p2p(solver, eng.grid, eng.state, card)
    del eng, gas, bh, dens
    hold_active_bhs(device, card, n_side)


def active_bh_ic(n_side, n_single=48, n_pairs=8, seed=5):
    """The EAGLE volume's ICs with the seed BH and ``n_single`` BHs 0.05
    Mpc beside random gas particles (they reposition) plus ``n_pairs``
    pairs 0.05 Mpc apart (a third of the merging distance) at random
    places; every BH at least 0.5 Mpc from every BH but its partner.
    Returns (ic, the pairs' first pids)."""
    import numpy as np
    from swift_subtask_dev_tpu_torch.examples import eagle_volume as ev
    from swift_subtask_dev_tpu_torch.ics import eagle_volume_ic
    ic = eagle_volume_ic(n=n_side, L=ev.BOX, z=ev.Z_START,
                         star_frac=ev.STAR_FRAC, seed=ev.SEED,
                         black_hole=True)
    gas, bh, L = ic["gas"], ic["bh"], ev.BOX
    rng = np.random.default_rng(seed)
    pos = [bh["pos"][0]]

    def free(p):
        d = np.abs(np.asarray(pos) - p)
        d = np.minimum(d, L - d)
        return np.sqrt((d * d).sum(1)).min() > 0.5
    while len(pos) < 1 + n_single:
        p = np.mod(gas["pos"][rng.integers(len(gas["pos"]))]
                   + [0.05, 0.0, 0.0], L)
        if free(p):
            pos.append(p)
    firsts = []
    while len(firsts) < n_pairs:
        p = rng.uniform(0, L, 3)
        if free(p) and free(np.mod(p + [0.05, 0.0, 0.0], L)):
            firsts.append(len(pos))
            pos += [p, np.mod(p + [0.05, 0.0, 0.0], L)]
    nb = len(pos)
    ic["bh"] = {"pos": np.asarray(pos), "v": np.zeros((nb, 3), np.float32),
                "m": np.full(nb, bh["m"][0], np.float32),
                "pid": bh["pid"][0] + np.arange(nb, dtype=np.int64)}
    return ic, [int(bh["pid"][0]) + k for k in firsts]


def hold_active_bhs(device, card, n_side, n_steps=2):
    """A fresh volume (``active_bh_ic``) whose BHs, after init, are given
    (the singles) subgrid masses 3 gas masses above their masses (they
    swallow in the first step), reservoirs 1.5 x the AGN threshold of
    their neighbour mass (they fire), the gas's smallest time bin
    (active), the velocity of the gas particle beside them (the singles:
    they reposition) or, for each pair, one velocity 1,000 km/s off the
    gas (bound, and too fast to reposition); ``n_steps`` steps with each
    layer timed.  Checks: swallows, AGN events and one merger a pair; in
    float64 the BHs' mass gain equals the swallowed gas mass and the total
    mass is unchanged (1e-6); each BH's momentum after its swallow equals
    its momentum before plus its swallowed gas's (1e-5 of the largest
    momentum); each heated particle's jump events x delta_u exactly; each
    reposition at most max_reposition_distance_ratio x eps; no swallowed
    pid converted to a star; and, at the final state, K1's density on the
    compacted gas of 1,024 gas particles near the BHs and K1's P2P on and
    from the BHs (``hold_bh_p2p``) against the float64 brute force
    (1e-4)."""
    import numpy as np
    import torch
    from swift_subtask_dev_tpu_torch import engine_multi as em
    from swift_subtask_dev_tpu_torch.examples import eagle_volume as ev
    from swift_subtask_dev_tpu_torch.ops import black_holes as bh_ops
    from swift_subtask_dev_tpu_torch.ops import hydro_flat, stencil
    ic, pair_pids = active_bh_ic(n_side)
    eng, solver, _ = ev.make_engine(n=n_side, device=device, ic=ic,
                               black_holes=True)
    eng.init_particles()
    model, P = eng.bh_model, eng.sph
    gas, bh = eng.state["gas"], eng.state["bh"]
    live = bh["mask"] > 0
    m_gas = float(gas["m"][gas["mask"] > 0].double().mean())
    dens = bh_ops.bh_gas_density_loop(eng.grid, bh, gas, P)
    # the singles' velocity: their gas particle's (its nearest live one)
    pos_b, _ = live_f64(eng.grid, bh)
    pos_g, live_g = live_f64(eng.grid, gas)
    box = torch.tensor(eng.grid.box, dtype=torch.float64, device=device)
    vg = gas["v_full"].reshape(-1, 3)[live_g]
    d = pos_b[:, None, :] - pos_g[None, :, :]
    d = d - box * torch.round(d / box)
    r = torch.sqrt((d * d).sum(-1))
    near = r.argmin(1)
    v_b = bh["v_full"][live].clone()
    pid_b = bh["pid"][live]
    paired = torch.zeros_like(pid_b, dtype=torch.bool)
    for p0 in pair_pids:
        a, b = pid_b == p0, pid_b == p0 + 1
        v = vg[near[a]][0] + torch.tensor([1000.0, 0.0, 0.0],
                                          device=device)
        v_b[a], v_b[b] = v, v
        paired |= a | b
    single = ~paired & (pid_b != int(pid_b.min()))
    v_b[single] = vg[near[single]]
    bin_ = int(gas["time_bin"][gas["mask"] > 0].min())
    # the singles 3 gas masses short (they swallow); the seed and the pairs
    # not (a pair's members would swallow gas of other momenta and part)
    m_sub = torch.where(single, bh["m"][live] + 3.0 * m_gas, bh["m"][live])
    resv = 1.5 * float(np.float32(model.n_heat)
                       * np.float32(model.delta_u)) \
        * dens["ngb_mass"][live] / 48.0
    fields = {"v_full": v_b, "m_subgrid": m_sub, "energy_reservoir": resv,
              "time_bin": torch.full_like(pid_b, bin_)}
    for k, v in fields.items():
        bh[k] = bh[k].clone()
        bh[k][live] = v.to(bh[k].dtype)
    n_bh = int(live.sum())

    def total_mass():
        return sum(float((sp["m"] * sp["mask"]).double().sum())
                   for sp in eng.state.values())

    def live_pids(name):
        sp = eng.state[name]
        return set(sp["pid"][sp["mask"] > 0].tolist())
    m0 = total_mass()
    cap = {"fb": [], "bid": [], "absorb": [], "repos": []}
    orig = {"fb": stencil.feedback_apply_loop,
            "bid": bh_ops.bh_swallow_target_loop,
            "absorb": em._absorb, "repos": bh_ops.bh_reposition_loop}

    def fb(grid, gas_s, src, p, lo, hi, du):
        out = orig["fb"](grid, gas_s, src, p, lo, hi, du)
        cap["fb"].append((out, du))
        return out

    def bid_cap(grid, gas_s, *a):
        out = orig["bid"](grid, gas_s, *a)
        cap["bid"].append((gas_s, out))
        return out

    def absorb(b, gains):
        out = orig["absorb"](b, gains)
        if "dms" not in gains:              # the swallow's, not a merger's
            cap["absorb"].append((b, out))
        return out

    def repos(*a, **kw):
        out = orig["repos"](*a, **kw)
        cap["repos"].append(out)
        return out
    stencil.feedback_apply_loop = fb
    bh_ops.bh_swallow_target_loop = bid_cap
    em._absorb = absorb
    bh_ops.bh_reposition_loop = repos
    pt = eagle_phase_timer(eng)
    pt.wrap(em, "_black_holes", "black_holes")
    diags, changed = [], []
    try:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            g0, s0 = live_pids("gas"), live_pids("stars")
            bh_m0 = float((eng.state["bh"]["m"] * eng.state["bh"]["mask"])
                          .double().sum())
            diags.append(eng.step())
            bh_m1 = float((eng.state["bh"]["m"] * eng.state["bh"]["mask"])
                          .double().sum())
            changed.append((g0 - live_pids("gas"), live_pids("stars") - s0,
                            bh_m1 - bh_m0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        stencil.feedback_apply_loop = orig["fb"]
        bh_ops.bh_swallow_target_loop = orig["bid"]
        em._absorb = orig["absorb"]
        bh_ops.bh_reposition_loop = orig["repos"]
        pt.restore()
    m1 = total_mass()
    n_sw = [int(d["n_swallowed"]) for d in diags]
    n_agn = [int(d["n_agn"]) for d in diags]
    n_mg = [int(d["n_bh_merged"]) for d in diags]
    n_conv = [int(d["n_converted"]) for d in diags]
    # per step: the swallowed pids and mass (at the swallow), the BHs'
    # mass gain, no swallowed pid among the new stars
    both, worst_dm, worst_p, sw_mass = 0, 0.0, 0.0, 0.0
    for (gas_s, bid), (gone, new, dm_bh) in zip(cap["bid"], changed):
        hit = bid >= 0
        sw = set(gas_s["pid"][hit].tolist())
        both += len(sw & new)
        check(gone == sw | new, "gas left the columns unaccounted for")
        m_sw = float(gas_s["m"][hit].double().sum())
        sw_mass += m_sw
        worst_dm = max(worst_dm, abs(dm_bh - m_sw) / max(m_sw, 1e-300))
    # momentum: each BH's after its swallow, against before + its gas's
    for (gas_s, bid), (b0, b1) in zip(cap["bid"], cap["absorb"]):
        hit = bid >= 0
        pg = (gas_s["m"][hit].double()[:, None]
              * gas_s["v_full"][hit].double())
        per = {}
        for pid, mom in zip(bid[hit].tolist(), pg):
            per[pid] = per.get(pid, 0.0) + mom
        lv = b0["mask"] > 0
        p0 = (b0["m"][lv].double()[:, None] * b0["v_full"][lv].double())
        p1 = (b1["m"][lv].double()[:, None] * b1["v_full"][lv].double())
        want = torch.stack([per.get(int(q), torch.zeros(
            3, dtype=torch.float64, device=device))
            for q in b0["pid"][lv].tolist()])
        # f32 momenta: the scale is the largest of them
        scale = max(float(torch.cat([p0, p1, want]).abs().max()), 1e-300)
        worst_p = max(worst_p, float((p1 - p0 - want).abs().max()) / scale)
    exact = heated = 0
    for (du_add, nev), du in cap["fb"]:
        hot = nev > 0
        heated += int(hot.sum())
        exact += int((du_add[hot] == nev[hot].to(torch.float32)
                      * float(np.float32(du))).sum())
    max_d = model.reposition_ratio * eng.cfg.eps_soft
    moved, longest = 0, 0.0
    for found, delta in cap["repos"]:
        moved += int(found.sum())
        if bool(found.any()):
            longest = max(longest, float(torch.sqrt(
                (delta[found].double() ** 2).sum(-1)).max()))
    print(f"  active BHs ({n_bh}: 48 beside gas, {len(pair_pids)} pairs, "
          f"the seed; bin {bin_}): {n_steps} steps in {wall:.3f} s; per "
          f"step swallowed {n_sw}, AGN events {n_agn}, mergers {n_mg}, "
          f"conversions {n_conv}; repositioned {moved} (longest jump "
          f"{longest:.6f} of at most {max_d:.6f} Mpc); heated gas {heated} "
          f"({exact} jumps equal to events x delta_u); swallowed mass "
          f"{sw_mass:.9e} (BHs' gain within {worst_dm:.3e}); BH momentum "
          f"within {worst_p:.3e} of max; swallowed and converted {both}; "
          f"total mass {m0:.12e} -> {m1:.12e} (relative change "
          f"{abs(m1 - m0) / m0:.3e}) [{card}]")
    print(f"  layers of those steps, synchronised ms per step (of "
          f"{1e3 * wall / n_steps:.2f}): "
          + ", ".join(f"{lb} {v / n_steps:.3f}"
                      for lb, v in sorted(pt.ms.items(),
                                          key=lambda kv: -kv[1]))
          + f" [{card}]")
    check(n_sw[0] > 0, "the active BHs swallowed no gas")
    check(n_agn[0] > 0, "no AGN event")
    check(sum(n_mg) == len(pair_pids), "not every pair merged")
    check(moved > 0 and longest <= max_d * (1 + 1e-6),
          "no reposition, or one longer than the allowed distance")
    check(worst_dm <= 1e-6, "the BHs' mass gain is not the swallowed mass")
    check(abs(m1 - m0) <= 1e-6 * m0, "the pass did not conserve mass")
    check(worst_p <= 1e-5, "a BH's momentum is not before + swallowed")
    check(heated > 0 and exact == heated,
          "a heated particle's jump is not events x delta_u")
    check(both == 0, "a swallowed particle also became a star")
    gas, bh = eng.state["gas"], eng.state["bh"]
    d = hydro_flat.density_loop(eng.grid, gas, P)
    h = torch.where(gas["mask"] > 0, gas["h"], 1.0)
    rho = (d["rho"] + gas["m"] * float(np.float32(P.kernel.root))) / h ** 3
    near = near_live(eng.grid, gas, bh, 1.0)
    err, mean = brute_density(eng, P, state={**gas, "rho": rho},
                              among=near)
    print(f"  K1 density of {min(1024, int(near.sum()))} gas particles "
          f"within 1 Mpc of a BH on the compacted gas: float64 brute "
          f"force mean {mean:.6e}, max relative error {err:.3e}")
    check(err <= 1e-4, "K1's density on the compacted gas disagrees with "
          "the brute force")
    hold_bh_p2p(solver, eng.grid, eng.state, card)


# ---------------------------------------------------------------------------
# Phases 13 and 14: K1's SPH modes (schemes and smoothing kernels)
# ---------------------------------------------------------------------------

def mode_bodies(P):
    """The LAUNCHES keys of P's SPH bodies on a path without gravity."""
    from swift_subtask_dev_tpu_torch.ops import hydro_flat
    mode = hydro_flat.sph_mode(P)
    tag = f"[{mode}]" if mode else ""
    return (("density", "gradient", "force") if P.mod.HAS_GRADIENT_LOOP
            else ("density", "force")), tag


def total_mass(s):
    return float((s["m"].double() * (s["mask"] > 0)).sum())


def hold_modes(eng, P, card, launches, cosmo, fuse_spec=None, entries=None,
               per_slot=False):
    """Each SPH body of P's mode (sph_passes) against its plain version on
    the engine's state (phase 3's tolerances, or ``per_slot`` against each
    slot's sum of magnitudes; hold_walk); one kernel entry each, with the
    path's launches."""
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    out = [] if entries is None else entries
    for pp in sph_passes(eng.state, P, cosmo, fuse_spec):
        launch, body = pair_flat.prepare(eng.grid, pp), pp.body
        ms, plain_ms, max_abs, pairs = hold_against_plain(
            pair_flat, launch, body, card, per_slot=per_slot)
        b_ms, b_by = bound(body, flat_work(launch, body), pairs)
        key = body_key(body)
        out.append(entry(f"pair_flat_{key}", FLAT_SOURCE, FLAT_REPLACES,
                         launches.get(key, 0), max_abs, ms, plain_ms, b_ms,
                         b_by))
    return out


def u_by_pid(s, n):
    """The live particles' u_full, indexed by particle id."""
    import torch
    live = s["mask"] > 0
    out = torch.zeros(n, dtype=s["u_full"].dtype, device=s["u_full"].device)
    out[s["pid"][live].long()] = s["u_full"][live]
    return out


def phase_schemes_main(device, card, n1=80, mesh_N=192):
    """Phase 13: each of SCHEME_RUNS on the main path's geometry
    (bench.py's 1,024,000 particles, P3M, split mesh): init_particles() +
    run_fixed_dt(SCHEME_STEPS) with the launch counters reset just
    before; finite state, total mass unchanged, every body of the mode
    launched, the float64 brute-force density (and Pressure-Energy's
    smoothed pressure) on 1,024 particles, each body against its plain
    version."""
    import torch
    from swift_subtask_dev_tpu_torch.models.sph.sphenix import CosmoFactors
    from swift_subtask_dev_tpu_torch.ops import hydro_flat, pair_flat
    kernels = []
    for scheme, kernel in SCHEME_RUNS:
        eng, P, solver, n = bench_engine(n1, mesh_N, device, scheme, kernel)
        print(f"phase 13: {scheme} with the {kernel}, {n} particles, grid "
              f"cdim={list(eng.grid.cdim)} W={eng.grid.K}, mesh_N={mesh_N}")
        m0 = total_mass(eng.state)
        if scheme == "none":
            u0_pid = u_by_pid(eng.state, n)
        torch.cuda.synchronize()
        pair_flat.reset_launches()
        t0 = time.perf_counter()
        diag = eng.init_particles()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.run_fixed_dt(SCHEME_STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(pair_flat.LAUNCHES)
        step_ms = 1e3 * (t2 - t1) / SCHEME_STEPS
        print(f"  init_particles {t1 - t0:.3f} s (ghost iterations "
              f"{diag['n_ghost_iter']}), run_fixed_dt({SCHEME_STEPS}) "
              f"{t2 - t1:.3f} s: {step_ms:.2f} ms/step, "
              f"{SCHEME_STEPS * n / (t2 - t1):.1f} particle-steps/s "
              f"[{card}]")
        print(f"  kernel launches: {launches}")
        s = eng.state
        bad = finite_state(s)
        check(not bad, f"{scheme}: non-finite state fields: {bad}")
        check(diag["n_ghost_iter"] < eng.cfg.max_ghost_iterations,
              f"{scheme}: init ghost did not converge")
        check(total_mass(s) == m0, f"{scheme}: total mass changed")
        names, tag = mode_bodies(P)
        for name in names + ("force_gravity",):
            check(launches.get(name + tag, 0) > 0,
                  f"{name}{tag}: kernel never launched on the main path")
        err, ref_mean = brute_density(eng, P)
        print(f"  brute-force float64 density on 1024 sampled particles: "
              f"mean {ref_mean:.6f}, max relative error {err:.3e}")
        check(err <= 1e-4, f"{scheme}: density disagrees with the float64 "
              "brute force")
        cosmo = CosmoFactors.no_cosmo()
        smoothed = [k for k in ("pressure_bar", "rho_bar")
                    if k in P.mod.DENSITY_EXTRA_KEYS]
        for key in smoothed:
            # a fresh density pass (the state's u at the pass's time) and
            # end_density: P̄ = (gamma - 1) sum_j m_j u_j W(r_ij, h_i), or
            # rho_bar = sum_j m_j S_j W(r_ij, h_i) / S_i, S = A^(1/gamma)
            d = hydro_flat.density_loop(eng.grid, s, P)
            got = P.mod.end_density(P, {**s, **d}, cosmo)[key]
            pos, live = live_f64(eng.grid, s)
            box = torch.tensor(eng.grid.box, dtype=torch.float64,
                               device=pos.device)

            def flat(x):
                return x.reshape(-1)[live].double()
            idx = sample(pos.shape[0], 1024, 4, pos.device)
            if key == "pressure_bar":
                ref = (P.eos.gamma - 1.0) * brute_kernel_sum(
                    pos, box, flat(s["h"]), flat(s["m"]) * flat(s["u"]),
                    idx, P.kernel)
            else:
                S = flat(s["u"]).clamp_min(1e-30) ** (1.0 / P.eos.gamma)
                ref = brute_kernel_sum(pos, box, flat(s["h"]),
                                       flat(s["m"]) * S, idx,
                                       P.kernel) / S[idx]
            perr = ((flat(got)[idx] - ref).abs() / ref.abs()).max().item()
            print(f"  {key} against the float64 brute force on 1024 "
                  f"particles: max relative error {perr:.3e}")
            check(perr <= 1e-4, f"{scheme}: {key} disagrees with the "
                  "float64 brute force")
        if scheme == "none":
            # no hydro: a_hydro and u_dt exactly 0, u never changes, so
            # gravity alone moves the particles
            check(bool((s["a_hydro"] == 0).all())
                  and bool((s["u_dt"] == 0).all()),
                  "none: a_hydro or u_dt not exactly 0")
            check(bool(torch.equal(u_by_pid(s, n), u0_pid)),
                  "none: the internal energy changed")
            a_g = (s["a_grav"] + s["a_grav_mesh"])[s["mask"] > 0]
            print(f"  none: a_hydro and u_dt exactly 0, u unchanged; "
                  f"|a_grav| max {a_g.norm(dim=-1).max().item():.4e}")
        hold_modes(eng, P, card, launches, cosmo,
                   solver.gas_short_range_fn().fuse_spec, kernels)
        print(f"  [{scheme}, {kernel}] main path {step_ms:.2f} ms/step")
        del eng, solver
        torch.cuda.empty_cache()
    return kernels


def planetary_engine(n_side, device):
    """The reference's mixed-material box (tests/test_planetary.py:102)
    on the flat backend: uniform_box_ic(n_side, jitter 0.05, seed 11) in 1
    m^3, masses x 998 (SI: water-like densities), every other particle
    ideal gas (ID_IDG_DEF) and Tillotson water (ID_TIL_WATER), u = 1e3
    J/kg, dt_max = 1e-7 s, no gravity.  Returns (engine, params, mat_id
    as loaded)."""
    import numpy as np
    from swift_subtask_dev_tpu_torch.engine import Engine, EngineConfig
    from swift_subtask_dev_tpu_torch.grid import CellGrid
    from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
    from swift_subtask_dev_tpu_torch.models.sph import SCHEMES
    from swift_subtask_dev_tpu_torch.models.sph import planetary_eos as pe
    ic = uniform_box_ic(n=n_side, jitter=0.05, seed=11)
    n = len(ic["pos"])
    eos = pe.PlanetaryEOS(materials=(pe.ID_IDG_DEF, pe.ID_TIL_WATER))
    P = SCHEMES["planetary"](h_max=float(ic["h"].max() * 3), eos=eos)
    mat = np.where(np.arange(n) % 2 == 0, pe.ID_IDG_DEF,
                   pe.ID_TIL_WATER).astype(np.int32)
    grid = CellGrid.build_columns(
        ic["box"], interaction_range=float(ic["h"].max() * P.kernel.gamma
                                           * 1.25), pos=ic["pos"])
    eng = Engine(grid, P, EngineConfig(dt_max=1e-7), 0.0, 1.0,
                 device=device)
    eng.load_particles(ic["pos"], np.asarray(ic["m"]) * 998.0, ic["v"],
                       np.full(n, 1.0e3, np.float32), ic["h"],
                       extra_fields={"mat_id": mat})
    return eng, P, mat


def energy_f64(s):
    """Kinetic + internal energy of the live particles, float64 sums."""
    live = s["mask"] > 0
    m = s["m"][live].double()
    v = s["v_full"][live].double()
    return float((0.5 * m * (v * v).sum(-1)
                  + m * s["u_full"][live].double()).sum())


def phase_planetary(device, card, n_side=PLANETARY_N):
    """The Planetary phase: the mixed-material box (planetary_engine) at
    the main path's size, init_particles() + PLANETARY_STEPS steps with
    the launch counters reset just before, then a rebucket forced within
    one more step and a re-grid.  Checks: finite state, P >= 0, energy
    drift over the steps within 2e-4 (the reference test's rule), the
    mat_id multiset unchanged and int32 after each rebucket, Minimal's
    bodies (Planetary's) launched and held against their plain versions
    on Planetary's fields."""
    import torch
    from swift_subtask_dev_tpu_torch.models.sph.sphenix import CosmoFactors
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    eng, P, mat = planetary_engine(n_side, device)
    n = len(mat)
    want = torch.bincount(torch.as_tensor(mat, device=device).long())
    print(f"phase 13b (Planetary): {n} particles, ideal gas and Tillotson "
          f"water, grid cdim={list(eng.grid.cdim)} W={eng.grid.K}")

    def mat_ok(what):
        s = eng.state
        live = s["mask"] > 0
        check(s["mat_id"].dtype == torch.int32,
              f"planetary: mat_id is {s['mat_id'].dtype} {what}")
        got = torch.bincount(s["mat_id"][live].long(),
                             minlength=want.numel())
        check(bool(torch.equal(got, want)),
              f"planetary: the mat_id multiset changed {what}")

    mat_ok("on loading")
    m0 = total_mass(eng.state)
    torch.cuda.synchronize()
    pair_flat.reset_launches()
    t0 = time.perf_counter()
    diag = eng.init_particles()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    e0 = energy_f64(eng.state)
    for _ in range(PLANETARY_STEPS):
        eng.step()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(pair_flat.LAUNCHES)
    e1 = energy_f64(eng.state)
    drift = abs(e1 - e0) / abs(e0)
    step_ms = 1e3 * (t2 - t1) / PLANETARY_STEPS
    s = eng.state
    live = s["mask"] > 0
    P_live = s["pressure"][live]
    print(f"  init_particles {t1 - t0:.3f} s (ghost iterations "
          f"{diag['n_ghost_iter']}), {PLANETARY_STEPS} steps "
          f"{t2 - t1:.3f} s: {step_ms:.2f} ms/step [{card}]; energy drift "
          f"{drift:.3e}; P in [{P_live.min().item():.4e}, "
          f"{P_live.max().item():.4e}] Pa; re-grids {eng.n_regrids}")
    print(f"  kernel launches: {launches}")
    bad = finite_state(s)
    check(not bad, f"planetary: non-finite state fields: {bad}")
    check(bool((P_live >= 0).all()), "planetary: negative pressure")
    check(drift < 2e-4, f"planetary: energy drift {drift:.3e} >= 2e-4")
    check(total_mass(s) == m0, "planetary: total mass changed")
    names, tag = mode_bodies(P)
    for name in names:
        check(launches.get(name + tag, 0) > 0,
              f"{name}{tag}: kernel never launched by the Planetary run")
    mat_ok("after the steps")
    eng.state["drift_accum"] = torch.full_like(eng.state["drift_accum"],
                                               float("inf"))
    eng.step()
    mat_ok("after a forced rebucket")
    eng.regrid()
    mat_ok("after a re-grid")
    kernels = hold_modes(eng, P, card, launches, CosmoFactors.no_cosmo())
    print(f"  [planetary, cubic-spline] {step_ms:.2f} ms/step")
    del eng
    torch.cuda.empty_cache()
    return kernels


def sod_run(scheme, kernel, n, device, card, t_end=SOD_T_END,
            max_steps=10 ** 9):
    """The port's Sod example (examples/sodshock.py) with the launch
    counters reset just before; finite state, total mass unchanged and
    every body of the mode launched.  Returns (engine, result,
    launches)."""
    import torch
    from swift_subtask_dev_tpu_torch.examples import sodshock
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    eng = sodshock.make_engine(n, t_end, scheme, kernel, device)
    m0 = total_mass(eng.state)
    torch.cuda.synchronize()
    pair_flat.reset_launches()
    eng, res = sodshock.run_sod(n, t_end, engine=eng, max_steps=max_steps)
    launches = dict(pair_flat.LAUNCHES)
    bad = finite_state(eng.state)
    check(not bad, f"Sod {scheme}/{kernel}: non-finite fields {bad}")
    check(total_mass(eng.state) == m0,
          f"Sod {scheme}/{kernel}: total mass changed")
    names, tag = mode_bodies(eng.sph)
    for name in names:
        check(launches.get(name + tag, 0) > 0,
              f"{name}{tag}: kernel never launched on the Sod run")
    return eng, res, launches


def sod_fuse_spec(grid):
    """Short-range gravity literals (``fuse_spec``) for the force +
    gravity holds on a Sod state, which has no gravity of its own: r_cut
    0.9 of the narrower column edge (the 9-column walk covers it), r_s =
    r_cut / 4.5 (the P3M split's r_cut_ratio), H = 3 eps with eps half
    the left state's spacing (1 / SOD_N), G = 1."""
    r_cut = 0.9 * min(grid.edge[0], grid.edge[1])
    return dict(G=1.0, H_soft=1.5 / SOD_N, r_s=r_cut / 4.5, r_cut=r_cut)


# the modes whose force + gravity body an earlier phase holds (SPHENIX
# with the cubic spline in phase 3, SCHEME_RUNS on the main path)
FUSED_ELSEWHERE = (("sphenix", "cubic-spline"),) + SCHEME_RUNS


def hold_other_kernels(eng, device, card, cosmo, entries, scheme=None):
    """Each mode of ``scheme`` (eng's own by default) under the kernels of
    no Sod run or earlier hold, on eng's developed state (SOD_HOLD_N, t =
    SOD_T_END): the state's particles on a column grid for the kernel's
    reach, init_particles() (density, ghost, gradient where the scheme has
    one, force; every body launched, counters reset just before), then
    each body with force + gravity (sod_fuse_spec) against its plain
    version per slot."""
    import dataclasses
    import torch
    from swift_subtask_dev_tpu_torch.engine import Engine
    from swift_subtask_dev_tpu_torch.grid.cellgrid import CellGrid
    from swift_subtask_dev_tpu_torch.models.sph import SCHEMES, scheme_name
    from swift_subtask_dev_tpu_torch.models.sph.kernels import KERNELS
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    own = scheme is None or scheme == scheme_name(eng.sph)
    scheme = scheme or scheme_name(eng.sph)
    pos, f = eng._extract_particles(eng.state)
    for kernel, K in KERNELS.items():
        if (scheme, kernel) in SOD_RUNS + FUSED_ELSEWHERE:
            continue
        t0 = time.perf_counter()
        P = (dataclasses.replace(eng.sph, kernel=K) if own
             else SCHEMES[scheme](kernel=K, h_max=eng.sph.h_max))
        grid = CellGrid.build_columns(
            eng.grid.box, interaction_range=float(f["h"].max() * K.gamma
                                                  * 1.4), pos=pos)
        e2 = Engine(grid, P, eng.cfg, eng.time, eng.time + 1.0,
                    device=device)
        e2.load_particles(pos, f["m"], f["v_full"], f["u_full"], f["h"],
                          pid=f["pid"])
        torch.cuda.synchronize()
        pair_flat.reset_launches()
        diag = e2.init_particles()
        torch.cuda.synchronize()
        launches = dict(pair_flat.LAUNCHES)
        bad = finite_state(e2.state)
        check(not bad, f"Sod {scheme}/{kernel}: non-finite fields {bad}")
        check(diag["n_ghost_iter"] < e2.cfg.max_ghost_iterations,
              f"Sod {scheme}/{kernel}: ghost did not converge")
        names, tag = mode_bodies(P)
        for name in names:
            check(launches.get(name + tag, 0) > 0,
                  f"{name}{tag}: kernel never launched by init_particles")
        print(f"phase 14: {scheme} with the {kernel} on the state at t = "
              f"{eng.time:.4f}: grid cdim={list(grid.cdim)} W={grid.K}, "
              f"ghost iterations {diag['n_ghost_iter']} [{card}]")
        hold_modes(e2, P, card, launches, cosmo, sod_fuse_spec(grid),
                   entries, per_slot=True)
        print(f"  {time.perf_counter() - t0:.1f} s for the mode")
        del e2
        torch.cuda.empty_cache()


def phase_sod(device, card):
    """Phase 14: the Sod shock (SOD_N, to SOD_T_END) of each of SOD_RUNS:
    L1(rho)/mean, L1(vx), energy drift and ms per step, L1(rho) no larger
    than the reference's own at n = 32 (SOD_REFERENCE_L1), each body of
    the mode against its plain version on the final state (each slot's
    sums within the f32 rounding bound of its sum of magnitudes,
    ``compare``: the tube's transverse accelerations cancel to ~0, so a
    fraction of max would hold rounding to the wrong scale), with force +
    gravity (sod_fuse_spec) where no earlier phase holds it; then every
    other mode (each scheme under the other kernels) on the final state
    of its scheme's cubic-spline Sod at SOD_HOLD_N (hold_other_kernels)."""
    import torch
    from swift_subtask_dev_tpu_torch.models.sph.sphenix import CosmoFactors
    kernels = []
    cosmo = CosmoFactors.no_cosmo()
    for scheme, kernel in SOD_RUNS:
        t0 = time.perf_counter()
        eng, res, launches = sod_run(scheme, kernel, SOD_N, device, card)
        n = int((eng.state["mask"] > 0).sum())
        ms = 1e3 * res["run_seconds"] / max(res["steps"], 1)
        print(f"phase 14: Sod {scheme} with the {kernel}, {n} particles, "
              f"grid cdim={list(eng.grid.cdim)} W={eng.grid.K}: "
              f"{res['steps']} steps to t = {res['t']:.4f} in "
              f"{res['run_seconds']:.3f} s ({ms:.2f} ms/step; init "
              f"{res['init_seconds']:.3f} s), re-grids {res['n_regrids']}; "
              f"L1(rho)/mean {res['l1_rho']:.5f}, L1(vx) "
              f"{res['l1_vx']:.5f}, energy drift "
              f"{res['energy_drift']:.3e} [{card}]")
        print(f"  kernel launches: {launches}")
        bound_l1 = SOD_REFERENCE_L1[(scheme, kernel)]
        check(res["l1_rho"] <= bound_l1,
              f"Sod {scheme}/{kernel}: L1(rho)/mean {res['l1_rho']:.5f} "
              f"above the reference's {bound_l1:.5f} at n = 32")
        fs = (None if (scheme, kernel) in FUSED_ELSEWHERE
              else sod_fuse_spec(eng.grid))
        hold_modes(eng, eng.sph, card, launches, cosmo, fs, entries=kernels,
                   per_slot=True)
        print(f"  {time.perf_counter() - t0:.1f} s for the run and holds")
        del eng
        torch.cuda.empty_cache()
    for scheme in dict.fromkeys(sc for sc, _ in SOD_RUNS):
        t0 = time.perf_counter()
        eng, res, _ = sod_run(scheme, "cubic-spline", SOD_HOLD_N, device,
                              card)
        print(f"phase 14: Sod {scheme} with the cubic-spline at n = "
              f"{SOD_HOLD_N}: {res['steps']} steps to t = {res['t']:.4f}, "
              f"L1(rho)/mean {res['l1_rho']:.5f} [{card}]")
        for held in [scheme] + [sc for sc, st in HOLD_STATE_OF.items()
                                if st == scheme]:
            hold_other_kernels(eng, device, card, cosmo, kernels, held)
        print(f"  {time.perf_counter() - t0:.1f} s for the scheme's holds")
        del eng
        torch.cuda.empty_cache()
    return kernels


def phase_vpu_peak(device, card):
    """T1: the FP32 probe against its plain version at 2 x 64 steps, then
    its entry point (the launch counter reset just before)."""
    import numpy as np
    import torch
    from swift_subtask_dev_tpu_torch.probes import vpu_peak
    iters = 2
    x = torch.as_tensor(np.random.default_rng(0).uniform(
        0.5, 1.5, (vpu_peak.ROWS, vpu_peak.LANES)).astype(np.float32),
        device=device)
    out_k = vpu_peak.fma_chains_kernel(x, iters).double()
    out_p = vpu_peak.fma_chains_plain(x, iters).double()
    max_abs = (out_k - out_p).abs().max().item()
    rel = ((out_k - out_p).abs() / out_p.abs()).max().item()
    tol = vpu_peak.tolerance(iters)
    print(f"phase 8 (probes): vpu_peak kernel vs plain at {iters} x "
          f"{vpu_peak.INNER} steps: max relative error {rel:.3e} "
          f"(tolerance {tol:.3e}), max abs {max_abs:.3e} [{card}]")
    check(rel <= tol, "vpu_peak: kernel and plain version disagree")
    torch.cuda.synchronize()
    vpu_peak.reset_launches()
    rates = vpu_peak.main([])
    torch.cuda.synchronize()
    launches = vpu_peak.LAUNCHES.get("vpu_peak", 0)
    check(launches > 0, "vpu_peak: kernel never launched by its entry point")
    full = rates["full"]
    xf = torch.ones((full["rows"], vpu_peak.LANES), dtype=torch.float32,
                    device=device)
    _, plain_ms = time_ms(
        lambda: vpu_peak.fma_chains_plain(xf, vpu_peak.ITERS), 1,
        warmup=False)
    n = xf.numel()
    t_ops = vpu_peak.flops(n, vpu_peak.ITERS) / PEAK_FP32_PER_S
    t_bytes = 8 * n / PEAK_BYTES_PER_S
    print(f"  plain version at the full size: {plain_ms:.1f} ms; launches "
          f"{launches} [{card}]")
    return [entry("vpu_peak_fma", VPU_SOURCE, VPU_REPLACES, launches,
                  max_abs, full["ms"], plain_ms, 1e3 * max(t_ops, t_bytes),
                  "operations" if t_ops >= t_bytes else "bytes")]


def phase_probe_kernel(device, card):
    """T2: the cost probe's six bodies on the flat kernel against their
    plain versions, then its entry point (counters reset just before)."""
    import torch
    from swift_subtask_dev_tpu_torch.ops import pair_flat
    from swift_subtask_dev_tpu_torch.probes import probe_kernel
    grid, f = probe_kernel.geometry(device=device)
    print(f"  probe_kernel: {int((f['mask'] > 0).sum())} particles, "
          f"{grid.cdim[0]} x {grid.cdim[1]} columns, W = {grid.K}")
    held = {}
    for pp in probe_kernel.probe_passes(f):
        launch, body = pair_flat.prepare(grid, pp), pp.body
        _, plain_ms, max_abs, pairs = hold_against_plain(
            pair_flat, launch, body, card)
        held[body.name] = (plain_ms, max_abs,
                           bound(body, flat_work(launch, body), pairs))
    torch.cuda.synchronize()
    pair_flat.reset_launches()
    times = probe_kernel.main([])
    torch.cuda.synchronize()
    launches = dict(pair_flat.LAUNCHES)
    kernels = []
    for name, (plain_ms, max_abs, (b_ms, b_by)) in held.items():
        check(launches.get(name, 0) > 0,
              f"pair_flat_{name}: kernel never launched by the probe")
        kernels.append(entry(f"pair_flat_{name}", PROBE_SOURCE,
                             PROBE_REPLACES, launches[name], max_abs,
                             times[name], plain_ms, b_ms, b_by))
    return kernels


def main():
    try:
        card = phase_card()
        import torch
        sys.path.insert(0, ROOT)
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_build(card)
        bodies = phase_kernel_vs_plain(device, card)
        kernels = phase_main_path(device, card, bodies)
        kernels += phase_sedov_pallas(device, card)
        kernels += phase_sedov_flat(device, card)
        kernels += phase_sedov_ring(device, card)
        kernels += phase_vpu_peak(device, card)
        kernels += phase_probe_kernel(device, card)
        kernels += phase_cosmo(device, card)
        phase_dmo(device, card)
        kernels += phase_eagle(device, card)
        phase_eagle_bh(device, card)
        kernels += phase_schemes_main(device, card)
        kernels += phase_planetary(device, card)
        kernels += phase_sod(device, card)
        # one entry a kernel mode: the first path that held it (the main
        # path's SPHENIX bodies, phase 13's before the Sod runs')
        first = {}
        for k in kernels:
            first.setdefault(k["name"], k)
        kernels = list(first.values())
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

"""Port vs reference: the five flat loops and the main-path slice.

Both engines run bench.py's default configuration (SPHENIX + P3M, flat
backend, split PM mesh) at a small size: uniform_box_ic(n=8, jitter=0.25,
seed=7) — 1,024 particles on a 3x3 column grid — with mesh_N = 32.  The
reference's flat kernel runs through the Pallas interpreter.

* Loops: each loop of ops/hydro_flat.py against ops/hydro_pallas.py on the
  identical state (the one the reference engine fed that loop, carried
  over with state_from_reference): 5e-5 of max, as test_flat_backend.py;
  min_ngb_time_bin exact.
* Slice: init_particles() then run_fixed_dt(4, per_launch=2) in both
  engines: per pid, rho, h and u_full within 1e-3 relative
  (test_flat_backend.py:84), a_grav and a_grav_mesh within 1e-3 of max.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.models import gravity as ref_gravity
from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as RefP
from swift_subtask_dev_tpu.ops import hydro_pallas
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
from swift_subtask_dev_tpu_torch.interop import state_from_reference
from swift_subtask_dev_tpu_torch.models import gravity as port_gravity
from swift_subtask_dev_tpu_torch.models.sph.sphenix import (CosmoFactors,
                                                            SPHENIXParams)
from swift_subtask_dev_tpu_torch.ops import hydro_flat

CPU = torch.device("cpu")
N1, MESH_N = 8, 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(pkg_grid, pkg_gravity, pkg_engine, Params, cfg_kw=(),
           interaction_range=None, **dev):
    """bench.py:154-183 at n1=8, mesh_N=32, for either package."""
    ic = uniform_box_ic(n=N1, jitter=0.25, seed=7)
    P = Params(h_max=float(ic["h"].max() * 3))
    gp = pkg_gravity.GravityParams(G=1.0, eps=0.5 / N1, mesh_N=MESH_N)
    r_cut = gp.r_cut_ratio * gp.a_smooth * 1.0 / gp.mesh_N
    hydro_reach = float(ic["h"].max() * P.kernel.gamma * 1.25)
    grid = pkg_grid.build_columns(
        ic["box"], interaction_range=(interaction_range
                                      or max(hydro_reach, r_cut * 1.15)),
        pos=ic["pos"])
    solver = pkg_gravity.GravitySolver(gp, grid, **dev)
    cfg = pkg_engine.EngineConfig(
        dt_max=2e-4, with_self_gravity=True, eps_soft=gp.eps,
        eta_grav=gp.eta, mesh_dt_max=64 * 2e-4, p2p_reach=solver.pm.r_cut,
        **dict(cfg_kw))
    eng = pkg_engine.Engine(grid, P, cfg, 0.0, 1.0,
                            gravity_fn=solver.gas_short_range_fn(),
                            mesh_fn=solver.gas_mesh_fn(),
                            mesh_dt_scale=solver.pm.r_s, **dev)
    eng.solver_builder = lambda g: pkg_gravity.GravitySolver(gp, g, **dev)
    eng.load_particles(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
    return eng, P, solver


def _np_state(state):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).copy() for k, v in state.items()}


LOOPS = ["density_loop", "gradient_loop", "force_loop",
         "force_gravity_loop", "p2p_gravity_loop"]


@pytest.fixture(scope="module")
def ref_run():
    """The reference engine's run, with the inputs and outputs of the
    first executed call of each hydro_pallas loop recorded on the host
    (jax.debug.callback): the loops are compared on exactly the states the
    reference engine produced, at no extra compilation."""
    calls = {}

    def recorder(name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)

            def store(s, act, o):
                calls.setdefault(name, jax.tree_util.tree_map(
                    lambda x: np.array(x), (s, act, o)))
            jax.debug.callback(store, args[1], kw.get("active_i"), out)
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        for name in LOOPS:
            mp.setattr(hydro_pallas, name,
                       recorder(name, getattr(hydro_pallas, name)))
        eng, P, solver = _setup(RefGrid, ref_gravity, ref_engine, RefP,
                                cfg_kw={"backend": "flat"})
        d = eng.init_particles()
        init = _np_state(eng.state)
        eng.run_fixed_dt(4, per_launch=2)
        final = _np_state(eng.state)
        eng._mesh_boundary()      # close + reopen the mesh kick mid-run
        mesh = _np_state(eng.state)
    return {"eng": eng, "P": P, "solver": solver, "init": init,
            "n_ghost_iter": int(d["n_ghost_iter"]), "final": final,
            "mesh": mesh, "calls": calls}


@pytest.fixture(scope="module")
def port_run():
    eng, P, solver = _setup(CellGrid, port_gravity, port_engine,
                            SPHENIXParams, device=CPU)
    d = eng.init_particles()
    init = _np_state(eng.state)
    eng.run_fixed_dt(4, per_launch=2)
    final = _np_state(eng.state)
    eng._mesh_boundary()
    return {"eng": eng, "P": P, "solver": solver, "init": init,
            "n_ghost_iter": d["n_ghost_iter"], "final": final,
            "mesh": _np_state(eng.state)}


def _rel_max(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


def _perpid(s, x):
    pid = s["pid"].ravel()
    m = s["mask"].ravel() > 0
    x = np.asarray(x).reshape(-1, *np.asarray(x).shape[2:])
    return x[m][np.argsort(pid[m])]


@pytest.mark.parametrize("loop", LOOPS)
def test_flat_loop_matches_reference(ref_run, port_run, loop):
    """Each port loop on the state the reference loop saw (first call:
    density in the init ghost with active_i, gradient/force/P2P in the
    init pass, fused force+gravity in the first step with active_i)."""
    s_np, act, ref = ref_run["calls"][loop]
    grid_r = ref_run["eng"].grid
    grid_p = CellGrid(grid_r.box, grid_r.cdim, grid_r.K)
    st = state_from_reference(s_np, CPU)
    kw = {} if act is None else {"active_i": torch.from_numpy(act)}
    Pp, cosmo = port_run["P"], CosmoFactors.no_cosmo()
    fs = dict(ref_run["solver"].gas_short_range_fn().fuse_spec)
    assert fs.pop("periodic_truncation") is True   # the port's only mode
    if loop == "density_loop":
        port = hydro_flat.density_loop(grid_p, st, Pp, **kw)
    elif loop == "gradient_loop":
        port = hydro_flat.gradient_loop(grid_p, st, Pp, cosmo, **kw)
    elif loop == "force_loop":
        port = hydro_flat.force_loop(grid_p, st, Pp, cosmo, **kw)
    elif loop == "force_gravity_loop":
        assert act is not None
        port = hydro_flat.force_gravity_loop(grid_p, st, Pp, cosmo, **fs,
                                             **kw)
    else:
        port = hydro_flat.p2p_gravity_loop(
            grid_p, st, [st], fs["G"], fs["H_soft"], fs["r_s"],
            fs["r_cut"])
        ref = dict(zip(("acc", "pot"), ref))
        port = dict(zip(("acc", "pot"), port))
    assert ref.keys() == port.keys()
    for k in ref:
        a, b = np.asarray(ref[k]), port[k].numpy()
        if k == "min_ngb_time_bin":
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert _rel_max(a, b) < 5e-5, (loop, k)


def test_init_pass_matches_reference(ref_run, port_run):
    r, p = ref_run["init"], port_run["init"]
    assert ref_run["n_ghost_iter"] == port_run["n_ghost_iter"] < 30
    for k in ("rho", "h", "u_full", "v_sig", "balsara", "alpha_visc"):
        a, b = _perpid(r, r[k]), _perpid(p, p[k])
        assert np.max(np.abs(a - b) / (np.abs(a) + 1e-10)) < 1e-4, k
    for k in ("a_hydro", "a_grav", "a_grav_mesh", "v_full"):
        assert _rel_max(_perpid(r, r[k]), _perpid(p, p[k])) < 1e-4, k
    assert np.array_equal(_perpid(r, r["time_bin"]),
                          _perpid(p, p["time_bin"]))


def test_main_path_slice_matches_reference(ref_run, port_run):
    r, p = ref_run["final"], port_run["final"]
    er, ep = ref_run["eng"], port_run["eng"]
    assert er.timeline.ti_current == ep.timeline.ti_current
    assert (er.ti_mesh_end, er.n_mesh_updates, er.step_count) == \
        (ep.ti_mesh_end, ep.n_mesh_updates, ep.step_count)
    assert np.array_equal(_perpid(r, r["pid"]), _perpid(p, p["pid"]))
    for k in ("rho", "h", "u_full"):
        a, b = _perpid(r, r[k]), _perpid(p, p[k])
        assert np.max(np.abs(a - b) / (np.abs(a) + 1e-10)) < 1e-3, k
    for k in ("a_grav", "a_grav_mesh"):
        assert _rel_max(_perpid(r, r[k]), _perpid(p, p[k])) < 1e-3, k
    for k, v in p.items():
        assert np.all(np.isfinite(v)), k


def test_mesh_boundary_mid_run_matches_reference(ref_run, port_run):
    """A mesh-step boundary after the run: the old half-kick closes with
    the old field, the new field and the next interval match."""
    r, p = ref_run["mesh"], port_run["mesh"]
    er, ep = ref_run["eng"], port_run["eng"]
    assert (er.ti_mesh_end, er.ti_mesh_mid, er.n_mesh_updates) == \
        (ep.ti_mesh_end, ep.ti_mesh_mid, ep.n_mesh_updates)
    for k in ("a_grav_mesh", "pot_mesh", "v_full"):
        assert _rel_max(_perpid(r, r[k]), _perpid(p, p[k])) < 1e-3, k


def test_forced_rebucket_only_permutes_slots():
    """A step whose rebucket trigger fires moves particles between slots
    (z-sorted again) and changes no physics: per pid, the state matches a
    step without the rebucket to f32 summation order."""
    engines = []
    for force in (False, True):
        eng, _, _ = _setup(CellGrid, port_gravity, port_engine,
                           SPHENIXParams, device=CPU)
        eng.init_particles()
        if force:
            eng.state["drift_accum"] = torch.tensor(1e30)
        eng.run_fixed_dt(1)
        engines.append(_np_state(eng.state))
    a, b = engines
    assert float(b["drift_accum"]) == 0.0 and float(a["drift_accum"]) > 0
    m = b["mask"] > 0
    z = np.where(m, b["off"][..., 2], 2.0)
    assert np.all(np.diff(z, axis=1)[m[:, 1:]] >= 0)
    for k in ("rho", "h", "u_full", "v_full", "a_grav", "a_hydro"):
        assert _rel_max(_perpid(a, a[k]), _perpid(b, b[k])) < 1e-5, k


def test_regrid_with_gravity_rebinds_the_solver():
    """A grid whose columns are narrower than the smoothing-length reach
    (but wide enough for the P2P cut-off) hits the coverage wall in
    init_particles(): the retry re-grids to the columns a direct setup
    builds, rebinds gravity through solver_builder, and the run then
    matches the direct one per pid.  Without solver_builder, regrid()
    raises and leaves the grid and state as they were."""
    narrow, _, _ = _setup(CellGrid, port_gravity, port_engine,
                          SPHENIXParams, interaction_range=0.18, device=CPU)
    direct, _, _ = _setup(CellGrid, port_gravity, port_engine,
                          SPHENIXParams, device=CPU)
    assert narrow.grid.cdim[0] > direct.grid.cdim[0]
    old_fns = (narrow.gravity_fn, narrow.mesh_fn)
    runs = []
    for eng in (narrow, direct):
        eng.init_particles()
        eng.run_fixed_dt(1)
        runs.append(_np_state(eng.state))
    assert (narrow.n_regrid_retries, narrow.n_regrids) == (1, 1)
    assert narrow.grid.cdim == direct.grid.cdim
    assert narrow.gravity_fn is not old_fns[0]
    assert narrow.mesh_fn is not old_fns[1]
    a, b = runs
    for k in ("rho", "h", "u_full", "v_full", "a_grav", "a_grav_mesh",
              "a_hydro"):
        assert _rel_max(_perpid(b, b[k]), _perpid(a, a[k])) < 1e-5, k

    direct.solver_builder = None
    grid, state = direct.grid, direct.state
    with pytest.raises(RuntimeError, match="solver_builder"):
        direct.regrid()
    assert direct.grid is grid and direct.state is state


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import swift_subtask_dev_tpu_torch.engine\n"
            "import swift_subtask_dev_tpu_torch.models.gravity\n"
            "import swift_subtask_dev_tpu_torch.interop\n"
            "import swift_subtask_dev_tpu_torch.ops.pair_packed\n"
            "import swift_subtask_dev_tpu_torch.examples.sedov\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] == 'swift_subtask_dev_tpu']\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py needs a card: here (no CUDA) it exits non-zero and
    prints no result line."""
    res = subprocess.run([sys.executable, os.path.join(REPO,
                                                       "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_step_matches_fixed_dt_step():
    """Engine.step() (host timeline: tables per step, ti_end_min from the
    bin counts, mesh boundary check) advances an all-max-bin state exactly
    as one run_fixed_dt step does."""
    engines = []
    for _ in range(2):
        eng, _, _ = _setup(CellGrid, port_gravity, port_engine,
                           SPHENIXParams, device=CPU)
        eng.init_particles()
        engines.append(eng)
    a, b = engines
    diag = a.step()
    b.run_fixed_dt(1)
    assert a.timeline.ti_current == b.timeline.ti_current > 0
    assert a.step_count == b.step_count == 1
    assert a._ti_end_min == b._ti_end_min
    assert int(diag["n_overflow"]) == 0 and diag["n_ghost_iter"] < 30
    for k, v in a.state.items():
        assert torch.equal(v, b.state[k]), k

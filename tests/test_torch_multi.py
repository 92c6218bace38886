"""Port vs reference: the multi-species (gas + DM) engine.

Engines are compared per particle id, never per slot: the multi engine
orders a cell's slots differently from the one-species engine (the
reason ``test_multi_engine.py::test_gas_only_multi_matches_single`` fails
in the reference).  Per pid: positions within 1e-5 of the box, v_full and
u_full within 1e-4 of max, rho within 1e-4 relative, time bins equal.

* ``test_multi_flat.py``'s gas + DM run (uniform_box_ic(n=8,
  jitter=0.05), 1,024 DM drawn uniformly, mesh_N = 32, P2P + split mesh,
  init + 3 steps) in both packages (the reference's flat kernel in the
  Pallas interpreter);
* the port's gas-only MultiEngine against its own Engine;
* ``test_gas_dm_cosmo_uniform_static`` on the flat grid with split mesh
  kicks: a comoving uniform gas + DM box stays static, in both packages;
* the SmallCosmoVolume example at n = 8 (the box scaled to keep
  SmallCosmoVolume_hydro's spacing) with constant-Lambda cooling, against
  the reference built the way its CLI builds the run.
"""

import numpy as np
import pytest
import torch

from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu import engine_multi as ref_multi
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.grid.cellgrid import global_positions as ref_gpos
from swift_subtask_dev_tpu.models import cosmology as ref_cosmology
from swift_subtask_dev_tpu.models import gravity as ref_gravity
from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as RefP
from swift_subtask_dev_tpu.subgrid import cooling as ref_cooling
from swift_subtask_dev_tpu.utils import units as ref_units
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch import engine_multi as port_multi
from swift_subtask_dev_tpu_torch.examples import small_cosmo_volume as scv
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.grid.cellgrid import global_positions
from swift_subtask_dev_tpu_torch.ics import (bcc_lattice,
                                             small_cosmo_volume_ic,
                                             uniform_box_ic)
from swift_subtask_dev_tpu_torch.interop import multi_state_from_reference
from swift_subtask_dev_tpu_torch.models import cosmology as port_cosmology
from swift_subtask_dev_tpu_torch.models import gravity as port_gravity
from swift_subtask_dev_tpu_torch.models.sph.sphenix import SPHENIXParams

CPU = torch.device("cpu")
REF = (RefGrid, ref_gravity, ref_multi, RefP, ref_gpos, {})
PORT = (CellGrid, port_gravity, port_multi, SPHENIXParams, global_positions,
        {"device": CPU})


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def per_pid(state, grid, gpos):
    """{species: {field: live values sorted by pid}} of a multi state (or
    of a one-species state given as {"gas": state})."""
    out = {}
    for name, sp in state.items():
        s = {k: _np(v) for k, v in sp.items()}
        mask = s["mask"] > 0
        order = np.argsort(s["pid"][mask])
        row = {"pos": gpos(grid, s["off"])[mask][order]}
        for k in ("pid", "v_full", "time_bin", "u_full", "rho", "h"):
            if k in s:
                row[k] = s[k][mask][order]
        out[name] = row
    return out


def assert_same(a, b, box=1.0):
    assert a.keys() == b.keys()
    for name in a:
        x, y = a[name], b[name]
        assert np.array_equal(x["pid"], y["pid"]), name
        d = np.abs(x["pos"] - y["pos"])
        d = np.minimum(d, box - d)             # periodic
        assert d.max() <= 1e-5 * box, (name, d.max())
        assert np.array_equal(x["time_bin"], y["time_bin"]), name
        for k in ("v_full", "u_full"):
            if k in x:
                err = np.abs(x[k] - y[k]).max() / np.abs(x[k]).max()
                assert err <= 1e-4, (name, k, err)
        if "rho" in x:
            err = (np.abs(x["rho"] - y["rho"]) / x["rho"]).max()
            assert err <= 1e-4, (name, "rho", err)


# ---------------------------------------------------------------------------
# test_multi_flat.py's gas + DM run
# ---------------------------------------------------------------------------

def _flat_run(pkg, n_steps=3):
    Grid, gravity, multi, Params, gpos, dev = pkg
    ic = uniform_box_ic(n=8, jitter=0.05)
    n = len(ic["pos"])
    pos_dm = np.random.default_rng(2).uniform(0, 1, (n, 3))
    gp = gravity.GravityParams(G=1.0, eps=0.02, mesh_N=32)
    sph = Params()
    r_cut = gp.r_cut_ratio * gp.a_smooth * 1.0 / gp.mesh_N
    reach = max(float(ic["h"].max()) * sph.kernel.gamma * 1.3,
                r_cut * 1.0001)
    grid = Grid.build_columns((1.0, 1.0, 1.0), reach,
                              np.concatenate([ic["pos"], pos_dm]))
    solver = gravity.GravitySolver(gp, grid, **dev)
    cfg = multi.EngineConfig(dt_min=1e-12, dt_max=2e-3,
                             with_self_gravity=True, eta_grav=gp.eta,
                             eps_soft=gp.eps, p2p_reach=solver.pm.r_cut,
                             backend="flat")
    eng = multi.MultiEngine(grid, sph, cfg, 0.0, 1.0,
                            gravity_fn=solver.short_range_accelerations,
                            eps_soft=gp.eps,
                            mesh_fn=solver.mesh_accelerations,
                            mesh_dt_scale=solver.pm.r_s, **dev)
    eng.load_gas(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
    eng.load_dm(pos_dm, np.full(n, 2.0 / n, np.float32),
                np.zeros((n, 3), np.float32))
    eng.init_particles()
    init = per_pid(eng.state, eng.grid, gpos)
    for _ in range(n_steps):
        eng.step()
    return {"eng": eng, "init": init,
            "final": per_pid(eng.state, eng.grid, gpos)}


def test_gas_dm_flat_run_matches_reference_per_pid():
    """After init_particles() and after 3 steps (one test: the reference's
    run is the expensive part, and a test per comparison would rerun it
    on each xdist worker)."""
    ref, port = _flat_run(REF), _flat_run(PORT)
    for when in ("init", "final"):
        assert_same(ref[when], port[when])
    assert port["final"].keys() == {"gas", "dm"}
    assert len(port["final"]["dm"]["pid"]) == 1024


def test_multi_state_from_reference():
    """A reference {species: state} carried across: every species, key,
    shape and dtype, values bit for bit."""
    ic = uniform_box_ic(n=4, jitter=0.05)
    n = len(ic["pos"])
    grid = RefGrid.build_columns((1.0, 1.0, 1.0), 0.3, ic["pos"])
    eng = ref_multi.MultiEngine(grid, RefP(), ref_engine.EngineConfig(
        backend="flat"), 0.0, 1.0)
    eng.load_gas(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
    eng.load_dm(np.mod(ic["pos"] + 0.1, 1.0), ic["m"],
                np.zeros((n, 3), np.float32))
    ref = {name: {k: _np(v) for k, v in sp.items()}
           for name, sp in eng.state.items()}
    port = multi_state_from_reference(ref, CPU)
    assert port.keys() == ref.keys() == {"gas", "dm"}
    for name in ref:
        assert port[name].keys() == ref[name].keys()
        for k, v in ref[name].items():
            b = port[name][k].numpy()
            assert v.dtype == b.dtype and v.shape == b.shape, (name, k)
            assert np.array_equal(v, b), (name, k)
    assert port["dm"]["drift_accum"].shape == ()


# ---------------------------------------------------------------------------
# gas only: the port's MultiEngine against its own Engine
# ---------------------------------------------------------------------------

def test_gas_only_multi_matches_single_per_pid():
    ic = uniform_box_ic(n=6, jitter=0.1, seed=2)
    P = SPHENIXParams(h_max=0.4)
    grid = CellGrid.build_columns((1.0, 1.0, 1.0),
                                  float(ic["h"].max()) * 1.825742 * 1.3,
                                  ic["pos"])
    cfg = port_engine.EngineConfig(dt_max=5e-4)
    e1 = port_engine.Engine(grid, P, cfg, 0.0, 1.0, device=CPU)
    e1.load_particles(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
    e1.init_particles()
    e2 = port_multi.MultiEngine(grid, P, cfg, 0.0, 1.0, device=CPU)
    e2.load_gas(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
    e2.init_particles()
    for _ in range(3):
        e1.step()
        e2.step()
    assert e1.timeline.ti_current == e2.timeline.ti_current
    a = per_pid({"gas": e1.state}, grid, global_positions)
    b = per_pid(e2.state, grid, global_positions)
    assert_same(a, b)
    assert np.allclose(a["gas"]["h"], b["gas"]["h"], rtol=1e-5)


def test_multi_engine_refuses_what_is_not_ported():
    grid = CellGrid((1.0, 1.0, 1.0), (3, 3, 1), 128)
    cfg = port_engine.EngineConfig()
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        port_multi.MultiEngine(grid, SPHENIXParams(), cfg, 0.0, 1.0,
                               device=CPU, bh_model=object())
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        port_multi.MultiEngine(
            CellGrid((1.0, 1.0, 1.0), (3, 3, 3), 8), SPHENIXParams(),
            port_engine.EngineConfig(backend="pallas"), 0.0, 1.0,
            device=CPU)
    with pytest.raises(TypeError):
        port_multi.MultiEngine(grid, SPHENIXParams(), cfg, 0.0, 1.0,
                               device=CPU, stars=object())


# ---------------------------------------------------------------------------
# a comoving uniform gas + DM box stays static
# ---------------------------------------------------------------------------

def _static_run(pkg, cosmo_mod, units):
    Grid, gravity, multi, Params, gpos, dev = pkg
    cosmo = cosmo_mod.Cosmology(Omega_cdm=0.75, Omega_b=0.25,
                                Omega_lambda=0.0, h=0.7, a_begin=0.5,
                                a_end=1.0,
                                phys_const=units.COSMO_UNITS.constants())
    ic = uniform_box_ic(n=6, u0=1e-8)
    dm_pos = np.mod(bcc_lattice((6, 6, 6), (1.0, 1.0, 1.0)) + 0.031, 1.0)
    n_dm = len(dm_pos)
    P = Params(h_max=0.3)
    gp = gravity.GravityParams(G=1.0, eps=5e-3, mesh_N=32)
    r_cut = gp.r_cut_ratio * gp.a_smooth / gp.mesh_N
    # 3 x 3 columns: they cover the gas's reach and r_cut
    reach = max(float(ic["h"].max()) * P.kernel.gamma * 1.05, r_cut * 1.15)
    grid = Grid.build_columns((1.0, 1.0, 1.0), reach,
                              np.concatenate([ic["pos"], dm_pos]))
    assert grid.cdim == (3, 3, 1)
    solver = gravity.GravitySolver(gp, grid, **dev)
    cfg = multi.EngineConfig(dt_max=1e30, with_self_gravity=True,
                             p2p_reach=solver.pm.r_cut, eta_grav=gp.eta,
                             backend="flat")
    eng = multi.MultiEngine(grid, P, cfg, 0.0, 0.0,
                            gravity_fn=solver.short_range_accelerations,
                            eps_soft=gp.eps, cosmology=cosmo,
                            mesh_fn=solver.mesh_accelerations,
                            mesh_dt_scale=solver.pm.r_s, **dev)
    eng.solver_builder = lambda g: gravity.GravitySolver(gp, g, **dev)
    eng.load_gas(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
    eng.load_dm(dm_pos, np.full(n_dm, 3.0 / n_dm, np.float32),
                np.zeros((n_dm, 3), np.float32))
    eng.init_particles()
    for _ in range(4):
        eng.step()
    return eng, cosmo, per_pid(eng.state, eng.grid, gpos)


def test_gas_dm_cosmo_uniform_static():
    """The port's box stays static (peculiar velocities below 2% of the
    Hubble flow across it, as the reference's test), and matches the
    reference per pid: positions 1e-5, time bins equal, rho 1e-4
    relative, and the peculiar velocities, round-off around the static
    solution, within 1e-4 of the static test's own bound."""
    from swift_subtask_dev_tpu_torch.utils import units as port_units
    ref, _, a = _static_run(REF, ref_cosmology, ref_units)
    port, cosmo, b = _static_run(PORT, port_cosmology, port_units)
    a_now = cosmo.a_of_ti(port.timeline.ti_current)
    assert a_now > 0.5
    H_L = float(cosmo.H(a_now)) * 1.0
    for sp in ("gas", "dm"):
        m = port.state[sp]["mask"] > 0
        v = port.state[sp]["v_full"][m]
        assert float(v.abs().max()) < 2e-2 * H_L, sp
    assert ref.timeline.ti_current == port.timeline.ti_current
    for name in a:
        assert np.array_equal(a[name]["time_bin"], b[name]["time_bin"])
        assert np.abs(a[name]["v_full"] - b[name]["v_full"]).max() \
            <= 1e-4 * 2e-2 * H_L
        assert np.abs(a[name]["pos"] - b[name]["pos"]).max() <= 1e-5
    err = np.abs(a["gas"]["rho"] - b["gas"]["rho"]) / a["gas"]["rho"]
    assert err.max() <= 1e-4


# ---------------------------------------------------------------------------
# the SmallCosmoVolume example at n = 8 with cooling
# ---------------------------------------------------------------------------

N_SCV = 8
L_SCV = scv.BOX * N_SCV / scv.N_SIDE     # SmallCosmoVolume_hydro's spacing


def _ref_scv(ic):
    """The reference's run, built as its CLI's multi path builds it
    (cli.py:739-900 with run.yml's values)."""
    units = ref_units.COSMO_UNITS
    pc = units.constants()
    cosmology = ref_cosmology.Cosmology(
        Omega_cdm=scv.OMEGA_CDM, Omega_b=scv.OMEGA_B,
        Omega_lambda=scv.OMEGA_LAMBDA, h=scv.HUBBLE_H, a_begin=scv.A_BEGIN,
        a_end=scv.A_END, phys_const=pc)
    sph = RefP(eta_neighbours=scv.RESOLUTION_ETA, CFL=scv.CFL,
               minimal_internal_energy=scv.U_MIN)
    gp = ref_gravity.GravityParams(G=pc.const_newton_G, eps=scv.EPS_BARYON,
                                   mesh_N=scv.MESH_N, eta=scv.ETA_GRAV)
    cooling_fn = ref_cooling.make_cooling_fn(
        ref_cooling.ConstLambdaCooling.from_cgs(scv.LAMBDA_NH2_CGS, units,
                                                pc),
        None, u_minimal=scv.U_MIN)
    gas, dm = ic["gas"], ic["dm"]
    box = tuple(ic["box"])
    h0 = np.asarray(gas["h"], np.float32)
    reach = float(h0.max()) * sph.kernel.gamma * 1.3
    r_cut = gp.r_cut_ratio * gp.a_smooth * float(box[0]) / gp.mesh_N
    grid = RefGrid.build_columns(box, max(reach, r_cut * 1.15),
                                 np.concatenate([gas["pos"], dm["pos"]]))
    solver = ref_gravity.GravitySolver(gp, grid)
    cfg = ref_engine.EngineConfig(dt_min=scv.DT_MIN, dt_max=scv.DT_MAX,
                                  with_self_gravity=True, eta_grav=gp.eta,
                                  eps_soft=gp.eps,
                                  p2p_reach=solver.pm.r_cut, backend="flat")
    eps_dm = gp.eps_dm or gp.eps
    solver.eps_per_species = [gp.eps, eps_dm] + [gp.eps] * 3
    eng = ref_multi.MultiEngine(grid, sph, cfg, scv.A_BEGIN, scv.A_END,
                                gravity_fn=solver.short_range_accelerations,
                                eps_soft=(gp.eps, eps_dm),
                                cosmology=cosmology, cooling_fn=cooling_fn,
                                mesh_fn=solver.mesh_accelerations,
                                mesh_dt_scale=solver.pm.r_s)
    eng.load_gas(gas["pos"], gas["m"], gas["v"], gas["u"], h0,
                 pid=gas["pid"].astype(np.int32))
    eng.load_dm(dm["pos"], dm["m"], dm["v"], pid=dm["pid"].astype(np.int32))
    return eng


def test_small_cosmo_volume_matches_reference_per_pid():
    """After init_particles() and after 3 steps, per pid (positions within
    1e-5 of the box); and the run is comoving (its timeline in log(a)),
    cooling keeps u above the minimal internal energy, both species
    move, and the mesh runs."""
    ic = small_cosmo_volume_ic(n=N_SCV, L=L_SCV)
    runs = {}
    for label in ("ref", "port"):
        if label == "ref":
            eng, gpos = _ref_scv(ic), ref_gpos
        else:
            eng, gpos = scv.make_engine(N_SCV, L_SCV, CPU, ic=ic)[0], \
                global_positions
        eng.init_particles()
        init = per_pid(eng.state, eng.grid, gpos)
        for _ in range(3):
            eng.step()
        runs[label] = {"eng": eng, "init": init,
                       "final": per_pid(eng.state, eng.grid, gpos)}
    for when in ("init", "final"):
        assert_same(runs["ref"][when], runs["port"][when], box=L_SCV)
    eng, ref = runs["port"]["eng"], runs["ref"]["eng"]
    assert eng.timeline.ti_current == ref.timeline.ti_current > 0
    a = eng.cosmology.a_of_ti(eng.timeline.ti_current)
    assert scv.A_BEGIN < a < scv.A_END
    final = runs["port"]["final"]
    assert final["gas"]["u_full"].min() >= scv.U_MIN
    for name in ("gas", "dm"):
        assert np.abs(final[name]["v_full"]).max() > 0
    assert eng.cooling_fn is not None and eng.n_mesh_updates >= 1

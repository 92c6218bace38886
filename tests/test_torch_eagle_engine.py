"""Port vs reference: the EAGLE volume without black holes, whole.

* The reference's ``MultiEngine`` built as its CLI builds ``swift-tpu
  run.yml --eagle`` (``cli.build_subgrid``; ``cli.py:739-960``'s multi
  path, flat backend) against the port's example (``make_engine``), on
  the same small volume (2 x 8^3 sites, 10 stars in 25 Mpc, z = 9), for
  ``init_particles()`` and 3 steps, compared per particle id (the
  engines order a cell's slots differently).  So that every
  mechanism runs in 3 steps, both take the same crafted state: after
  init the loaded stars get a birth time older than the SNII delay and
  the gas's smallest time bin (they fire and enrich in step 0), and the
  star-formation thresholds are lowered (threshold_norm 1e-6 cm^-3,
  over-density 0.1, entropy margin 3 dex, KS normalisation 1e-3, the
  Cool floor's over-density 0.1), so that gas converts in steps 0 and 1.
  Per pid: positions within 1e-5 of the box; v_full and u_full within
  1e-4 of max; rho within 1e-4 relative; h within 1e-5 relative; Z,
  element fractions and masses within 1e-5 of max; time bins equal.
  Per step: the same converted pids, equal heating and wake counts, the
  enriched mass within 1e-4 (ejecta difference two table
  interpolations, which amplifies the rounding of pow, log10 and exp).
  At this size each column holds one 128-slot tile, so the reference's
  star-formation holes in the gas columns (ROADMAP.md queue 3) cannot
  push a particle out of its tile.
* ``interop.multi_state_from_reference`` carries the stars across.
* ``ics.eagle_volume_ic`` against the reference's ``make_ics.py``.
* The example's CPU entry point, and the refusals.

The reference's run takes ~3 minutes here (its step compiles the Pallas
kernels in the interpreter), so it is one test.
"""

import copy
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift_subtask_dev_tpu import cli as ref_cli
from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu import engine_multi as ref_multi
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.grid.cellgrid import global_positions as ref_gpos
from swift_subtask_dev_tpu.models import cosmology as ref_cosmology
from swift_subtask_dev_tpu.models import gravity as ref_gravity
from swift_subtask_dev_tpu.subgrid.chemistry import (
    EagleChemistry as RefChemistry)
from swift_subtask_dev_tpu.utils import units as ref_units
from swift_subtask_dev_tpu.utils.params import Params as RefParams
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch import engine_multi as port_multi
from swift_subtask_dev_tpu_torch.examples import eagle_volume as ev
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.grid.cellgrid import global_positions
from swift_subtask_dev_tpu_torch.ics import eagle_volume_ic
from swift_subtask_dev_tpu_torch.interop import multi_state_from_reference
from swift_subtask_dev_tpu_torch.models.sph.sphenix import SPHENIXParams

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """torch on two threads in these tests: under several test workers
    per machine its default of one thread per core oversubscribes the
    cores (the reference's XLA runs its own pool beside it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
N_SIDE, BOX, STEPS = 8, 25.0, 3
FIELDS = ("pid", "v_full", "time_bin", "u_full", "rho", "h", "Z", "m",
          "elem_frac")


def _run_yml():
    """run.yml with star formation made easy (see the module docstring)."""
    ry = copy.deepcopy(ev.RUN_YML)
    ry["EAGLEStarFormation"].update(
        threshold_norm_H_p_cm3=1e-6, threshold_over_density=0.1,
        EOS_entropy_margin_dex=3.0, KS_normalisation=1e-3)
    ry["EAGLEEntropyFloor"]["Cool_over_density_threshold"] = 0.1
    return ry


def _ref_engine(ic, run_yml):
    """The reference's run, built as its CLI's multi path builds
    ``--eagle`` (cli.py:739-960 with build_subgrid)."""
    params = RefParams(copy.deepcopy(run_yml))
    units = ref_units.COSMO_UNITS
    pc = units.constants()
    cosmology = ref_cosmology.make_cosmology_from_params(params, pc)
    sph, _ = ref_cli.build_sph_params(params)

    class Args:
        cooling = star_formation = feedback = True
        black_holes = sinks = False
    (cooling_fn, sf, floor, fb, _, _, enr) = ref_cli.build_subgrid(
        params, units, Args, cosmology, sph)
    gp = ref_gravity.GravityParams(
        G=pc.const_newton_G,
        eps=params.get_float("Gravity", "comoving_baryon_softening"),
        eps_dm=0.0, mesh_N=params.get_int("Gravity", "mesh_side_length"),
        eta=params.get_float("Gravity", "eta"))
    gas, dm, st = ic["gas"], ic["dm"], ic["stars"]
    box = tuple(ic["box"])
    h0 = np.asarray(gas["h"], np.float32)
    reach = float(h0.max()) * sph.kernel.gamma * 1.3
    r_cut = gp.r_cut_ratio * gp.a_smooth * float(box[0]) / gp.mesh_N
    grid = RefGrid.build_columns(
        box, max(reach, r_cut * 1.15),
        np.concatenate([gas["pos"], dm["pos"], st["pos"]]))
    solver = ref_gravity.GravitySolver(gp, grid)
    cfg = ref_engine.EngineConfig(
        dt_min=params.get_float("TimeIntegration", "dt_min"),
        dt_max=params.get_float("TimeIntegration", "dt_max"),
        with_self_gravity=True, with_timestep_limiter=True,
        eta_grav=gp.eta, eps_soft=gp.eps, p2p_reach=solver.pm.r_cut,
        backend="flat")
    eps_dm = gp.eps_dm or gp.eps
    solver.eps_per_species = [gp.eps, eps_dm] + [gp.eps] * 3
    eng = ref_multi.MultiEngine(
        grid, sph, cfg, cosmology.a_begin, cosmology.a_end,
        gravity_fn=solver.short_range_accelerations,
        eps_soft=(gp.eps, eps_dm), cosmology=cosmology,
        cooling_fn=cooling_fn, star_formation=sf, entropy_floor=floor,
        feedback=fb, enrichment=enr, mesh_fn=solver.mesh_accelerations,
        mesh_dt_scale=solver.pm.r_s)
    Z, ef = RefChemistry.from_params(params).particle_arrays(len(gas["pos"]))
    eng.load_gas(gas["pos"], gas["m"], gas["v"], gas["u"], h0,
                 pid=gas["pid"].astype(np.int32), Z=Z, elem_frac=ef)
    eng.load_dm(dm["pos"], dm["m"], dm["v"], pid=dm["pid"].astype(np.int32))
    eng.load_stars(st["pos"], st["m"], st["v"],
                   pid=st["pid"].astype(np.int32))
    return eng


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def per_pid(state, grid, gpos):
    out = {}
    for name, sp in state.items():
        s = {k: _np(v) for k, v in sp.items()}
        mask = s["mask"] > 0
        order = np.argsort(s["pid"][mask])
        row = {"pos": gpos(grid, s["off"])[mask][order]}
        for k in FIELDS:
            if k in s:
                row[k] = s[k][mask][order]
        out[name] = row
    return out


def assert_same(a, b, when):
    assert a.keys() == b.keys() == {"gas", "dm", "stars"}
    for name in a:
        x, y = a[name], b[name]
        assert np.array_equal(x["pid"], y["pid"]), (when, name)
        d = np.abs(x["pos"] - y["pos"])
        d = np.minimum(d, BOX - d)
        assert d.max() <= 1e-5 * BOX, (when, name, d.max())
        assert np.array_equal(x["time_bin"], y["time_bin"]), (when, name)
        for k, tol in (("v_full", 1e-4), ("u_full", 1e-4), ("Z", 1e-5),
                       ("elem_frac", 1e-5), ("m", 1e-5)):
            if k in x:
                err = np.abs(x[k] - y[k]).max() / max(np.abs(x[k]).max(),
                                                      1e-30)
                assert err <= tol, (when, name, k, err)
        for k, tol in (("rho", 1e-4), ("h", 1e-5)):
            if k in x:
                err = (np.abs(x[k] - y[k]) / np.abs(x[k])).max()
                assert err <= tol, (when, name, k, err)


def _age_stars(eng, where, f32, i32, bin_):
    """The loaded stars: born at a = 0.05 (older than the SNII delay) and
    in time bin ``bin_`` (active in the next step)."""
    st = eng.state["stars"]
    live = st["mask"] > 0
    st["birth_time"] = where(live, f32(0.05), f32(0.0))
    st["time_bin"] = where(live, i32(bin_), i32(0))


def test_eagle_volume_matches_reference_per_pid():
    ic = eagle_volume_ic(n=N_SIDE, L=BOX, z=9.0)
    run_yml = _run_yml()
    ref = _ref_engine(ic, run_yml)
    saved = ev.RUN_YML
    ev.RUN_YML = run_yml
    try:
        port, _, _ = ev.make_engine(device=CPU, ic=ic)
    finally:
        ev.RUN_YML = saved
    assert port.grid.cdim == ref.grid.cdim == (3, 3, 1)
    assert port.grid.K == ref.grid.K == 256
    ref.init_particles()
    port.init_particles()
    assert_same(per_pid(ref.state, ref.grid, ref_gpos),
                per_pid(port.state, port.grid, global_positions), "init")
    gas = port.state["gas"]
    bin_ = int(gas["time_bin"][gas["mask"] > 0].min())
    _age_stars(ref, jnp.where, jnp.float32, jnp.int32, bin_)
    _age_stars(port, torch.where, lambda x: x,
               lambda x: torch.tensor(x, dtype=torch.int32), bin_)
    totals = {"n_heated": 0, "n_converted": 0}
    for step in range(STEPS):
        stars_before = {n: set(_np(e.state["stars"]["pid"])[
            _np(e.state["stars"]["mask"]) > 0]) for n, e in
            (("ref", ref), ("port", port))}
        d_ref, d_port = ref.step(), port.step()
        for k in ("n_heated", "n_converted", "n_woken"):
            assert int(d_ref[k]) == int(d_port[k]), (step, k)
        for k in totals:
            totals[k] += int(d_port[k])
        # the ejecta are differences of cumulative-table interpolations
        # at the dying masses, which amplify the rounding of pow, log10
        # and exp (test_torch_eagle_subgrid.py: 1e-5 of max)
        m_r, m_p = float(d_ref["m_enriched"]), float(d_port["m_enriched"])
        assert abs(m_r - m_p) <= 1e-4 * max(m_r, 1e-30), step
        a = per_pid(ref.state, ref.grid, ref_gpos)
        b = per_pid(port.state, port.grid, global_positions)
        assert_same(a, b, f"step {step}")
        # the same gas became stars
        new = {n: set(x["stars"]["pid"]) - stars_before[n]
               for n, x in (("ref", a), ("port", b))}
        assert new["ref"] == new["port"], step
        assert int(d_port["n_lost"]) == 0
        # the port's columns: the gas front-packed, the stars z-sorted
        g, st = port.state["gas"], port.state["stars"]
        assert torch.equal(torch.sort(g["mask"] > 0, dim=1,
                                      descending=True, stable=True)[0],
                           g["mask"] > 0)
        z = torch.where(st["mask"] > 0, st["off"][..., 2], float("inf"))
        assert bool((z[:, 1:] >= z[:, :-1]).all())
    assert ref.timeline.ti_current == port.timeline.ti_current
    assert totals["n_heated"] > 0 and totals["n_converted"] > 0
    assert float(port.state["gas"]["Z"].max()) > 0.006


def test_multi_state_from_reference_carries_stars():
    """A reference gas + DM + stars state (with the stars' birth time,
    birth density, feedback flag, initial mass and chemistry) carried
    across: every species, key, shape and dtype, values bit for bit."""
    ic = eagle_volume_ic(n=4, L=BOX, z=9.0, star_frac=0.1)
    grid = RefGrid.build_columns((BOX,) * 3, 8.0, np.concatenate(
        [ic["gas"]["pos"], ic["dm"]["pos"], ic["stars"]["pos"]]))
    cfg = ref_engine.EngineConfig(backend="flat")
    from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as P
    eng = ref_multi.MultiEngine(grid, P(), cfg, 0.0, 1.0)
    g, d, s = ic["gas"], ic["dm"], ic["stars"]
    n = len(g["pos"])
    eng.load_gas(g["pos"], g["m"], g["v"], g["u"], g["h"],
                 Z=np.full(n, 0.006, np.float32),
                 elem_frac=np.tile(np.float32([0.7, 0.3] + [0.0] * 7),
                                   (n, 1)))
    eng.load_dm(d["pos"], d["m"], d["v"])
    eng.load_stars(s["pos"], s["m"], s["v"], pid=s["pid"].astype(np.int32))
    st = eng.state["stars"]
    st["birth_time"] = jnp.where(st["mask"] > 0, jnp.float32(0.05), 0.0)
    ref = {name: {k: _np(v) for k, v in sp.items()}
           for name, sp in eng.state.items()}
    port = multi_state_from_reference(ref, CPU)
    assert port.keys() == {"gas", "dm", "stars"}
    for k in ("birth_time", "birth_density", "fb_done", "m_init", "Z",
              "elem_frac"):
        assert k in port["stars"], k
    for name in ref:
        assert port[name].keys() == ref[name].keys()
        for k, v in ref[name].items():
            b = port[name][k].numpy()
            assert v.dtype == b.dtype and v.shape == b.shape, (name, k)
            assert np.array_equal(v, b), (name, k)
    assert port["stars"]["elem_frac"].shape[-1] == 9


def test_eagle_volume_ic_matches_make_ics(tmp_path):
    """The port's in-memory ICs against the reference's make_ics.py file
    (without its seed black hole)."""
    h5py = pytest.importorskip("h5py")
    ex = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                      "eagle_volume", "make_ics.py")
    out = tmp_path / "ic.hdf5"
    r = subprocess.run([sys.executable, ex, "--n", "8", "--L", "25", "--z",
                        "9", "-o", str(out)], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr
    ic = eagle_volume_ic(n=8, L=25.0, z=9.0)
    with h5py.File(out) as f:
        for pt, name in (("PartType0", "gas"), ("PartType1", "dm"),
                         ("PartType4", "stars")):
            g = f[pt]
            assert np.array_equal(np.asarray(g["ParticleIDs"]),
                                  ic[name]["pid"]), name
            assert np.allclose(np.asarray(g["Coordinates"], np.float64),
                               ic[name]["pos"], rtol=0, atol=1e-5), name
            assert np.array_equal(np.asarray(g["Masses"], np.float32),
                                  ic[name]["m"]), name
            assert np.array_equal(np.asarray(g["Velocities"], np.float32),
                                  ic[name]["v"]), name
    assert len(ic["stars"]["pid"]) == 10 and len(ic["gas"]["pid"]) == 502


def test_eagle_example_runs_on_the_cpu(capsys):
    assert ev.main(["--cpu", "--n", "8", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "1024 particles" in out and "'n_stars': 10" in out


def test_multi_engine_refuses_black_holes_and_others():
    grid = CellGrid((1.0, 1.0, 1.0), (3, 3, 1), 128)
    cfg = port_engine.EngineConfig()
    for kw in ("bh_model", "sink_model", "nu_model", "tracers", "rt_fn",
               "external_potential"):
        with pytest.raises(NotImplementedError,
                           match=f"{kw}.*queue 1 item 9"):
            port_multi.MultiEngine(grid, SPHENIXParams(), cfg, 0.0, 1.0,
                                   device=CPU, **{kw: object()})
    for kw in ("star_formation", "feedback", "enrichment"):
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            port_multi.MultiEngine(grid, SPHENIXParams(), cfg, 0.0, 1.0,
                                   device=CPU, **{kw: object()})

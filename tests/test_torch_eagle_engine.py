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
from swift_subtask_dev_tpu.ops import black_holes as ref_bh_ops
from swift_subtask_dev_tpu.subgrid.chemistry import (
    EagleChemistry as RefChemistry)
from swift_subtask_dev_tpu.subgrid.spin_jet import (
    SpinJetBlackHoles as RefSpinJet)
from swift_subtask_dev_tpu.subgrid.star_formation import (
    EagleStarFormation as RefSF)
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
from swift_subtask_dev_tpu_torch.subgrid.black_holes import (
    DefaultBlackHoles, EagleBlackHoles)
from test_torch_black_holes import (Z_IMAGES, apply_plan, craft_port,
                                    crafted_ic)

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
          "elem_frac", "m_subgrid", "energy_reservoir")


def _run_yml():
    """run.yml with star formation made easy (see the module docstring)."""
    ry = copy.deepcopy(ev.RUN_YML)
    ry["EAGLEStarFormation"].update(
        threshold_norm_H_p_cm3=1e-6, threshold_over_density=0.1,
        EOS_entropy_margin_dex=3.0, KS_normalisation=1e-3)
    ry["EAGLEEntropyFloor"]["Cool_over_density_threshold"] = 0.1
    return ry


def _ref_engine(ic, run_yml, black_holes=False):
    """The reference's run, built as its CLI's multi path builds
    ``--eagle`` (cli.py:739-960 with build_subgrid), with
    ``black_holes`` ``--eagle --black-holes`` and the ICs' BHs loaded as
    the CLI loads them (cli.py:962-974)."""
    params = RefParams(copy.deepcopy(run_yml))
    units = ref_units.COSMO_UNITS
    pc = units.constants()
    cosmology = ref_cosmology.make_cosmology_from_params(params, pc)
    sph, _ = ref_cli.build_sph_params(params)

    class Args:
        cooling = star_formation = feedback = True
        sinks = False
    Args.black_holes = black_holes
    (cooling_fn, sf, floor, fb, bh_model, _, enr) = ref_cli.build_subgrid(
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
        feedback=fb, enrichment=enr, bh_model=bh_model,
        mesh_fn=solver.mesh_accelerations, mesh_dt_scale=solver.pm.r_s)
    Z, ef = RefChemistry.from_params(params).particle_arrays(len(gas["pos"]))
    eng.load_gas(gas["pos"], gas["m"], gas["v"], gas["u"], h0,
                 pid=gas["pid"].astype(np.int32), Z=Z, elem_frac=ef)
    eng.load_dm(dm["pos"], dm["m"], dm["v"], pid=dm["pid"].astype(np.int32))
    eng.load_stars(st["pos"], st["m"], st["v"],
                   pid=st["pid"].astype(np.int32))
    if black_holes:
        bh = ic["bh"]
        eng.load_bh(bh["pos"], bh["m"], bh["v"],
                    h=np.full(len(bh["pos"]), float(np.median(h0)),
                              np.float32),
                    pid=bh["pid"].astype(np.int32), m_subgrid=bh["m"])
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


def assert_same(a, b, when, species=("gas", "dm", "stars")):
    assert a.keys() == b.keys() == set(species)
    for name in a:
        x, y = a[name], b[name]
        assert np.array_equal(x["pid"], y["pid"]), (when, name)
        d = np.abs(x["pos"] - y["pos"])
        d = np.minimum(d, BOX - d)
        assert d.max() <= 1e-5 * BOX, (when, name, d.max())
        assert np.array_equal(x["time_bin"], y["time_bin"]), (when, name)
        for k, tol in (("v_full", 1e-5 if name == "bh" else 1e-4),
                       ("u_full", 1e-4), ("Z", 1e-5), ("elem_frac", 1e-5),
                       ("m", 1e-5), ("m_subgrid", 1e-5),
                       ("energy_reservoir", 1e-5)):
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


def _one_count_per_pair(monkeypatch):
    """The reference with its two documented hazards (ROADMAP.md, queue 3)
    corrected for the comparison: its two collect loops' sums divided by
    the z-images the column grid's stencil walks (so each swallowed gas
    particle and each merged BH counts once), and star formation limited
    to the gas still live (not swallowed this step)."""
    for name in ("bh_swallow_collect_loop", "bh_merger_collect_loop"):
        orig = getattr(ref_bh_ops, name)

        def once(*a, _orig=orig, **kw):
            return {k: v / Z_IMAGES for k, v in _orig(*a, **kw).items()}
        monkeypatch.setattr(ref_bh_ops, name, once)
    orig_cm = RefSF.conversion_mask

    def live_only(self, s, cosmo, dt, ti_lo, ti_hi, floor, active):
        return orig_cm(self, s, cosmo, dt, ti_lo, ti_hi, floor,
                       active & (s["mask"] > 0))
    monkeypatch.setattr(RefSF, "conversion_mask", live_only)


def _live_pids(eng, name):
    sp = eng.state[name]
    return set(_np(sp["pid"])[_np(sp["mask"]) > 0])


def _total_mass(eng):
    return sum(float((sp["m"] * sp["mask"]).double().sum())
               for sp in eng.state.values())


def test_eagle_volume_with_black_holes_matches_reference_per_pid(
        monkeypatch):
    """``--eagle --black-holes`` on the crafted volume with seven BHs
    (``test_torch_black_holes.crafted_ic``: the seed, two that
    reposition, a bound and an unbound pair), after init given subgrid
    masses above their masses, reservoirs above the AGN threshold and the
    gas's smallest bin, the stars aged and star formation made easy as
    above; init and 3 steps per pid (the BHs' m, m_subgrid,
    energy_reservoir and v_full within 1e-5 of max), the same swallowed
    and converted pids and equal AGN and merger counts per step, and the
    port's total mass conserved (1e-6)."""
    _one_count_per_pair(monkeypatch)
    ic, m_sub = crafted_ic(N_SIDE)
    run_yml = _run_yml()
    ref = _ref_engine(ic, run_yml, black_holes=True)
    saved = ev.RUN_YML
    ev.RUN_YML = run_yml
    try:
        port, _, _ = ev.make_engine(device=CPU, ic=ic, black_holes=True)
    finally:
        ev.RUN_YML = saved
    assert port.grid.cdim == ref.grid.cdim == (3, 3, 1)
    species = ("gas", "dm", "stars", "bh")
    ref.init_particles()
    port.init_particles()
    assert_same(per_pid(ref.state, ref.grid, ref_gpos),
                per_pid(port.state, port.grid, global_positions), "init",
                species)
    plan, bin_ = craft_port(port, m_sub, with_reservoir=True)
    rb = {k: np.asarray(v) for k, v in ref.state["bh"].items()}
    ref.state["bh"] = {**ref.state["bh"], **{
        k: jnp.asarray(v) for k, v in apply_plan(rb, plan).items()}}
    _age_stars(ref, jnp.where, jnp.float32, jnp.int32, bin_)
    _age_stars(port, torch.where, lambda x: x,
               lambda x: torch.tensor(x, dtype=torch.int32), bin_)
    m0 = _total_mass(port)
    keys = ("n_swallowed", "n_agn", "n_bh_merged", "n_converted",
            "n_heated")
    totals = dict.fromkeys(keys, 0)
    for step in range(STEPS):
        before = {n: (_live_pids(e, "gas"), _live_pids(e, "stars"))
                  for n, e in (("ref", ref), ("port", port))}
        d_ref, d_port = ref.step(), port.step()
        for k in keys + ("n_woken",):
            assert int(d_ref[k]) == int(d_port[k]), (step, k)
        for k in keys:
            totals[k] += int(d_port[k])
        changed = {}
        for n, e in (("ref", ref), ("port", port)):
            gas0, stars0 = before[n]
            new = _live_pids(e, "stars") - stars0
            changed[n] = (new, gas0 - _live_pids(e, "gas") - new)
        assert changed["ref"] == changed["port"], step
        assert len(changed["port"][1]) == int(d_port["n_swallowed"])
        assert_same(per_pid(ref.state, ref.grid, ref_gpos),
                    per_pid(port.state, port.grid, global_positions),
                    f"step {step}", species)
        assert abs(_total_mass(port) - m0) <= 1e-6 * m0, step
        # the port's columns: the gas front-packed, the stars and BHs
        # z-sorted
        g = port.state["gas"]
        assert torch.equal(torch.sort(g["mask"] > 0, dim=1,
                                      descending=True, stable=True)[0],
                           g["mask"] > 0)
        for name in ("stars", "bh"):
            sp = port.state[name]
            z = torch.where(sp["mask"] > 0, sp["off"][..., 2],
                            float("inf"))
            assert bool((z[:, 1:] >= z[:, :-1]).all()), (step, name)
    assert ref.timeline.ti_current == port.timeline.ti_current
    assert all(totals[k] > 0 for k in keys), totals
    assert totals["n_bh_merged"] == 1


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
    """The port's in-memory ICs against the reference's make_ics.py file;
    with ``black_hole`` its seed black hole too."""
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
    ic_bh = eagle_volume_ic(n=8, L=25.0, z=9.0, black_hole=True)
    for name in ("gas", "dm", "stars"):
        for k, v in ic[name].items():
            assert np.array_equal(ic_bh[name][k], v), (name, k)
    with h5py.File(out) as f:
        g = f["PartType5"]
        bh = ic_bh["bh"]
        assert np.array_equal(np.asarray(g["ParticleIDs"]), bh["pid"])
        assert np.array_equal(np.asarray(g["Coordinates"]), bh["pos"])
        assert np.array_equal(np.asarray(g["Masses"]), bh["m"])
        assert np.array_equal(np.asarray(g["Velocities"]), bh["v"])


def test_eagle_example_runs_on_the_cpu(capsys):
    assert ev.main(["--cpu", "--n", "8", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "1024 particles" in out and "'n_stars': 10" in out


def test_eagle_example_with_black_holes_runs_on_the_cpu(capsys):
    """``--black-holes``: the seed black hole loaded beside the volume."""
    assert ev.main(["--cpu", "--n", "8", "--steps", "2",
                    "--black-holes"]) == 0
    out = capsys.readouterr().out
    assert "1025 particles" in out and "'n_bh': 1" in out
    assert "'n_swallowed': 0" in out


def test_multi_state_from_reference_carries_black_holes():
    """A reference state with its BHs (subgrid mass, reservoir, swallow
    probability, accretion rate, gas density, neighbour mass) carried
    across: every key, shape and dtype, values bit for bit."""
    ic = eagle_volume_ic(n=4, L=BOX, z=9.0, star_frac=0.1, black_hole=True)
    grid = RefGrid.build_columns((BOX,) * 3, 8.0, np.concatenate(
        [ic["gas"]["pos"], ic["dm"]["pos"], ic["stars"]["pos"]]))
    from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as P
    eng = ref_multi.MultiEngine(grid, P(), ref_engine.EngineConfig(
        backend="flat"), 0.0, 1.0)
    g, d, bh_ic = ic["gas"], ic["dm"], ic["bh"]
    eng.load_gas(g["pos"], g["m"], g["v"], g["u"], g["h"])
    eng.load_dm(d["pos"], d["m"], d["v"])
    eng.load_bh(bh_ic["pos"], bh_ic["m"], bh_ic["v"],
                pid=bh_ic["pid"].astype(np.int32), m_subgrid=bh_ic["m"] * 2)
    bh = eng.state["bh"]
    bh["energy_reservoir"] = jnp.where(bh["mask"] > 0, 3.5, 0.0)
    ref = {name: {k: _np(v) for k, v in sp.items()}
           for name, sp in eng.state.items()}
    port = multi_state_from_reference(ref, CPU)
    assert port.keys() == {"gas", "dm", "bh"}
    for k in ("m_subgrid", "energy_reservoir", "swallow_prob", "mdot",
              "rho_gas", "ngb_mass", "drift_accum"):
        assert k in port["bh"], k
    for name in ref:
        assert port[name].keys() == ref[name].keys()
        for k, v in ref[name].items():
            b = port[name][k].numpy()
            assert v.dtype == b.dtype and v.shape == b.shape, (name, k)
            assert np.array_equal(v, b), (name, k)
    # the port's own loader gives the same fields
    eng_p = port_multi.MultiEngine(CellGrid.build_columns(
        (BOX,) * 3, 8.0, np.concatenate([ic["gas"]["pos"],
                                         ic["dm"]["pos"]])),
        SPHENIXParams(), port_engine.EngineConfig(backend="flat"), 0.0, 1.0,
        device=CPU)
    eng_p.load_bh(bh_ic["pos"], bh_ic["m"], bh_ic["v"],
                  pid=bh_ic["pid"].astype(np.int32))
    assert eng_p.state["bh"].keys() == port["bh"].keys()


def test_multi_engine_refuses_black_holes_and_others():
    """The models the port does not run are refused by name; of the black
    holes, the spin-jet model (and anything but the EAGLE and Default
    models)."""
    grid = CellGrid((1.0, 1.0, 1.0), (3, 3, 1), 128)
    cfg = port_engine.EngineConfig()
    for kw in ("sink_model", "nu_model", "tracers", "rt_fn",
               "external_potential"):
        with pytest.raises(NotImplementedError,
                           match=f"{kw}.*queue 1 item 9"):
            port_multi.MultiEngine(grid, SPHENIXParams(), cfg, 0.0, 1.0,
                                   device=CPU, **{kw: object()})
    for kw in ("star_formation", "feedback", "enrichment", "bh_model"):
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            port_multi.MultiEngine(grid, SPHENIXParams(), cfg, 0.0, 1.0,
                                   device=CPU, **{kw: object()})
    with pytest.raises(NotImplementedError,
                       match="bh_model SpinJetBlackHoles.*queue 1 item 9"):
        port_multi.MultiEngine(grid, SPHENIXParams(), cfg, 0.0, 1.0,
                               device=CPU, bh_model=RefSpinJet())
    for model in (EagleBlackHoles(), DefaultBlackHoles()):
        eng = port_multi.MultiEngine(grid, SPHENIXParams(), cfg, 0.0, 1.0,
                                     device=CPU, bh_model=model)
        assert eng.bh_model is model

"""Port vs reference: the EAGLE black holes.

* The seven BH loops of ``ops/black_holes.py`` on one state, the same
  tiles in both packages: the port's EAGLE volume (2 x 8^3 sites in 25
  Mpc, z = 9) after ``init_particles()`` with seven BHs (the seed at the
  box centre; two beside gas particles, at their velocity, so that they
  reposition; a bound pair 0.05 Mpc apart at one velocity and an
  unbound pair, both far from any gas particle and fast against it), the
  BHs given subgrid masses above their masses and swallow
  probabilities.  Sums within 1e-5 of max; swallow and merger ids, the
  reposition's found-mask and the consumed flags exact; displacements
  within 1e-6 of max.  The reference's two collect loops count each pair
  once per z-image of the column grid (three: the stencil's dz = -1, 0,
  1 cells are one column and the collect test has no distance); the port
  counts it once, so their sums are held to a third of the reference's
  (ROADMAP.md, queue 3).
* ``EagleBlackHoles.from_params`` on run.yml's EAGLEAGN section,
  ``bondi_rate``, ``accrete`` and ``agn_fire`` (1e-6 relative),
  ``DefaultBlackHoles`` and ``seed_from_fof``.
* The swallow-then-star-formation hazard: the reference's star formation
  converts a gas particle that a BH swallowed in the same step (its
  ``active`` predates the swallow), so that particle's mass is counted
  twice; the port's step converts none of them and conserves mass.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift_subtask_dev_tpu import engine_multi as ref_multi
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.models.sph.sphenix import (
    SPHENIXParams as RefSPH)
from swift_subtask_dev_tpu.ops import black_holes as ref_ops
from swift_subtask_dev_tpu.subgrid import black_holes as ref_bh
from swift_subtask_dev_tpu.subgrid.star_formation import (
    EagleStarFormation as RefSF)
from swift_subtask_dev_tpu.utils import units as ref_units
from swift_subtask_dev_tpu.utils.params import Params as RefParams
from swift_subtask_dev_tpu_torch import engine_multi as port_multi
from swift_subtask_dev_tpu_torch.examples import eagle_volume as ev
from swift_subtask_dev_tpu_torch.grid.cellgrid import global_positions
from swift_subtask_dev_tpu_torch.ics import eagle_volume_ic
from swift_subtask_dev_tpu_torch.ops import black_holes as port_ops
from swift_subtask_dev_tpu_torch.subgrid import black_holes as port_bh
from swift_subtask_dev_tpu_torch.utils.params import Params
from swift_subtask_dev_tpu_torch.utils.units import COSMO_UNITS

CPU = torch.device("cpu")
BOX = 25.0
# the z-images a column-grid stencil walks of one cell (dz = -1, 0, 1)
Z_IMAGES = 3
# the bound pair's members, counted from the seed's pid
BOUND = (3, 4)
# a step's tick, as the reference's step tables carry it
TI_REF = (jnp.int32(123), jnp.int32(456))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """torch on two threads (several test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def crafted_ic(n=8):
    """The EAGLE volume's ICs with its seed black hole and six more: two
    0.05 Mpc beside gas particles at their velocity (they reposition), a
    pair 0.05 Mpc apart at one velocity (bound: it merges) and a pair
    3,000 km/s apart (unbound), the pairs at least 0.5 Mpc from any gas
    particle and 500 km/s faster than the gas (they do not reposition).
    Dynamical masses the stars' mean; subgrid masses returned apart."""
    ic = eagle_volume_ic(n=n, L=BOX, z=9.0, black_hole=True)
    gas, bh = ic["gas"], ic["bh"]
    rng = np.random.default_rng(11)
    sites = rng.choice(len(gas["pos"]), 2, replace=False)
    pos = [gas["pos"][k] + [0.05, 0.0, 0.0] for k in sites]
    vel = [gas["v"][k] for k in sites]
    v_gas = np.abs(gas["v"]).max()
    for dv in (0.0, 3000.0):
        # a point far from the gas: the farthest of a few random draws
        cand = rng.uniform(0, BOX, (64, 3))
        d = np.abs(cand[:, None, :] - gas["pos"][None, :, :])
        d = np.minimum(d, BOX - d)
        far = cand[np.argmax(np.sqrt((d * d).sum(-1)).min(1))]
        v0 = np.float32([v_gas + 500.0, 0.0, 0.0])
        pos += [far, far + [0.05, 0.0, 0.0]]
        vel += [v0, v0 + np.float32([dv, 0.0, 0.0])]
    m0 = bh["m"][0]
    ic["bh"] = {
        "pos": np.mod(np.concatenate([bh["pos"], np.asarray(pos)]), BOX),
        "v": np.concatenate([bh["v"], np.asarray(vel, np.float32)]),
        "m": np.full(7, m0, np.float32),
        "pid": bh["pid"][0] + np.arange(7, dtype=np.int64)}
    # heavier subgrid masses, each BH's its own (the pairs' members
    # differ): about 1-3 gas masses of deficit
    m_sub = m0 * np.float32([1.0, 2.0, 3.0, 2.5, 2.0, 3.0, 4.0])
    return ic, m_sub


def bh_plan(eng, m_sub, with_reservoir=False):
    """The BHs' crafted fields after init, by pid (ascending), from the
    port's engine: the subgrid masses ``m_sub``, the velocity of the gas
    particle a BH sits beside (within 0.1 Mpc; the init's kicks differ),
    the bound pair's lighter member at its partner's velocity, the gas's
    smallest time bin (active in the next step) and, with
    ``with_reservoir``, reservoirs 1.5 x the AGN threshold of their
    neighbour mass at init.  Returns the plan (arrays by pid) and the
    bin."""
    bh, gas = _np_state(eng.state["bh"]), _np_state(eng.state["gas"])
    live, glive = bh["mask"] > 0, gas["mask"] > 0
    order = np.argsort(bh["pid"][live])
    gpos = lambda s: global_positions(eng.grid, s["off"])   # noqa: E731
    G, B = gpos(gas)[glive], gpos(bh)[live][order]
    v = bh["v_full"][live][order]
    for i in range(len(B)):
        d = np.abs(G - B[i])
        d = np.minimum(d, BOX - d)
        r = np.sqrt((d * d).sum(1))
        if r.min() < 0.1:
            v[i] = gas["v_full"][glive][r.argmin()]
    v[BOUND[1]] = v[BOUND[0]]
    bin_ = int(gas["time_bin"][glive].min())
    plan = {"pid": bh["pid"][live][order], "m_subgrid": m_sub,
            "v_full": v, "time_bin": np.full(len(B), bin_, np.int32)}
    if with_reservoir:
        dens = port_ops.bh_gas_density_loop(eng.grid, eng.state["bh"],
                                            eng.state["gas"], eng.sph)
        ngb = _np(dens["ngb_mass"])[live][order]
        m = eng.bh_model
        plan["energy_reservoir"] = (1.5 * m.n_heat * m.delta_u * ngb
                                    / 48.0).astype(np.float32)
    return plan, bin_


def apply_plan(bh, plan):
    """The planned fields on a numpy BH tile state: new arrays."""
    live = bh["mask"] > 0
    idx = np.searchsorted(plan["pid"], bh["pid"][live])
    out = {}
    for k, vals in plan.items():
        if k == "pid":
            continue
        a = np.zeros_like(bh[k]) if k == "time_bin" else bh[k].copy()
        a[live] = vals[idx]
        out[k] = a
    return out


def _np_state(s):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in s.items()}


def craft_port(eng, m_sub, with_reservoir=False):
    plan, bin_ = bh_plan(eng, m_sub, with_reservoir)
    new = apply_plan(_np_state(eng.state["bh"]), plan)
    eng.state["bh"] = {**eng.state["bh"],
                       **{k: torch.as_tensor(v) for k, v in new.items()}}
    return plan, bin_


@pytest.fixture(scope="module")
def state():
    """The port's crafted volume after init: (engine, gas, bh, the
    reference's grid and SPH parameters)."""
    ic, m_sub = crafted_ic()
    eng, _, _ = ev.make_engine(device=CPU, ic=ic, black_holes=True)
    eng.init_particles()
    craft_port(eng, m_sub)
    gas, bh = eng.state["gas"], eng.state["bh"]
    dens = port_ops.bh_gas_density_loop(eng.grid, bh, gas, eng.sph)
    rho = torch.clamp_min(dens["rho"], 1e-30)
    bh = {**bh, "swallow_prob": torch.where(bh["mask"] > 0, 0.3, 0.0),
          "cs_gas": dens["cs_w"] / rho * eng.cosmo.a_factor_sound_speed}
    grid = RefGrid(box=eng.grid.box, cdim=eng.grid.cdim, K=eng.grid.K)
    P = RefSPH(eta_neighbours=eng.sph.eta_neighbours)
    return eng, gas, bh, grid, P


def _ref(s):
    return {k: jnp.asarray(v.numpy()) for k, v in s.items()}


def _np(v):
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


def _close(a, b, tol):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, err


def test_crafted_state_exercises_every_loop(state):
    eng, gas, bh, _, _ = state
    assert int((bh["mask"] > 0).sum()) == 7 and eng.grid.cdim[2] == 1
    # the seed: the box centre, the stars' mean mass, the largest star
    # id + 1
    st = eng.state["stars"]
    seed = bh["pid"] == int(st["pid"][st["mask"] > 0].max()) + 1
    assert int(seed.sum()) == 1


def test_density_loop_matches_reference(state):
    eng, gas, bh, grid, P = state
    ref = ref_ops.bh_gas_density_loop(grid, _ref(bh), _ref(gas), P)
    port = port_ops.bh_gas_density_loop(eng.grid, bh, gas, eng.sph)
    assert ref.keys() == port.keys()
    for k in ref:
        _close(port[k], ref[k], 1e-5)
    assert float(port["ngb_mass"].max()) > 0


def test_swallow_target_and_collect_match_reference(state):
    eng, gas, bh, grid, P = state
    bid_r = ref_ops.bh_swallow_target_loop(grid, _ref(gas), _ref(bh), P,
                                           *TI_REF)
    bid_p = port_ops.bh_swallow_target_loop(eng.grid, gas, bh, eng.sph,
                                            123, 456)
    assert np.array_equal(_np(bid_r), _np(bid_p))
    n_sw = int((bid_p >= 0).sum())
    assert n_sw >= 5 and len(np.unique(_np(bid_p)[_np(bid_p) >= 0])) >= 3
    g_r = ref_ops.bh_swallow_collect_loop(grid, _ref(bh), _ref(gas), P,
                                          bid_r)
    g_p = port_ops.bh_swallow_collect_loop(eng.grid, bh, gas, bid_p)
    assert g_r.keys() == g_p.keys()
    # the reference's sums count each swallowed particle once per z-image
    for k in g_r:
        _close(g_p[k], _np(g_r[k]) / Z_IMAGES, 1e-5)
    m_gas = float((gas["m"] * (bid_p >= 0)).double().sum())
    assert abs(float(g_p["dm"].double().sum()) - m_gas) <= 1e-6 * m_gas


def test_reposition_loop_matches_reference(state):
    eng, gas, bh, grid, P = state
    model = eng.bh_model
    kw = dict(max_dist=model.reposition_ratio * eng.cfg.eps_soft,
              v2_max_fac=model.repos_vel_ratio,
              v2_min_thresh=model.repos_vel_min)
    f_r, d_r = ref_ops.bh_reposition_loop(grid, _ref(bh), _ref(gas), P,
                                          **kw)
    f_p, d_p = port_ops.bh_reposition_loop(eng.grid, bh, gas, eng.sph, **kw)
    assert np.array_equal(_np(f_r), _np(f_p))
    assert int(f_p.sum()) == 2, "the two BHs beside gas particles"
    _close(d_p, d_r, 1e-6)
    jump = torch.sqrt((d_p.double() ** 2).sum(-1))
    assert float(jump.max()) <= kw["max_dist"]
    # without the velocity gate the pairs find no gas either (too far)
    f2, _ = port_ops.bh_reposition_loop(eng.grid, bh, gas, eng.sph,
                                        max_dist=kw["max_dist"])
    assert torch.equal(f2, f_p)


def _merger(state, G, threshold):
    eng, gas, bh, grid, P = state
    md = eng.bh_model.merging_ratio * eng.cfg.eps_soft
    vic_r = ref_ops.bh_merger_mark_loop(grid, _ref(bh), P, max_dist=md,
                                        G=G, threshold=threshold)
    vic_p = port_ops.bh_merger_mark_loop(eng.grid, bh, eng.sph,
                                         max_dist=md, G=G,
                                         threshold=threshold)
    assert np.array_equal(_np(vic_r), _np(vic_p))
    return vic_r, vic_p


@pytest.mark.parametrize("threshold", ["escape_velocity",
                                       "circular_velocity",
                                       "dynamical_escape_velocity"])
def test_merger_loops_match_reference(state, threshold):
    eng, gas, bh, grid, P = state
    vic_r, vic_p = _merger(state, eng.bh_model.G, threshold)
    live = _np(bh["mask"]) > 0
    seed = _np(bh["pid"])[live].min()
    # the bound pair: its lighter member (by subgrid mass) marks the
    # heavier; the unbound pair marks nothing
    marked = {int(a): int(b) for a, b in zip(_np(bh["pid"])[live],
                                             _np(vic_p)[live]) if b >= 0}
    assert marked == {seed + BOUND[1]: seed + BOUND[0]}
    not_r, not_p = vic_r < 0, vic_p < 0
    mg_r = ref_ops.bh_merger_collect_loop(grid, _ref(bh), vic_r, not_r)
    mg_p = port_ops.bh_merger_collect_loop(eng.grid, bh, vic_p, not_p)
    assert mg_r.keys() == mg_p.keys()
    for k in mg_r:
        _close(mg_p[k], _np(mg_r[k]) / Z_IMAGES, 1e-5)
    assert float(mg_p["n"].sum()) == 1.0
    c_r = ref_ops.bh_merger_consumed_loop(grid, _ref(bh), vic_r, not_r)
    c_p = port_ops.bh_merger_consumed_loop(eng.grid, bh, vic_p, not_p)
    assert np.array_equal(_np(c_r), _np(c_p)) and int(c_p.sum()) == 1


def test_merger_chain_defers(state):
    """A victim whose swallower is itself a victim waits a step."""
    eng, gas, bh, grid, P = state
    live = bh["mask"] > 0
    pid = bh["pid"]
    order = torch.argsort(torch.where(live, pid, 1 << 30).reshape(-1))
    flat = pid.reshape(-1)
    a, b, c = (int(flat[order[k]]) for k in range(3))
    # a chain: a -> b -> c
    vic = torch.full_like(pid, -1)
    vic = torch.where(pid == a, b, vic)
    vic = torch.where(pid == b, c, vic)
    vic = torch.where(live, vic, -1)
    c_p = port_ops.bh_merger_consumed_loop(eng.grid, bh, vic, vic < 0)
    c_r = ref_ops.bh_merger_consumed_loop(grid, _ref(bh),
                                          jnp.asarray(vic.numpy()),
                                          jnp.asarray((vic < 0).numpy()))
    assert np.array_equal(_np(c_r), _np(c_p))
    # b (swallowed by c, not a victim's swallower) completes; a defers
    done = set(_np(pid)[_np(c_p)])
    assert done == {b}


RUN_YML_AGN = {"EAGLEAGN": dict(ev.RUN_YML["EAGLEAGN"])}


def _models(section=None):
    data = copy.deepcopy(RUN_YML_AGN)
    if section:
        data["EAGLEAGN"].update(section)
    pc_r = ref_units.COSMO_UNITS.constants()
    pc_p = COSMO_UNITS.constants()
    ref = ref_bh.EagleBlackHoles.from_params(
        RefParams(copy.deepcopy(data)), ref_units.COSMO_UNITS, pc_r,
        pc_r.const_newton_G)
    port = port_bh.EagleBlackHoles.from_params(
        Params(data), COSMO_UNITS, pc_p, pc_p.const_newton_G)
    return ref, port


@pytest.mark.parametrize("section", [
    None, {"with_reposition_velocity_threshold": 0,
           "min_reposition_velocity_threshold_km_p_s": 10.0,
           "merger_threshold_type": "Circular_Velocity",
           "max_merging_distance_ratio": 0.0}])
def test_from_params_matches_reference(section):
    ref, port = _models(section)
    for f in ref.__dataclass_fields__:
        a, b = getattr(ref, f), getattr(port, f)
        if isinstance(a, str):
            assert a == b, f
        else:
            assert abs(a - b) <= 1e-12 * max(abs(a), 1e-300), f
    assert port.kind == "eagle"
    if section is None:      # run.yml: repositioning and mergers on
        assert port.reposition_ratio == 3.0 and port.merging_ratio == 3.0
        assert port.repos_vel_ratio == 0.5


def test_accretion_and_agn_fire_match_reference(state):
    eng, gas, bh, grid, P = state
    ref_m, port_m = _models()
    dens = port_ops.bh_gas_density_loop(eng.grid, bh, gas, eng.sph)
    # a reservoir on both sides of the threshold
    e_crit = port_m.n_heat * port_m.delta_u * dens["ngb_mass"] / 48.0
    bh = {**bh, "energy_reservoir": e_crit * torch.where(
        bh["pid"] % 2 == 0, 1.01, 0.5).to(torch.float32)}
    dt = torch.where(bh["mask"] > 0, 1e-4, 0.0)
    cosmo = eng.cosmo
    out_p = port_m.accrete(bh, dens, cosmo, dt)
    ref_cosmo = ref_multi.CosmoFactors(*[jnp.float32(x) for x in cosmo])
    out_r = ref_m.accrete(_ref(bh), _ref(dens), ref_cosmo,
                          jnp.asarray(dt.numpy()))
    live = _np(bh["mask"]) > 0
    for k in ("m_subgrid", "energy_reservoir", "swallow_prob", "mdot",
              "rho_gas", "ngb_mass"):
        a, b = _np(out_p[k])[live], _np(out_r[k])[live]
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        assert rel.max() <= 1e-6, (k, rel.max())
    assert float(out_p["mdot"].max()) > 0
    # after the accretion, which sets the neighbour masses
    fed = {**out_p, "energy_reservoir": bh["energy_reservoir"]}
    e_p, r_p = port_m.agn_fire(fed)
    e_r, r_r = ref_m.agn_fire(_ref(fed))
    assert np.array_equal(_np(e_p) > 0, _np(e_r) > 0)
    assert 0 < int((e_p > 0).sum()) < int(live.sum())
    _close(e_p, e_r, 1e-6)
    _close(r_p, r_r, 1e-6)
    args = [torch.linspace(1, 9, 7), torch.linspace(0.1, 5, 7),
            torch.linspace(3, 40, 7), torch.linspace(0, 800, 7)]
    a = port_m.bondi_rate(*args)
    b = ref_m.bondi_rate(*[jnp.asarray(x.numpy()) for x in args])
    assert (np.abs(_np(a) - _np(b)) / _np(b)).max() <= 1e-6


def test_default_black_holes_run_the_density_pass_only(state):
    eng, gas, bh, grid, P = state
    m = port_bh.DefaultBlackHoles.from_params(Params({}), COSMO_UNITS,
                                              COSMO_UNITS.constants(), 1.0)
    assert m.kind == ref_bh.DefaultBlackHoles.kind == "default"
    act = (bh["mask"] > 0) & (bh["pid"] % 2 == 0)
    out = port_multi._bh_density(eng.grid, eng.sph, gas, bh, act)
    dens = ref_ops.bh_gas_density_loop(grid, _ref(bh), _ref(gas), P)
    h = np.where(_np(bh["mask"]) > 0, _np(bh["h"]), 1.0)
    a = _np(act)
    _close(np.where(a, _np(out["rho_gas"]), 0.0),
           np.where(a, _np(dens["rho"]) / h ** 3, 0.0), 1e-5)
    _close(np.where(a, _np(out["ngb_mass"]), 0.0),
           np.where(a, _np(dens["ngb_mass"]), 0.0), 1e-5)
    assert np.array_equal(_np(out["rho_gas"])[~a], _np(bh["rho_gas"])[~a])
    # an engine with passive BHs: no swallow, AGN or merger, masses kept
    ic, m_sub = crafted_ic()
    e2, _, _ = ev.make_engine(device=CPU, ic=ic, black_holes=True)
    e2.bh_model = m
    e2.init_particles()
    craft_port(e2, m_sub)
    m0 = e2.state["bh"]["m"].clone()
    for _ in range(2):
        d = e2.step()
        assert int(d["n_swallowed"]) == int(d["n_agn"]) \
            == int(d["n_bh_merged"]) == 0
    assert torch.equal(e2.state["bh"]["m"].sum(), m0.sum())
    assert float(e2.state["bh"]["ngb_mass"].max()) > 0


def test_seed_from_fof_matches_reference():
    port_m = port_bh.EagleBlackHoles(seed_mass=1e-3, seed_halo_mass=5.0)
    ref_m = ref_bh.EagleBlackHoles(seed_mass=1e-3, seed_halo_mass=5.0)
    cat = {"group_mass": np.array([10.0, 1.0, 7.0]),
           "group_com": np.array([[0.2, 0.2, 0.2], [0.8, 0.8, 0.8],
                                  [0.6, 0.3, 0.7]])}
    rng = np.random.default_rng(0)
    gas_pos = rng.uniform(0, 1, (100, 3))
    gas_rho = rng.uniform(0.5, 2.0, 100)
    gids = rng.integers(-1, 3, 100)
    for kw in ({}, {"gas_group_ids": gids},
               {"existing_bh_pos": np.array([[0.61, 0.3, 0.7]]),
                "min_dist": 0.3}):
        sp, n_p = port_bh.seed_from_fof(cat, gas_pos, gas_rho, port_m, **kw)
        sr, n_r = ref_bh.seed_from_fof(cat, gas_pos, gas_rho, ref_m, **kw)
        assert n_p == n_r and np.array_equal(sp, sr)
    seeds, n = port_bh.seed_from_fof(cat, gas_pos, gas_rho, port_m)
    assert n == 2 and seeds.shape == (2, 3)
    _, n2 = port_bh.seed_from_fof(cat, gas_pos, gas_rho, port_m,
                                  existing_bh_pos=seeds, min_dist=0.3)
    assert n2 == 0


def test_swallowed_gas_does_not_also_form_a_star(state):
    """The reference's star formation takes the step's ``active``, which
    predates the swallow, and neither ``conversion_mask`` nor the
    conversion tests the mask: with star formation made certain, a gas
    particle a BH swallowed becomes a star too, its mass counted by the
    BH and the star.  The port's step converts none of them."""
    eng, gas, bh, grid, P = state
    sf_p = eng.sf[0]
    # certain star formation for dense gas: every threshold at 0, the
    # KS normalisation huge
    sf_fields = dict(sf_p.__dict__, density_threshold=0.0,
                     over_density=0.0, entropy_margin=1e30,
                     threshold_slope=0.0, sf_norm=sf_p.sf_norm * 1e12)
    sf_ref = RefSF(**{k: v for k, v in sf_fields.items()
                      if k in RefSF.__dataclass_fields__})
    # the reference: swallow, mask, then star formation on the old active
    bid = ref_ops.bh_swallow_target_loop(grid, _ref(gas), _ref(bh), P,
                                         *TI_REF)
    swallowed = np.asarray(bid) >= 0
    g_r = _ref(gas)
    g_r["mask"] = jnp.where(bid >= 0, 0.0, g_r["mask"])
    active = jnp.asarray(_np(gas["mask"]) > 0)
    cosmo = ref_multi.CosmoFactors(*[jnp.float32(x) for x in eng.cosmo])
    conv, _ = sf_ref.conversion_mask(
        g_r, cosmo, jnp.full(active.shape, 1e-3, jnp.float32), *TI_REF,
        None, active)
    both = swallowed & np.asarray(conv)
    assert both.sum() == swallowed.sum() > 0, \
        "the reference converts every swallowed particle"

    # the port's step on the same kind of state: certain star formation
    sf_port = type(sf_p)(**sf_fields)
    ic, m_sub = crafted_ic()
    e2, _, _ = ev.make_engine(device=CPU, ic=ic, black_holes=True)
    e2.sf = (sf_port, None)
    e2.init_particles()
    craft_port(e2, m_sub)

    def live(name):
        sp = e2.state[name]
        return set(_np(sp["pid"])[_np(sp["mask"]) > 0])

    def total():
        return sum(float((sp["m"] * sp["mask"]).double().sum())
                   for sp in e2.state.values())
    gas0, stars0, m0 = live("gas"), live("stars"), total()
    bh_m0 = float((e2.state["bh"]["m"] * e2.state["bh"]["mask"])
                  .double().sum())
    gm = {int(p): float(m) for p, m in zip(
        _np(e2.state["gas"]["pid"]).reshape(-1),
        _np(e2.state["gas"]["m"]).reshape(-1))}
    d = e2.step()
    new_stars = live("stars") - stars0
    gone = gas0 - live("gas")
    swallowed_p = gone - new_stars
    assert int(d["n_swallowed"]) == len(swallowed_p) > 0
    assert int(d["n_converted"]) == len(new_stars) > 0
    assert not (new_stars & swallowed_p)
    bh_m1 = float((e2.state["bh"]["m"] * e2.state["bh"]["mask"])
                  .double().sum())
    dm = sum(gm[p] for p in swallowed_p)
    assert abs(bh_m1 - bh_m0 - dm) <= 1e-6 * bh_m1
    assert abs(total() - m0) <= 1e-6 * m0

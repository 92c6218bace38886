"""Port vs reference: the Planetary scheme, its multi-material EOS and the
HM80 / SESAME tables.

* Tillotson: the four materials' pressure in each region (cold,
  condensed, expanded, hybrid, the low-density taper) against the
  reference test's scalar oracle (tests/test_planetary.py:17) and, with
  the sound speed, against the reference's EOS on seeded states of every
  family and a scaled unit system (1e-6 relative: the same f32
  operations);
* the tables: HM80 and SESAME files written here in the reference's
  formats, loaded by both packages (the same arrays) and interpolated on
  seeded points, knots and out-of-range points (1e-5 relative: ln P and
  its exp; u = 0 gives P = 0, and the SESAME c_s is held where the
  reference's is finite: see ``test_sesame_matches_reference``); the
  table materials dispatched
  beside the ideal gas and Tillotson; a table id without its table
  raises;
* the lifecycle hooks that call the EOS against the reference's (1e-6 of
  max), on mixed materials;
* the mixed-material box of tests/test_planetary.py:102 (half ideal gas,
  half Tillotson water, SI units) on the port's flat Engine against the
  reference's xla Engine per pid over init + 4 steps (rho, h and u_full
  within 1e-3 relative, a_hydro within 1e-3 of max), the energy drift
  within the reference test's 2e-4, and mat_id int32 and its multiset
  unchanged through a forced rebucket and a re-grid; Planetary's modes
  run Minimal's kernel libraries.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.models.sph import eos_tables as ref_et
from swift_subtask_dev_tpu.models.sph import planetary as ref_planetary
from swift_subtask_dev_tpu.models.sph import planetary_eos as ref_pe
from swift_subtask_dev_tpu.models.sph.sphenix import \
    CosmoFactors as RefCosmo
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
from swift_subtask_dev_tpu_torch.interop import state_from_reference
from swift_subtask_dev_tpu_torch.models.sph import (SCHEMES, eos_tables,
                                                    planetary)
from swift_subtask_dev_tpu_torch.models.sph import planetary_eos as pe
from swift_subtask_dev_tpu_torch.models.sph.sphenix import CosmoFactors
from swift_subtask_dev_tpu_torch.ops import hydro_flat, pair_flat

CPU = torch.device("cpu")
TIL_IDS = (pe.ID_TIL_IRON, pe.ID_TIL_GRANITE, pe.ID_TIL_WATER,
           pe.ID_TIL_BASALT)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _til_scalar_P(rho, u, mat):
    """A scalar Tillotson evaluation (tillotson.h:182), the reference
    test's oracle for the branch-free version."""
    (rho_0, a, b, A, B, u_0, u_iv, u_cv, alpha, beta,
     eta_min, eta_zero, P_min) = pe._TIL_SI[mat]
    eta = rho / rho_0
    mu = eta - 1.0
    nu = 1.0 / eta - 1.0
    w = u / (u_0 * eta * eta) + 1.0
    P_c = (a + b / w) * rho * u + A * mu + B * mu * mu
    if eta < eta_zero:
        P_c = 0.0
    elif eta < eta_min:
        P_c *= (eta - eta_zero) / (eta_min - eta_zero)
    P_e = a * rho * u + (b * rho * u / w
                         + A * mu * np.exp(-beta * nu)) \
        * np.exp(-alpha * nu * nu)
    if (eta > 1.0) or (u < u_iv):
        P = P_c
    elif (eta < 1.0) and (u > u_cv):
        P = P_e
    else:
        P = ((u - u_iv) * P_e + (u_cv - u) * P_c) / (u_cv - u_iv)
    return max(P, P_min)


def _rel(ref, got):
    a = np.asarray(ref, np.float64)
    b = (got.cpu().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got)).astype(np.float64)
    assert a.shape == b.shape
    return np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-30))


def _rel_max(ref, got):
    a = np.asarray(ref, np.float64)
    b = (got.cpu().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got)).astype(np.float64)
    assert a.shape == b.shape
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


# ---------------------------------------------------------------------------
# Tillotson and the material dispatch
# ---------------------------------------------------------------------------

REGION_STATES = [
    (pe.ID_TIL_IRON, 7800.0, 1.0e6),     # cold (u < u_iv)
    (pe.ID_TIL_IRON, 9000.0, 5.0e6),     # condensed (eta > 1)
    (pe.ID_TIL_IRON, 5000.0, 2.0e7),     # expanded and hot (u > u_cv)
    (pe.ID_TIL_IRON, 6000.0, 5.0e6),     # hybrid (u_iv < u < u_cv, eta < 1)
    (pe.ID_TIL_GRANITE, 2000.0, 1.0e7),  # hybrid
    (pe.ID_TIL_BASALT, 3000.0, 5.0e8),   # condensed, hot
    (pe.ID_TIL_WATER, 998.0, 1.0e5),     # water at its reference density
    (pe.ID_TIL_WATER, 890.0, 1.0e5),     # inside the eta taper band
    (pe.ID_TIL_WATER, 850.0, 1.0e5),     # below eta_zero: P_c = 0
]


def test_tillotson_regions_match_the_scalar_oracle():
    eos = pe.PlanetaryEOS(materials=TIL_IDS)
    mid = torch.tensor([s[0] for s in REGION_STATES], dtype=torch.int32)
    rho = torch.tensor([s[1] for s in REGION_STATES], dtype=torch.float32)
    u = torch.tensor([s[2] for s in REGION_STATES], dtype=torch.float32)
    got = eos.pressure_from_internal_energy(rho, u, mid).numpy()
    want = np.array([_til_scalar_P(r, uu, m) for m, r, uu in REGION_STATES])
    np.testing.assert_allclose(got, want, rtol=2e-5)
    cs = eos.soundspeed_from_internal_energy(rho, u, mid).numpy()
    for i, (m, _, _) in enumerate(REGION_STATES):
        A, rho_0 = pe._TIL_SI[m][3], pe._TIL_SI[m][0]
        assert cs[i] >= np.sqrt(A / rho_0) * 0.999
    assert np.all(np.isfinite(cs))


def test_tillotson_table_is_made_once_per_device():
    """The EOS keeps its Tillotson table on each device it is called on:
    later calls reuse the first call's tensors, and the cache is no part
    of the EOS's value."""
    eos = pe.PlanetaryEOS(materials=(pe.ID_IDG_DEF, pe.ID_TIL_WATER))
    mat = torch.tensor([pe.ID_IDG_DEF, pe.ID_TIL_WATER] * 4,
                       dtype=torch.int32)
    rho, u = torch.full((8,), 998.0), torch.full((8,), 1.0e3)
    eos.pressure_from_internal_energy(rho, u, mat)
    first = dict(eos._til_on(mat.device))
    eos.soundspeed_from_internal_energy(rho, u, mat)
    assert all(eos._til_on(mat.device)[k] is v for k, v in first.items())
    twin = pe.PlanetaryEOS(materials=(pe.ID_IDG_DEF, pe.ID_TIL_WATER))
    assert eos == twin and hash(eos) == hash(twin)


def _eos_pair(materials, **kw):
    return (ref_pe.PlanetaryEOS(materials=materials, **kw),
            pe.PlanetaryEOS(materials=materials, **kw))


@pytest.mark.parametrize("units", ["si", "scaled"])
def test_eos_matches_reference_on_every_family(units):
    """P and c_s of the ideal gas and the four Tillotson materials on
    seeded states spanning every region, in SI and in a scaled unit
    system (convert_units_Til)."""
    mats = (pe.ID_IDG_DEF,) + TIL_IDS
    kw = {} if units == "si" else dict(rho_to_si=1e3, u_to_si=1e4,
                                       P_from_si=1e-7, gamma=1.4)
    er, ep = _eos_pair(mats, **kw)
    rng = np.random.default_rng(4)
    n = 5000
    mid = rng.choice(mats, n).astype(np.int32)
    rho0 = np.array([1.0 if m == 0 else pe._TIL_SI[m][0] for m in mid])
    rho = (rho0 * rng.uniform(0.7, 1.3, n)
           / (1.0 if units == "si" else 1e3)).astype(np.float32)
    u = (10 ** rng.uniform(3, 8, n)
         / (1.0 if units == "si" else 1e4)).astype(np.float32)
    for f in ("pressure_from_internal_energy",
              "soundspeed_from_internal_energy"):
        a = getattr(er, f)(jnp.asarray(rho), jnp.asarray(u),
                           jnp.asarray(mid))
        b = getattr(ep, f)(torch.from_numpy(rho), torch.from_numpy(u),
                           torch.from_numpy(mid))
        assert _rel(a, b) <= 1e-6, f
    a = er.soundspeed_from_pressure(jnp.asarray(rho), jnp.asarray(u),
                                    jnp.asarray(mid))
    b = ep.soundspeed_from_pressure(torch.from_numpy(rho),
                                    torch.from_numpy(u),
                                    torch.from_numpy(mid))
    assert _rel(a, b) <= 1e-6


def test_unknown_or_tableless_materials_raise():
    for mats in ((200,), (301,), (105,), (500,)):
        with pytest.raises(ValueError):
            pe.PlanetaryEOS(materials=mats)


# ---------------------------------------------------------------------------
# HM80 and SESAME tables
# ---------------------------------------------------------------------------

def _write_hm80(path, lr0=-2.0, lr1=3.0, nr=8, lu0=8.0, lu1=14.0, nu=10):
    """The HM80 text format: 5 header lines, a date, the axis line, nr x
    nu pressures (Pa), nr x nu temperatures (ignored); a smooth positive
    P(rho, u)."""
    lrho = np.linspace(lr0, lr1, nr)
    lu = np.linspace(lu0, lu1, nu)
    P = np.exp(1.0 + 0.7 * lrho[:, None] + 0.3 * lu[None, :]
               + 0.05 * np.sin(lrho[:, None] * lu[None, :]))
    with open(path, "w") as f:
        for i in range(5):
            f.write(f"# header line {i}\n")
        f.write("20201003\n")
        f.write(f"{lr0} {lr1} {nr} {lu0} {lu1} {nu}\n")
        for row in P:
            f.write(" ".join(f"{v:.8e}" for v in row) + "\n")
        for row in P:
            f.write(" ".join("300.0" for _ in row) + "\n")
    return lrho, lu, P


def _write_sesame(path, nr=6, nT=5):
    """The SESAME text format: 12 header lines, a date, num_rho num_T
    (with the rho = 0 and T = 0 entries), the axes, then T-major rows of
    'u P c s'."""
    rho = np.concatenate([[0.0], np.geomspace(1.0, 1e4, nr)])
    T = np.concatenate([[0.0], np.geomspace(100.0, 1e5, nT)])
    u = 1e4 * (T[None, 1:] / 100.0) ** 1.2 * (1 + 0.1 * np.log10(
        np.maximum(rho[1:, None], 1e-10)))
    P = 1e5 * (rho[1:, None] / 10.0) * (T[None, 1:] / 100.0) ** 0.8
    c = np.sqrt(np.maximum(P, 1e3) / np.maximum(rho[1:, None], 1e-3))
    with open(path, "w") as f:
        for i in range(12):
            f.write(f"# header {i}\n")
        f.write("20220714\n")
        f.write(f"{nr + 1} {nT + 1}\n")
        f.write(" ".join(f"{v:.8e}" for v in rho) + "\n")
        f.write(" ".join(f"{v:.8e}" for v in T) + "\n")
        for iT in range(nT + 1):
            for ir in range(nr + 1):
                if iT == 0 or ir == 0:
                    f.write("0 0 0 0\n")
                else:
                    f.write(f"{u[ir-1, iT-1]:.8e} {P[ir-1, iT-1]:.8e} "
                            f"{c[ir-1, iT-1]:.8e} 1e3\n")
    return rho[1:], u, P, c


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("eos_tables")
    hp, sp = str(d / "HM80_test.txt"), str(d / "SESAME_test.txt")
    hm = _write_hm80(hp)
    se = _write_sesame(sp)
    return {"hm80_path": hp, "sesame_path": sp, "hm80": hm, "sesame": se}


def _same_table(a, b):
    """Two tables (one of each package) hold the same fields."""
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    return fa.keys() == fb.keys() and all(
        np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


def _points(rng, n, lo, hi):
    return np.exp(rng.uniform(lo, hi, n)).astype(np.float32)


@pytest.mark.parametrize("family", ["ice", "hhe"])
def test_hm80_matches_reference(tables, family):
    kw = eos_tables.HM80_DEFAULTS[201 if family == "ice" else 200]
    tr = ref_et.load_hm80(tables["hm80_path"], **kw)
    tp = eos_tables.load_hm80(tables["hm80_path"], **kw)
    assert _same_table(tp, tr)           # the same parsed table
    for units in ((1.0, 1.0, 1.0), (1e3, 1.0, 1e-3)):
        tr_u, tp_u = tr.in_internal(*units), tp.in_internal(*units)
        assert _same_table(tp_u, tr_u)
        rng = np.random.default_rng(5)
        rho = _points(rng, 2000, -2.5, 3.5) / units[0]  # beyond the edges
        u = _points(rng, 2000, 7.5, 14.5) / units[1]
        u[:10] = 0.0                                    # P = 0 (hm80.h:231)
        a = ref_et.hm80_pressure(jnp.asarray(rho), jnp.asarray(u), tr_u)
        b = eos_tables.hm80_pressure(rho, u, tp_u)
        assert _rel(a, b) <= 1e-5
        assert float(b[:10].abs().max()) == 0.0
        a = ref_et.hm80_soundspeed(jnp.asarray(rho), jnp.asarray(u), tr_u)
        b = eos_tables.hm80_soundspeed(rho, u, tp_u)
        assert _rel(a, b) <= 1e-5
    lrho, lu, P = tables["hm80"]
    knot = eos_tables.hm80_pressure(np.float32(np.exp(lrho[3])),
                                    np.float32(np.exp(lu[4])), tp)
    np.testing.assert_allclose(float(knot), P[3, 4], rtol=2e-4)


def test_sesame_matches_reference(tables):
    tr = ref_et.load_sesame(tables["sesame_path"])
    tp = eos_tables.load_sesame(tables["sesame_path"])
    assert _same_table(tp, tr)
    rho_ax, u_tab, P_tab, c_tab = tables["sesame"]
    for units in ((1.0, 1.0, 1.0), (1e3, 1e2, 1e-5)):
        tr_u, tp_u = tr.in_internal(*units), tp.in_internal(*units)
        assert _same_table(tp_u, tr_u)
        rng = np.random.default_rng(6)
        rho = _points(rng, 2000, -0.5, 10.0) / units[0]
        u = _points(rng, 2000, 8.0, 22.0) / units[1]
        u[:10] = 0.0
        a = ref_et.sesame_pressure(jnp.asarray(rho), jnp.asarray(u), tr_u)
        b = eos_tables.sesame_pressure(rho, u, tp_u)
        assert _rel(a, b) <= 1e-5
        assert float(b[:10].abs().max()) == 0.0
        # c_s where the reference's is finite: at u = 0 its XLA flushes
        # the subnormal 1e-38 guard of ln u to zero (ln 0 = -inf) and can
        # give NaN, where torch keeps the guard and stays finite
        a = np.asarray(ref_et.sesame_soundspeed(jnp.asarray(rho),
                                                jnp.asarray(u), tr_u))
        b = eos_tables.sesame_soundspeed(rho, u, tp_u)
        fin = np.isfinite(a)
        assert fin[10:].all() and bool(torch.isfinite(b).all())
        assert _rel(a[fin], b[fin]) <= 1e-5
    for ir, iT in ((1, 1), (3, 2), (4, 3)):
        got = eos_tables.sesame_pressure(np.float32(rho_ax[ir]),
                                         np.float32(u_tab[ir, iT]), tp)
        np.testing.assert_allclose(float(got), P_tab[ir, iT], rtol=2e-4)
        gc = eos_tables.sesame_soundspeed(np.float32(rho_ax[ir]),
                                          np.float32(u_tab[ir, iT]), tp)
        np.testing.assert_allclose(float(gc), c_tab[ir, iT], rtol=2e-4)


def test_table_materials_dispatch_beside_the_others(tables):
    hr = ref_et.load_hm80(tables["hm80_path"], **ref_et.HM80_DEFAULTS[200])
    hp = eos_tables.load_hm80(tables["hm80_path"],
                              **eos_tables.HM80_DEFAULTS[200])
    sr = ref_et.load_sesame(tables["sesame_path"])
    sp = eos_tables.load_sesame(tables["sesame_path"])
    mats = (pe.ID_IDG_DEF, pe.ID_TIL_WATER, 200, 300)
    er = ref_pe.PlanetaryEOS(materials=mats, hm80_tables=((200, hr),),
                             sesame_tables=((300, sr),))
    ep = pe.PlanetaryEOS(materials=mats, hm80_tables=((200, hp),),
                         sesame_tables=((300, sp),))
    rng = np.random.default_rng(8)
    n = 400
    mid = np.repeat(np.asarray(mats, np.int32), n // 4)
    rho = np.where(mid == pe.ID_TIL_WATER, 998.0, 10.0).astype(np.float32) \
        * rng.uniform(0.8, 1.2, n).astype(np.float32)
    u = np.exp(rng.uniform(9.0, 12.0, n)).astype(np.float32)
    for f in ("pressure_from_internal_energy",
              "soundspeed_from_internal_energy"):
        a = getattr(er, f)(jnp.asarray(rho), jnp.asarray(u),
                           jnp.asarray(mid))
        b = getattr(ep, f)(torch.from_numpy(rho), torch.from_numpy(u),
                           torch.from_numpy(mid))
        assert _rel(a, b) <= 1e-5, f
        assert bool((b >= 0).all()) and bool((b[mid == 200] > 0).all())


# ---------------------------------------------------------------------------
# the scheme's hooks, its modes, and the mixed-material engine
# ---------------------------------------------------------------------------

def _state(seed=0, shape=(4, 128)):
    """A tiled state of mixed materials (ideal gas, water, iron) with
    empty slots."""
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=shape) > 0.2).astype(np.float32)
    mat = rng.choice([pe.ID_IDG_DEF, pe.ID_TIL_WATER, pe.ID_TIL_IRON],
                     shape).astype(np.int32)
    rho0 = np.where(mat == pe.ID_IDG_DEF, 1.0,
                    np.where(mat == pe.ID_TIL_WATER, 998.0, 7800.0))

    def u(lo, hi, sh=shape):
        return rng.uniform(lo, hi, sh).astype(np.float32)

    return {
        "mask": mask, "mat_id": mat, "h": u(0.05, 0.11) * mask,
        "m": u(0.5, 1.5), "rho": (rho0 * u(0.9, 1.1)).astype(np.float32),
        "rho_dh": u(-50, -5), "wcount": u(300, 900),
        "wcount_dh": u(-2e4, -1e3), "div_v": u(-2, 2),
        "rot_v": u(-1, 1, shape + (3,)), "u": u(1e3, 1e7),
        "u_full": u(1e3, 1e7), "u_dt": u(-5, 5), "h_dt": u(-0.5, 0.5),
        "v_sig": u(1, 3), "alpha_visc": u(0.0, 1.0),
        "soundspeed": u(0.8, 1.5), "v": u(-1, 1, shape + (3,)),
        "v_full": u(-1, 1, shape + (3,)),
    }


PLANETARY_HOOKS = [
    ("prepare_gradient", lambda m, P, s, c: m.prepare_gradient(P, s, c)),
    ("predict_extra", lambda m, P, s, c: m.predict_extra(P, s, c, 2e-4,
                                                         2e-4)),
    ("reset_predicted_values",
     lambda m, P, s, c: m.reset_predicted_values(P, s)),
    ("prepare_force", lambda m, P, s, c: m.prepare_force(P, s, c, 1e-3)),
]


@pytest.mark.parametrize("name,fn", PLANETARY_HOOKS,
                         ids=[n for n, _ in PLANETARY_HOOKS])
def test_hooks_match_reference(name, fn):
    mats = (pe.ID_IDG_DEF, pe.ID_TIL_WATER, pe.ID_TIL_IRON)
    er, ep = _eos_pair(mats)
    pr = ref_planetary.PlanetaryParams(h_max=0.1, eos=er)
    pp = planetary.PlanetaryParams(h_max=0.1, eos=ep)
    s = _state()
    cosmo = dict(a=0.5, H=1.3, a_inv2=4.0, fac_mu=0.7,
                 a_factor_sound_speed=1.2, a_factor_Balsara_eps=0.9,
                 a_factor_internal_energy=1.1)
    out_r = fn(pr.mod, pr, {k: jnp.asarray(v) for k, v in s.items()},
               RefCosmo(**cosmo))
    out_p = fn(pp.mod, pp, {k: torch.from_numpy(v.copy())
                            for k, v in s.items()}, CosmoFactors(**cosmo))
    assert set(out_r) == set(out_p)
    for k in out_r:
        if np.asarray(out_r[k]).dtype.kind == "f":
            assert _rel_max(out_r[k], out_p[k]) <= 1e-6, (name, k)
        else:
            assert np.array_equal(np.asarray(out_r[k]), out_p[k].numpy())


def test_planetary_modes_run_minimal_s_libraries():
    pp = SCHEMES["planetary"]()
    assert planetary.CUDA_STRUCT == "Minimal"
    assert hydro_flat.sph_mode(pp) == "planetary/cubic-spline"
    for kernel in pair_flat.KERNEL_STRUCTS:
        assert pair_flat.mode_library(f"planetary/{kernel}") \
            is pair_flat.mode_library(f"minimal/{kernel}")
    libs = pair_flat.mode_libraries()
    assert len(libs) == len({lib.flags for lib in libs}) \
        == (len(pair_flat.SCHEME_STRUCTS) - 1) * len(pair_flat.KERNEL_STRUCTS)\
        - 1


N_STEPS = 4


def _mixed_engine(pkg_grid, pkg_engine, P, backend, **dev):
    """The reference test's mixed-material box (tests/test_planetary.py:
    102): uniform_box_ic(n=6, jitter=0.05, seed=11) in 1 m^3, masses x
    998, ideal gas and Tillotson water alternating, u = 1e3, dt_max
    1e-7."""
    ic = uniform_box_ic(n=6, jitter=0.05, seed=11)
    n = len(ic["pos"])
    mat = np.where(np.arange(n) % 2 == 0, pe.ID_IDG_DEF,
                   pe.ID_TIL_WATER).astype(np.int32)
    reach = float(ic["h"].max() * P.kernel.gamma * 1.25)
    if backend == "flat":
        grid = pkg_grid.build_columns(ic["box"], interaction_range=reach,
                                      pos=ic["pos"])
    else:
        grid = pkg_grid(box=(1.0, 1.0, 1.0), cdim=(3, 3, 3), K=48)
    eng = pkg_engine.Engine(grid, P, pkg_engine.EngineConfig(
        dt_max=1e-7, backend=backend), 0.0, 1.0, **dev)
    eng.load_particles(ic["pos"], np.asarray(ic["m"]) * 998.0, ic["v"],
                       np.full(n, 1.0e3, np.float32), ic["h"],
                       extra_fields={"mat_id": mat})
    return eng, mat


def _np_state(state):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).copy() for k, v in state.items()}


def _energy(s):
    live = s["mask"] > 0
    m = s["m"][live].astype(np.float64)
    v = s["v_full"][live].astype(np.float64)
    return float((0.5 * m * (v * v).sum(-1)
                  + m * s["u_full"][live].astype(np.float64)).sum())


@pytest.fixture(scope="module")
def engine_runs():
    mats = (pe.ID_IDG_DEF, pe.ID_TIL_WATER)
    er, ep = _eos_pair(mats)
    runs = {}
    for name, P, grid, eng_mod, backend, dev in (
            ("ref", ref_planetary.PlanetaryParams(h_max=0.4, eos=er),
             RefGrid, ref_engine, "xla", {}),
            ("port", planetary.PlanetaryParams(h_max=0.4, eos=ep), CellGrid,
             port_engine, "flat", {"device": CPU})):
        eng, mat = _mixed_engine(grid, eng_mod, P, backend, **dev)
        eng.init_particles()
        init = _np_state(eng.state)
        for _ in range(N_STEPS):
            eng.step()
        runs[name] = {"init": init, "final": _np_state(eng.state),
                      "engine": eng, "mat": mat}
    return runs


def _perpid(s, x):
    pid = s["pid"].ravel()
    m = s["mask"].ravel() > 0
    x = np.asarray(x)
    x = x.reshape((-1,) + x.shape[2:])[m]
    return x[np.argsort(pid[m])]


@pytest.mark.parametrize("when", ["init", "final"])
def test_engine_matches_reference_per_pid(engine_runs, when):
    r, p = engine_runs["ref"][when], engine_runs["port"][when]
    for k in ("rho", "h", "u_full"):
        a, b = _perpid(r, r[k]), _perpid(p, p[k])
        assert np.max(np.abs(b - a) / np.abs(a)) <= 1e-3, k
    assert _rel_max(_perpid(r, r["a_hydro"]), _perpid(p, p["a_hydro"])) \
        <= 1e-3
    assert np.array_equal(_perpid(r, r["mat_id"]), _perpid(p, p["mat_id"]))
    assert np.array_equal(_perpid(r, r["time_bin"]),
                          _perpid(p, p["time_bin"]))
    live = p["mask"] > 0
    assert np.all(p["pressure"][live] >= 0)


def test_engine_conserves_energy(engine_runs):
    p = engine_runs["port"]
    de = abs(_energy(p["final"]) - _energy(p["init"])) \
        / abs(_energy(p["init"]))
    assert de < 2e-4


def _mat_multiset(s):
    return np.sort(s["mat_id"][s["mask"] > 0])


def test_mat_id_survives_rebucket_and_regrid(engine_runs):
    run = engine_runs["port"]
    eng, want = run["engine"], np.sort(run["mat"])
    assert eng.state["mat_id"].dtype == torch.int32
    assert np.array_equal(_mat_multiset(run["final"]), want)
    eng.state["drift_accum"] = torch.full_like(eng.state["drift_accum"],
                                               float("inf"))
    eng.step()                  # the step's rebucket, forced
    assert float(eng.state["drift_accum"]) < float("inf")
    assert eng.state["mat_id"].dtype == torch.int32
    assert np.array_equal(_mat_multiset(_np_state(eng.state)), want)
    eng.regrid()
    assert eng.state["mat_id"].dtype == torch.int32
    assert np.array_equal(_mat_multiset(_np_state(eng.state)), want)


def test_state_from_reference_carries_mat_id(engine_runs):
    ref = engine_runs["ref"]["final"]
    st = state_from_reference(ref, CPU)
    assert st["mat_id"].dtype == torch.int32
    assert np.array_equal(st["mat_id"].numpy(), ref["mat_id"])

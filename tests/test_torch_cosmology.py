"""Port vs reference: cosmology, units and constant-Lambda cooling.

The cosmology is f64 numpy on the host in both packages: its tables,
a(ti), H(a), the drift/kick/thermal factors and the engine's per-step
tables under cosmology (``Engine._tables`` with ``ti_drift_start``, the
wake tables) agree to 1e-12 relative (the f32 tables, rounded once from
those f64 values, bit for bit).  ``factors_at`` is the reference's f32
rounding of each factor.  The cooling hook is f32 torch against the
reference's jnp: 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.models import cosmology as ref_cosmology
from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as RefP
from swift_subtask_dev_tpu.subgrid import cooling as ref_cooling
from swift_subtask_dev_tpu.utils import units as ref_units
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.models import cosmology as port_cosmology
from swift_subtask_dev_tpu_torch.models.sph.sphenix import SPHENIXParams
from swift_subtask_dev_tpu_torch.subgrid import cooling as port_cooling
from swift_subtask_dev_tpu_torch.utils import timeline as tl
from swift_subtask_dev_tpu_torch.utils import units as port_units

CPU = torch.device("cpu")
# examples/small_cosmo_volume/run.yml, and a massive-neutrino background
RUN_YML = dict(Omega_cdm=0.26, Omega_b=0.049, Omega_lambda=0.691, h=0.67,
               a_begin=0.1, a_end=1.0)
NEUTRINOS = dict(Omega_cdm=0.25, Omega_b=0.049, Omega_lambda=0.69,
                 h=0.67, a_begin=0.02, a_end=1.0, Omega_g=5.5e-5,
                 N_ur=2.0328, M_nu_eV=(0.06,))
TI = [0, 1, 4096, 3 << 40, (1 << 50) + 12, (1 << 55) + (1 << 53),
      (1 << 56) - 8]


def _pair(kw):
    ref = ref_cosmology.Cosmology(
        **kw, phys_const=ref_units.COSMO_UNITS.constants())
    port = port_cosmology.Cosmology(
        **kw, phys_const=port_units.COSMO_UNITS.constants())
    return ref, port


@pytest.fixture(scope="module", params=["run_yml", "neutrinos"])
def cosmologies(request):
    return _pair(RUN_YML if request.param == "run_yml" else NEUTRINOS)


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= rtol * np.maximum(np.abs(a), 1e-300)), \
        np.abs(a - b).max()


def test_units_and_constants_match():
    r, p = ref_units.COSMO_UNITS, port_units.COSMO_UNITS
    assert r.base_factors() == p.base_factors()
    assert r.constants().as_dict() == p.constants().as_dict()
    for name in ref_units.UNIT_EXPONENTS:
        assert r.from_cgs(name) == p.from_cgs(name), name


def test_tables_and_background_match(cosmologies):
    ref, port = cosmologies
    for k in ("_la", "_t", "_drift", "_grav_kick", "_therm_kick",
              "_corr_kick"):
        _close(getattr(ref, k), getattr(port, k))
    for k in ("H0", "Omega_m", "time_base", "log_a_begin", "Omega_ur",
              "Omega_nu_0"):
        _close(getattr(ref, k), getattr(port, k))
    a = np.geomspace(ref.a_begin, ref.a_end, 50)
    _close(ref.E(a), port.E(a))
    _close(ref.H(a), port.H(a))
    _close(ref.Omega_nu(a), port.Omega_nu(a))


@pytest.mark.parametrize("ti", TI)
def test_a_of_ti_and_factors_match(cosmologies, ti):
    ref, port = cosmologies
    _close(ref.a_of_ti(ti), port.a_of_ti(ti))
    _close(ref.time_of_ti(ti), port.time_of_ti(ti))
    hi = min(ti + (1 << 44), tl.MAX_NR_TIMESTEPS)
    for k in ("drift_factor", "grav_kick_factor", "therm_kick_factor",
              "corr_kick_factor", "delta_time"):
        _close(getattr(ref, k)(ti, hi), getattr(port, k)(ti, hi))
    fr, fp = ref.factors_at(ti), port.factors_at(ti)
    assert fr._fields == fp._fields
    for k in fr._fields:
        # each factor rounded to f32 as the reference rounds it
        assert float(np.float32(getattr(fr, k))) == getattr(fp, k), k


def _engines(cosmology_pair, ti, limiter=True):
    ref_c, port_c = cosmology_pair
    grid = ((1.0, 1.0, 1.0), (3, 3, 1), 128)
    ref = ref_engine.Engine(
        RefGrid(*grid), RefP(),
        ref_engine.EngineConfig(dt_max=0.01, backend="flat",
                                with_timestep_limiter=limiter),
        0.0, 1.0, cosmology=ref_c)
    port = port_engine.Engine(
        CellGrid(*grid), SPHENIXParams(),
        port_engine.EngineConfig(dt_max=0.01, with_timestep_limiter=limiter),
        0.0, 1.0, cosmology=port_c, device=CPU)
    ref.timeline.ti_current = port.timeline.ti_current = ti
    return ref, port


@pytest.mark.parametrize("ti", TI[2:])
def test_engine_tables_under_cosmology_match(cosmologies, ti):
    """Engine._tables with ti_drift_start: every per-bin table and scalar
    (f32 rounded once from the f64 integrals: bit for bit), and the step's
    CosmoFactors."""
    ref, port = _engines(cosmologies, ti)
    start = ti - tl.get_integer_timestep(30)
    dt = (ti - start) * ref.timeline.time_base
    Tr = ref._tables(dt_drift=dt, ti_drift_start=start)
    Tp = port._tables(dt_drift=dt, ti_drift_start=start)
    for k in ("active", "dt_kick1", "dt_kick2", "dt_therm1", "dt_therm2",
              "dt_alpha", "dt_therm_full", "aligned_up", "wake_dv",
              "wake_du"):
        a, b = np.asarray(getattr(Tr, k)), getattr(Tp, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # the kicks are integrals of 1/a over the bin's half step, not the
    # half step in log(a) itself
    half = np.float32(0.5 * tl.get_integer_timestep(40)
                      * ref.timeline.time_base)
    assert Tp.dt_kick1[40].item() != half
    assert np.asarray(Tr.wake_dv).any()
    for k in ("dt_drift", "dt_therm_drift", "time_base_inv"):
        assert float(getattr(Tr, k)) == getattr(Tp, k), k
    assert int(Tr.max_bin) == Tp.max_bin
    assert tuple(float(x) for x in ref.cosmo) == tuple(port.cosmo)
    # the drift is the integral of 1/a^2, not the raw Delta log(a)
    assert abs(Tp.dt_drift - dt) > 1e-3 * dt


@pytest.mark.parametrize("amax", [1e-3, 1.0, 1e3])
def test_mesh_step_and_kick_factor_under_cosmology(cosmologies, amax):
    ti = 1 << 50
    ref, port = _engines(cosmologies, ti, limiter=False)
    for e in (ref, port):
        e.mesh_dt_scale = 0.05
    assert ref._pick_mesh_dti(amax) == port._pick_mesh_dti(amax)
    lo, hi = ti, ti + port._pick_mesh_dti(amax) // 2
    _close(ref._kick_fac(lo, hi), port._kick_fac(lo, hi))


def test_const_lambda_cooling_matches():
    units_r, units_p = ref_units.COSMO_UNITS, port_units.COSMO_UNITS
    mr = ref_cooling.ConstLambdaCooling.from_cgs(1e-26, units_r,
                                                 units_r.constants())
    mp = port_cooling.ConstLambdaCooling.from_cgs(1e-26, units_p,
                                                  units_p.constants())
    assert mr.coeff == mp.coeff > 0
    ref_c, port_c = _pair(RUN_YML)
    rng = np.random.default_rng(3)
    shape = (9, 128)
    s = {"u_full": rng.uniform(0.5, 200.0, shape).astype(np.float32),
         "rho": rng.uniform(0.0, 5.0, shape).astype(np.float32),
         "u_dt": rng.normal(0.0, 50.0, shape).astype(np.float32)}
    dt = rng.uniform(0.0, 2e-3, shape).astype(np.float32)
    dt[0, :8] = 0.0
    fr = ref_cooling.make_cooling_fn(mr, None, u_minimal=1.0)
    fp = port_cooling.make_cooling_fn(mp, u_minimal=1.0)
    for ti in (0, 1 << 55):
        a = fr({k: jnp.asarray(v) for k, v in s.items()},
               ref_c.factors_at(ti), jnp.asarray(dt))
        b = fp({k: torch.from_numpy(v) for k, v in s.items()},
               port_c.factors_at(ti), torch.from_numpy(dt))
        assert a.keys() == b.keys() == {"u_dt"}
        x, y = np.asarray(a["u_dt"]), b["u_dt"].numpy()
        assert np.all(np.abs(x - y) <= 1e-6 * np.abs(x).max()), ti
        assert np.array_equal(y[0, :8], s["u_dt"][0, :8])
        assert (y != s["u_dt"]).mean() > 0.5


def test_other_cooling_models_are_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_cooling.make_cooling_fn(object())
    m = port_cooling.ConstLambdaCooling(coeff=1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_cooling.make_cooling_fn(m, floor=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_cooling.make_cooling_fn(m, rapid=True)

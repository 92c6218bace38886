"""Port vs reference: the EAGLE subgrid models, one call each.

The same inputs, made from a numpy seed, through the JAX package's
functions and the port's:

* the counter RNGs: Threefry-2x32 draws (``unit_interval_traced``) over
  10^4 (id, ti_lo, ti_hi) triples and ``_pair_hash_uniform`` over 10^4
  pairs, bit for bit; the committed table ``utils/rng_table.json`` that
  the card's draws are held against is JAX's;
* ``EagleEntropyFloor``, ``EagleCooling`` (its tables exactly, the rates
  ``du_dt_internal``, the cooling hook after one call with the floor),
  ``EagleStarFormation`` (parameters, SFR, and the conversion mask on a
  crafted dense, star-forming state, bit for bit outside the rounding
  band of |draw - prob|), ``EagleThermalFeedback.firing_energy``,
  ``EagleEnrichment.ejecta`` (1e-5 of max: each window differences two
  interpolations of a cumulative table) and ``EagleChemistry``, the rest
  at 1e-6 relative.
"""

import copy
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift_subtask_dev_tpu.models.sph.sphenix import CosmoFactors as RefCF
from swift_subtask_dev_tpu.ops.stencil import _pair_hash_uniform as ref_hash
from swift_subtask_dev_tpu.subgrid import chemistry as ref_chem
from swift_subtask_dev_tpu.subgrid import eagle_cooling as ref_cool
from swift_subtask_dev_tpu.subgrid import star_formation as ref_sf
from swift_subtask_dev_tpu.utils import units as ref_units
from swift_subtask_dev_tpu.utils.params import Params as RefParams
from swift_subtask_dev_tpu_torch.examples import eagle_volume as ev
from swift_subtask_dev_tpu_torch.models.cosmology import Cosmology
from swift_subtask_dev_tpu_torch.ops.stencil import _pair_hash_uniform
from swift_subtask_dev_tpu_torch.subgrid import chemistry as port_chem
from swift_subtask_dev_tpu_torch.subgrid import eagle_cooling as port_cool
from swift_subtask_dev_tpu_torch.subgrid import star_formation as port_sf
from swift_subtask_dev_tpu_torch.utils import prng
from swift_subtask_dev_tpu_torch.utils import units as port_units
from swift_subtask_dev_tpu_torch.utils.params import Params

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
RUN_YML = ev.RUN_YML
UNITS = port_units.COSMO_UNITS
REF_UNITS = ref_units.COSMO_UNITS


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _cosmology():
    c = RUN_YML["Cosmology"]
    return Cosmology(Omega_cdm=c["Omega_cdm"], Omega_b=c["Omega_b"],
                     Omega_lambda=c["Omega_lambda"], h=c["h"],
                     a_begin=c["a_begin"], a_end=c["a_end"],
                     phys_const=UNITS.constants())


# a tick of the EAGLE run's timeline (a ~ 0.18)
TI = (1 << 55) + 12345


def _factors(ti):
    """(port CosmoFactors, the reference's with f32 fields, as its jitted
    step sees them) of the EAGLE cosmology at tick ``ti``."""
    cf = _cosmology().factors_at(ti)
    return cf, RefCF(*[jnp.float32(v) for v in cf])


@pytest.fixture(scope="module")
def models():
    """The EAGLE models of run.yml in both packages (cli.build_subgrid's
    wiring, the port's through examples/eagle_volume.build_models)."""
    from swift_subtask_dev_tpu import cli as ref_cli
    from swift_subtask_dev_tpu.models import cosmology as ref_cosmology
    params = RefParams(copy.deepcopy(RUN_YML))
    pc = REF_UNITS.constants()
    rcos = ref_cosmology.make_cosmology_from_params(params, pc)
    sph, _ = ref_cli.build_sph_params(params)

    class Args:
        cooling = star_formation = feedback = True
        black_holes = sinks = False
    (cool_fn, sf, floor, fb, _, _, enr) = ref_cli.build_subgrid(
        params, REF_UNITS, Args, rcos, sph)
    p_cool, p_sf, p_floor, p_fb, p_enr = ev.build_models(
        Params(copy.deepcopy(RUN_YML)), UNITS, _cosmology())
    return {"ref": (cool_fn, sf, floor, fb, enr),
            "port": (p_cool, p_sf, p_floor, p_fb, p_enr)}


# ---------------------------------------------------------------------------
# counter RNGs
# ---------------------------------------------------------------------------

def test_threefry_draws_match_jax_bit_for_bit():
    """10^4 (id, ti_lo, ti_hi) triples, ids including -1 (empty slots) and
    the int32 extremes, for the star-formation purpose and a feedback
    one."""
    rng = np.random.default_rng(11)
    n = 10_000
    ids = rng.integers(-1, 2 ** 31 - 1, n).astype(np.int32)
    ids[:4] = (-1, 0, 1, 2 ** 31 - 1)
    for purpose in (port_sf.SF_PURPOSE, 0x2ad1):
        for lo, hi in ((0, 0), (int(rng.integers(0, 2 ** 31)), 1),
                       (2 ** 31 - 1, int(rng.integers(0, 2 ** 31)))):
            ref = ref_sf.unit_interval_traced(jnp.asarray(ids),
                                              jnp.int32(lo), jnp.int32(hi),
                                              purpose)
            got = prng.unit_interval(torch.as_tensor(ids), lo, hi, purpose)
            assert np.array_equal(_bits(ref), _bits(got.numpy())), \
                (purpose, lo, hi)


def test_pair_hash_matches_reference_bit_for_bit():
    rng = np.random.default_rng(12)
    n = 10_000
    a = rng.integers(-1, 2 ** 31 - 1, n).astype(np.int32)
    b = rng.integers(-1, 2 ** 31 - 1, n).astype(np.int32)
    a[:3], b[:3] = (-1, 0, 2 ** 31 - 1), (2 ** 31 - 1, -1, 0)
    for lo, hi, salt in ((0, 0, 0x5bd1e995),
                         (int(rng.integers(0, 2 ** 31)), 3, 0x5bd1e995),
                         (2 ** 31 - 1, 2 ** 31 - 1, 0xFFFFFFFF)):
        ref = ref_hash(jnp.asarray(a).astype(jnp.uint32),
                       jnp.asarray(b).astype(jnp.uint32), jnp.int32(lo),
                       jnp.int32(hi), salt)
        got = _pair_hash_uniform(torch.as_tensor(a), torch.as_tensor(b),
                                 lo, hi, salt)
        assert np.array_equal(_bits(ref), _bits(got.numpy())), (lo, hi)


def test_rng_table_is_the_references():
    """Every row of the committed table is JAX's draw, and the port's
    draws on the CPU reproduce all of them."""
    with open(prng.RNG_TABLE) as f:
        table = json.load(f)
    rows = table["unit_interval"]["rows"]
    assert len(rows) >= 64 and len(table["pair_hash"]["rows"]) >= 64
    for i, lo, hi, purpose, bits in rows:
        u = ref_sf.unit_interval_traced(jnp.asarray([i], jnp.int32),
                                        jnp.int32(lo), jnp.int32(hi),
                                        purpose)
        assert int(_bits(u)[0]) == bits
    for a, b, lo, hi, salt, bits in table["pair_hash"]["rows"]:
        u = ref_hash(jnp.asarray([a], jnp.int32).astype(jnp.uint32),
                     jnp.asarray([b], jnp.int32).astype(jnp.uint32),
                     jnp.int32(lo), jnp.int32(hi), salt)
        assert int(_bits(u)[0]) == bits
    assert prng.check_table(CPU) == (128, 0)


# ---------------------------------------------------------------------------
# entropy floor and cooling
# ---------------------------------------------------------------------------

def _densities(n=4096, seed=13):
    """Physical and comoving densities spanning the floors' thresholds."""
    rng = np.random.default_rng(seed)
    rho_com = (10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    rho_phys = (rho_com * 10.0 ** rng.uniform(0, 4, n)).astype(np.float32)
    return rho_phys, rho_com


def test_entropy_floor_matches(models):
    ref, port = models["ref"][2], models["port"][2]
    for f in ("jeans_density_threshold", "jeans_pressure_norm",
              "cool_density_threshold", "cool_pressure_norm",
              "rho_crit_baryon_0", "jeans_gamma_eff", "cool_gamma_eff"):
        assert math.isclose(getattr(ref, f), getattr(port, f),
                            rel_tol=1e-12), f
    rho_phys, rho_com = _densities()
    for name in ("pressure_floor", "u_floor"):
        a = getattr(ref, name)(jnp.asarray(rho_phys), jnp.asarray(rho_com))
        b = getattr(port, name)(torch.as_tensor(rho_phys),
                                torch.as_tensor(rho_com))
        assert (np.asarray(a) > 0).any()
        assert _rel(a, b.numpy()) <= 1e-6, name


def test_eagle_cooling_tables_and_rates():
    params_ref = RefParams(copy.deepcopy(RUN_YML))
    ref = ref_cool.EagleCooling.from_params(params_ref, REF_UNITS,
                                            REF_UNITS.constants())
    port = port_cool.EagleCooling.from_params(
        Params(copy.deepcopy(RUN_YML)), UNITS, UNITS.constants())
    assert np.array_equal(np.asarray(ref.table), port.table)
    assert np.array_equal(np.asarray(ref.metal_table), port.metal_table)
    for f in ("nH_from_rho", "T_from_u", "dudt_from_cgs",
              "hydrogen_mass_fraction"):
        assert getattr(ref, f) == getattr(port, f), f
    rng = np.random.default_rng(14)
    n = 4096
    # physical densities from n_H ~ 1e-7 to ~1e3 cm^-3: at lower ones the
    # reference's f32 Lambda n_H^2 is subnormal, which XLA flushes to 0
    # and torch keeps (eagle_cooling.py)
    rho = (10.0 ** rng.uniform(-2, 4, n)).astype(np.float32)
    u = (10.0 ** rng.uniform(-1, 7, n)).astype(np.float32)
    Z = rng.uniform(0.0, 0.04, n).astype(np.float32)
    for z in (9.0, 3.7, 0.2):
        zf = float(np.float32(z))
        a = ref.du_dt_internal(jnp.asarray(rho), jnp.asarray(u),
                               jnp.float32(zf), jnp.asarray(Z))
        b = port.du_dt_internal(torch.as_tensor(rho), torch.as_tensor(u),
                                zf, torch.as_tensor(Z))
        a = np.asarray(a, np.float64)
        err = np.abs(a - b.numpy()) / np.maximum(np.abs(a), 1e-3
                                                 * np.abs(a).max())
        assert err.max() <= 1e-5, (z, err.max())
        assert _rel(a, b.numpy()) <= 1e-6, z


def test_eagle_cooling_hook_one_call(models):
    """The cooling hook (with the entropy floor and the minimal energy) on
    a state of random densities, energies, energy rates and smoothed
    metallicities at a ~ 0.18: u_dt at 1e-6 of max."""
    ref_fn, port_fn = models["ref"][0], models["port"][0]
    rng = np.random.default_rng(15)
    n = 4096
    s = {"u_full": (10.0 ** rng.uniform(-1, 4, n)).astype(np.float32),
         "rho": (10.0 ** rng.uniform(-2, 3, n)).astype(np.float32),
         "u_dt": rng.normal(0, 50, n).astype(np.float32),
         "Z": rng.uniform(0.0, 0.03, n).astype(np.float32)}
    dt = (10.0 ** rng.uniform(-5, -2, n)).astype(np.float32)
    dt[:8] = 0.0
    cf, rcf = _factors(TI)
    a = ref_fn({k: jnp.asarray(v) for k, v in s.items()}, rcf,
               jnp.asarray(dt))["u_dt"]
    b = port_fn({k: torch.as_tensor(v) for k, v in s.items()}, cf,
                torch.as_tensor(dt))["u_dt"]
    assert _rel(a, b.numpy()) <= 1e-6
    assert np.array_equal(np.asarray(a)[:8], s["u_dt"][:8])


# ---------------------------------------------------------------------------
# star formation, feedback, enrichment, chemistry
# ---------------------------------------------------------------------------

def _dense_gas(n=4096, seed=16):
    """A crafted gas state (taken at a ~ 0.18) with dense, star-forming
    particles (physical n_H up to ~100 cm^-3 near the entropy floor) and
    diffuse or hot ones, as tests/test_star_formation.py crafts one."""
    rng = np.random.default_rng(seed)
    return {"rho": (10.0 ** rng.uniform(-1, 3, n)).astype(np.float32),
            "pressure": (10.0 ** rng.uniform(-3, 4, n)).astype(np.float32),
            "m": rng.uniform(1e-4, 2e-4, n).astype(np.float32),
            "Z": rng.uniform(0.0, 0.02, n).astype(np.float32),
            "pid": rng.permutation(n).astype(np.int32) + 7}


def test_star_formation_parameters_and_conversion(models):
    ref, port = models["ref"][1], models["port"][1]
    floor_r, floor_p = models["ref"][2], models["port"][2]
    for f in ("sf_norm", "sf_power", "high_den_thresh", "sf_high_norm",
              "density_threshold", "entropy_margin", "rho_crit_baryon_0",
              "density_threshold_max"):
        assert math.isclose(getattr(ref, f), getattr(port, f),
                            rel_tol=1e-9), f
    s = _dense_gas()
    n = len(s["m"])
    rng = np.random.default_rng(17)
    active = rng.uniform(0, 1, n) < 0.8
    ti = TI
    cf, rcf = _factors(ti)
    # per-particle dt: prob = SFR dt / m spans the draws
    dt = (10.0 ** rng.uniform(-6, -1, n)).astype(np.float32)
    lo, hi = ti & 0x7FFFFFFF, (ti >> 31) & 0x7FFFFFFF
    conv_r, sfr_r = ref.conversion_mask(
        {k: jnp.asarray(v) for k, v in s.items()}, rcf, jnp.asarray(dt),
        jnp.int32(lo), jnp.int32(hi), floor_r, jnp.asarray(active))
    conv_p, sfr_p = port.conversion_mask(
        {k: torch.as_tensor(v) for k, v in s.items()}, cf,
        torch.as_tensor(dt), lo, hi, floor_p, torch.as_tensor(active))
    conv_r, sfr_r = np.asarray(conv_r), np.asarray(sfr_r)
    assert (sfr_r > 0).sum() > 100 and conv_r.sum() > 20
    assert _rel(sfr_r, sfr_p.numpy()) <= 1e-6
    # a decision may flip only where |draw - prob| is at rounding level
    draw = prng.unit_interval(torch.as_tensor(s["pid"]), lo, hi,
                              port_sf.SF_PURPOSE).numpy()
    sfr_m = np.where(sfr_r > 0, sfr_r / s["m"], 0.0)
    near = np.abs(draw - sfr_m * dt) <= 1e-6 * np.maximum(draw, 1e-30)
    flips = (conv_r != conv_p.numpy()) & ~near
    assert flips.sum() == 0, np.nonzero(flips)


def _stars(n=2048, seed=18):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(0, 1, n) < 0.9).astype(np.float32)
    born = rng.uniform(0, 1, n) < 0.7
    return {"mask": mask,
            "birth_time": np.where(born, rng.uniform(0.05, 0.2, n),
                                   0.0).astype(np.float32),
            "fb_done": (rng.uniform(0, 1, n) < 0.2).astype(np.float32),
            "m": rng.uniform(1e-4, 2e-4, n).astype(np.float32)}


def test_feedback_firing_energy(models):
    ref, port = models["ref"][3], models["port"][3]
    for f in ("delta_u", "e_per_mass", "snii_delay"):
        assert getattr(ref, f) == getattr(port, f), f
    s = _stars()
    active = np.random.default_rng(19).uniform(0, 1, len(s["m"])) < 0.6
    e_r, f_r = ref.firing_energy({k: jnp.asarray(v) for k, v in s.items()},
                                 jnp.float32(0.21), jnp.asarray(active))
    e_p, f_p = port.firing_energy(
        {k: torch.as_tensor(v) for k, v in s.items()}, 0.21,
        torch.as_tensor(active))
    assert np.asarray(f_r).sum() > 100
    assert np.array_equal(np.asarray(f_r), f_p.numpy())
    assert _rel(e_r, e_p.numpy()) <= 1e-6


def test_enrichment_ejecta(models):
    """Ejected mass, metal mass and element masses of stars of every
    metallicity over age windows from the SNII era to the SNIa era."""
    ref, port = models["ref"][4], models["port"][4]
    assert np.allclose(np.asarray(ref.cum_ej), port.cum_ej, rtol=1e-12)
    rng = np.random.default_rng(20)
    n = 4096
    m = rng.uniform(1e-5, 1e-4, n).astype(np.float32)
    Z = (10.0 ** rng.uniform(-5, -1, n)).astype(np.float32)
    ef = rng.dirichlet(np.ones(9), n).astype(np.float32)
    Gyr = port.Gyr
    t2 = (10.0 ** rng.uniform(-3, 1, n) * Gyr).astype(np.float32)
    t1 = (t2 * rng.uniform(0.5, 1.0, n)).astype(np.float32)
    a = ref.ejecta(*(jnp.asarray(x) for x in (m, Z, ef, t1, t2)))
    b = port.ejecta(*(torch.as_tensor(x) for x in (m, Z, ef, t1, t2)))
    for x, y, name in zip(a, b, ("dm", "dmZ", "delem")):
        x = np.asarray(x)
        assert (x > 0).any(), name
        # a window is the difference of two interpolations of a
        # cumulative table at the dying masses (pow, log10), so their
        # f32 rounding counts relative to the table, not to the window
        assert _rel(x, y.numpy()) <= 1e-5, name


def test_chemistry_particle_arrays():
    ref = ref_chem.EagleChemistry.from_params(
        RefParams(copy.deepcopy(RUN_YML)))
    port = port_chem.EagleChemistry.from_params(
        Params(copy.deepcopy(RUN_YML)))
    assert ref.init_fractions == port.init_fractions
    assert ref.init_metallicity == port.init_metallicity == 0.006
    for x, y in zip(ref.particle_arrays(5), port.particle_arrays(5)):
        assert np.array_equal(x, y)

"""Port vs reference: the SPH schemes and smoothing kernels of K1's modes.

Minimal, Gadget2, Pressure-Energy and Anarchy-PU (and SPHENIX) under the
six smoothing kernels, each through the port's plain torch versions (the
CPU side of the flat kernel's bodies) and the JAX reference on the same
seeded numpy inputs:

* kernels: each ``deval`` on 10^4 points in [0, gamma]: w and dw within
  1e-6 of max |reference| (the same f32 operations);
* pair terms of each scheme on seeded inputs: within 1e-5 of max
  |reference| (rsqrt differs by an ulp between the two libraries, and
  wcount_dh's 3 w + u dw cancels); lifecycle functions within 2e-6 (as
  tests/test_torch_sph.py); a non-trivial cosmology where the function
  takes one;
* loops: each scheme's density, gradient (where it has one) and force
  loop on uniform_box_ic(n=6, jitter=0.15) on a 3 x 3 column grid,
  against ``ops/bruteforce.py`` per particle id (5e-4 of max: N^2 f32
  sums in another order; 2e-3 for the h derivatives, rho_dh, wcount_dh
  and pressure_bar_dh, whose pair term 3 w + u dw cancels: with Wendland
  C6 both sides are ~1e-3 of max from a float64 sum), and each scheme's
  own bodies against the reference's ``hydro_pallas`` loops on
  ``engine="flat"`` in the Pallas interpreter (sums within 5e-5 of max,
  as tests/test_torch_engine.py's loops; maxes within 1e-6 relative);
  the other kernels at the loop level only;
* the whole ``Engine`` on the flat backend, init + 4 steps, against the
  reference Engine per pid (rho, h and u_full within 1e-3 relative,
  a_hydro within 1e-3 of max, as tests/test_torch_engine.py's slice):
  Minimal and Pressure-Energy against its xla backend, Anarchy-PU with
  Wendland C2 and P3M self-gravity (the fused force + gravity body)
  against ``Engine(backend="flat")``; Gadget2 in
  tests/test_torch_sodshock.py;
* refusals: the 27-cell engines and ``MultiEngine`` with a scheme or
  kernel other than SPHENIX's cubic spline, and the unported scheme
  names (the Gizmo schemes); the other six schemes of the reference's
  flat backend build (their own tests: tests/test_torch_sph_more_schemes.py
  and tests/test_torch_planetary.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.grid import bucket_fields as ref_bucket
from swift_subtask_dev_tpu.grid.cellgrid import global_positions
from swift_subtask_dev_tpu.models import gravity as ref_gravity
from swift_subtask_dev_tpu.models.sph import SCHEMES as REF_SCHEMES
from swift_subtask_dev_tpu.models.sph import kernels as ref_kernels
from swift_subtask_dev_tpu.models.sph.sphenix import \
    CosmoFactors as RefCosmo
from swift_subtask_dev_tpu.ops import bruteforce, hydro_pallas
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch.engine_multi import MultiEngine
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
from swift_subtask_dev_tpu_torch.interop import state_from_reference
from swift_subtask_dev_tpu_torch.models import gravity as port_gravity
from swift_subtask_dev_tpu_torch.models.sph import (SCHEME_MODULES, SCHEMES,
                                                    kernels)
from swift_subtask_dev_tpu_torch.models.sph import gadget2
from swift_subtask_dev_tpu_torch.models.sph.sphenix import CosmoFactors
from swift_subtask_dev_tpu_torch.ops import hydro_flat

CPU = torch.device("cpu")
NEW_SCHEMES = ("minimal", "gadget2", "pressure-energy", "anarchy-pu")
KERNEL_NAMES = tuple(kernels.KERNELS)
# a cosmology with every factor away from 1 (python floats, as both
# engines take them)
COSMO = dict(a=0.5, H=1.3, a_inv2=4.0, fac_mu=0.7,
             a_factor_sound_speed=1.2, a_factor_Balsara_eps=0.9,
             a_factor_internal_energy=1.1)
NO_COSMO = dict(a=1.0, H=0.0, a_inv2=1.0, fac_mu=1.0,
                a_factor_sound_speed=1.0, a_factor_Balsara_eps=1.0,
                a_factor_internal_energy=1.0)


def _params(scheme, kernel="cubic-spline", **kw):
    return (REF_SCHEMES[scheme](kernel=ref_kernels.KERNELS[kernel], **kw),
            SCHEMES[scheme](kernel=kernels.KERNELS[kernel], **kw))


def _rel_max(ref, got):
    """max |got - ref| / max |ref| over the finite entries (both finite
    at the same places)."""
    a = np.asarray(ref, np.float64)
    b = (got.cpu().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got)).astype(np.float64)
    assert a.shape == b.shape
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    scale = np.max(np.abs(a[fin]), initial=0.0) + 1e-30
    return np.max(np.abs(a[fin] - b[fin]), initial=0.0) / scale


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_deval_matches_reference(name):
    kr, kp = ref_kernels.KERNELS[name], kernels.KERNELS[name]
    rng = np.random.default_rng(11)
    u = np.concatenate([np.linspace(0.0, kr.gamma, 5000),
                        rng.uniform(0.0, kr.gamma, 5000)]).astype(np.float32)
    wr, dr = kr.deval(jnp.asarray(u))
    wp, dp = kp.deval(torch.from_numpy(u))
    assert _rel_max(wr, wp) <= 1e-6          # the same f32 operations
    assert _rel_max(dr, dp) <= 1e-6
    for attr in ("gamma", "gamma2", "gamma_inv", "root", "norm"):
        assert getattr(kp, attr) == pytest.approx(getattr(kr, attr),
                                                  rel=1e-15)
    assert kernels.kernel_name(kp) == name


# ---------------------------------------------------------------------------
# pair terms and lifecycle functions
# ---------------------------------------------------------------------------

def _pair_inputs(seed=1, n=4096):
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, n).astype(np.float32)

    dx = [rng.normal(0, 0.05, n).astype(np.float32) for _ in range(3)]
    for d in dx:
        d[:16] = 0.0                       # r2 == 0 (self) pairs
    r2 = (dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]).astype(np.float32)
    h_i, h_j = u(0.05, 0.12), u(0.05, 0.12)
    m_i, m_j = u(0.5, 1.5), u(0.5, 1.5)
    rho_i, rho_j = u(0.5, 2), u(0.5, 2)
    P_i, P_j = u(0.3, 2), u(0.3, 2)
    return [dx, r2, 1 / h_i, 1 / h_j, m_i, m_j, 1 / m_i, 1 / m_j,
            [u(-1, 1) for _ in range(3)], rho_i, rho_j, 1 / rho_i,
            1 / rho_j, P_i / rho_i ** 2, P_j / rho_j ** 2, P_i, P_j,
            u(0.8, 1.5), u(0.8, 1.5), u(-0.1, 0.1), u(-0.1, 0.1),
            u(0, 1), u(0, 1), u(0, 1), u(0, 1), u(0, 0.5), u(0, 0.5),
            u(0.5, 2), u(0.5, 2)]


def _conv(x, to):
    if isinstance(x, list):
        return tuple(_conv(v, to) for v in x)
    x = np.asarray(x, np.float32)
    return jnp.asarray(x) if to == "jax" else torch.from_numpy(x.copy())


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _terms(mod, p, name, to, cosmo, needs_u):
    a = _conv(_pair_inputs(), to)
    if name == "density":
        args = (a[0], a[1], a[2], a[5], a[8])
        if needs_u:
            args += (a[28],)
        return mod.density_terms(p, *args)
    if name == "gradient":
        return mod.gradient_terms(p, a[0], a[1], a[2], a[5], a[8], a[27],
                                  a[28], a[12], a[17], a[18], a[24],
                                  cosmo)
    return mod.force_terms(p, *a, cosmo)


TERM_CASES = [(s, k, t) for s in NEW_SCHEMES
              for k in ("cubic-spline", "wendland-C2")
              for t in ("density", "gradient", "force")
              if t != "gradient" or s == "anarchy-pu"]


@pytest.mark.parametrize("scheme,kernel,name", TERM_CASES)
def test_pair_terms_match(scheme, kernel, name):
    pr, pp = _params(scheme, kernel)
    needs_u = pp.mod.DENSITY_NEEDS_U
    out_r = _flatten(_terms(pr.mod, pr, name, "jax", RefCosmo(**COSMO),
                            needs_u))
    out_p = _flatten(_terms(pp.mod, pp, name, "torch",
                            CosmoFactors(**COSMO), needs_u))
    assert out_r.keys() == out_p.keys()
    for k in out_r:
        assert _rel_max(out_r[k], out_p[k]) <= 1e-5, k


SHAPE = (6, 128)


def _state(seed=0):
    """A tiled gas state with plausible values and some empty slots."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape=SHAPE):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    mask = (rng.uniform(size=SHAPE) > 0.2).astype(np.float32)
    s = {
        "mask": mask, "h": u(0.05, 0.11) * mask, "m": u(0.5, 1.5) * 1e-3,
        "rho": u(0.5, 2.0), "rho_dh": u(-50, -5), "wcount": u(300, 900),
        "wcount_dh": u(-2e4, -1e3), "div_v": u(-2, 2),
        "rot_v": u(-1, 1, SHAPE + (3,)), "u": u(0.5, 2.0),
        "u_full": u(0.5, 2.0), "u_dt": u(-5, 5), "h_dt": u(-0.5, 0.5),
        "v_sig": u(1, 3), "div_v_prev": u(-2, 2), "laplace_u": u(-30, 30),
        "alpha_visc": u(0.0, 1.0), "alpha_diff": u(0.0, 0.5),
        "alpha_visc_max_ngb": u(0.0, 1.5), "soundspeed": u(0.8, 1.5),
        "a_hydro": u(-1, 1, SHAPE + (3,)), "v": u(-1, 1, SHAPE + (3,)),
        "v_full": u(-1, 1, SHAPE + (3,)), "pressure_bar": u(0.2, 2.0),
        "pressure_bar_dh": u(-40, -2),
    }
    s["h_dt"][:, :5] = 0.0
    s["wcount"][0, :7] = 0.0               # no-neighbour fallback rows
    return s


LIFECYCLE = [
    ("end_density", lambda m, P, s, c: m.end_density(P, s, c)),
    ("prepare_gradient", lambda m, P, s, c: m.prepare_gradient(P, s, c)),
    ("reset_gradient", lambda m, P, s, c: m.reset_gradient(s)),
    ("end_gradient", lambda m, P, s, c: m.end_gradient(s)),
    ("prepare_force_dt0", lambda m, P, s, c: m.prepare_force(P, s, c, 0.0)),
    ("prepare_force", lambda m, P, s, c: m.prepare_force(
        P, s, c, s["u_full"] * 1e-3)),
    ("reset_acceleration", lambda m, P, s, c: m.reset_acceleration(s)),
    ("end_force", lambda m, P, s, c: m.end_force(P, s)),
    ("predict_extra", lambda m, P, s, c: m.predict_extra(P, s, c, 2e-4,
                                                         2e-4)),
    ("reset_predicted_values",
     lambda m, P, s, c: m.reset_predicted_values(P, s)),
    ("kick_extra", lambda m, P, s, c: m.kick_extra(P, s, c, 1e-4)),
    ("compute_timestep",
     lambda m, P, s, c: {"dt": m.compute_timestep(P, s, c)}),
    ("timestep_h_change_limit",
     lambda m, P, s, c: {"dt": m.timestep_h_change_limit(P, s)}),
    ("no_neighbours_fallback",
     lambda m, P, s, c: m.no_neighbours_fallback(P, s)),
    ("init_part", lambda m, P, s, c: m.init_part(s)),
]


@pytest.mark.parametrize("scheme", NEW_SCHEMES)
@pytest.mark.parametrize("name,fn", LIFECYCLE, ids=[n for n, _ in LIFECYCLE])
def test_lifecycle_matches(scheme, name, fn):
    pr, pp = _params(scheme, "wendland-C4", h_max=0.1,
                     minimal_internal_energy=0.6)
    s = _state()
    out_r = fn(pr.mod, pr, {k: jnp.asarray(v) for k, v in s.items()},
               RefCosmo(**COSMO))
    out_p = fn(pp.mod, pp, {k: torch.from_numpy(v.copy())
                            for k, v in s.items()}, CosmoFactors(**COSMO))
    assert set(out_r) == set(out_p)
    for k in out_r:
        assert _rel_max(out_r[k], out_p[k]) <= 2e-6, (name, k)


def test_gadget2_entropy_conversions_match():
    pr, pp = _params("gadget2")
    rng = np.random.default_rng(3)
    rho = rng.uniform(0.1, 2.0, 1000).astype(np.float32)
    u = rng.uniform(0.1, 3.0, 1000).astype(np.float32)
    from swift_subtask_dev_tpu.models.sph import gadget2 as ref_g2
    A_r = ref_g2.entropy_from_internal_energy(pr, jnp.asarray(rho),
                                              jnp.asarray(u))
    A_p = gadget2.entropy_from_internal_energy(pp, rho, u)
    assert _rel_max(A_r, A_p) <= 2e-6
    u_r = ref_g2.internal_energy_from_entropy(pr, jnp.asarray(rho), A_r)
    u_p = gadget2.internal_energy_from_entropy(pp, rho, A_p)
    assert _rel_max(u_r, u_p) <= 2e-6
    assert np.allclose(u_p.numpy(), u, rtol=1e-5)


# ---------------------------------------------------------------------------
# loops: the plain versions of K1's modes against hydro_pallas (flat, in
# the interpreter) and the brute force
# ---------------------------------------------------------------------------

# (scheme, kernel, the loops held against the reference's flat loops too:
# each scheme's own bodies; SPHENIX's density and gradient, which Minimal,
# Gadget2 and Anarchy-PU take, are held by tests/test_torch_pair_flat.py,
# Gadget2's and Anarchy-PU + Wendland C2's flat loops by the engine
# comparisons on the reference's flat backend)
LOOP_CASES = ([("minimal", "cubic-spline", ("force",)),
               ("gadget2", "cubic-spline", ()),
               ("pressure-energy", "cubic-spline", ("density", "force")),
               ("anarchy-pu", "cubic-spline", ("force",))]
              + [("anarchy-pu", k, ()) for k in KERNEL_NAMES
                 if k != "cubic-spline"]
              + [("sphenix", "quintic-spline", ())])
LOOP_IDS = [f"{s}-{k}" for s, k, _ in LOOP_CASES]


@pytest.fixture(scope="module")
def loop_state():
    """uniform_box_ic(n=6, jitter=0.15) bucketed by the reference on a
    3 x 3 column grid, with seeded per-particle hydro fields; h at 0.8 of
    the IC's so that every kernel's reach (gamma h) fits the columns."""
    ic = uniform_box_ic(n=6, jitter=0.15, seed=3)
    n = len(ic["pos"])
    rng = np.random.default_rng(0)

    def u(lo, hi):
        return rng.uniform(lo, hi, n).astype(np.float32)

    h = (0.8 * ic["h"] * u(0.9, 1.0)).astype(np.float32)
    fields = {
        "m": ic["m"], "v": rng.normal(0, 0.3, (n, 3)).astype(np.float32),
        "h": h, "u": u(0.8, 1.2), "rho": u(0.9, 1.1),
        "pressure": u(0.5, 0.7), "soundspeed": u(0.9, 1.0),
        "f_gradh": u(-0.05, 0.05), "balsara": u(0.0, 0.8),
        "alpha_visc": u(0.1, 0.8), "alpha_diff": u(0.0, 0.3),
        "v_sig": u(1.5, 2.0), "alpha_visc_max_ngb": u(0.0, 0.5),
        "time_bin": rng.integers(1, 6, n).astype(np.int32),
        "pid": np.arange(n, dtype=np.int32),
    }
    g_ref = RefGrid.build_columns(ic["box"], 1.0 / 3.0, ic["pos"])
    assert g_ref.cdim == (3, 3, 1)
    assert float(h.max()) * ref_kernels.WENDLAND_C6.gamma < min(g_ref.edge)
    out, mask, off, n_over = ref_bucket(
        g_ref, jnp.asarray(ic["pos"]),
        {k: jnp.asarray(v) for k, v in fields.items()}, zsort=True)
    assert int(n_over) == 0
    s = {"mask": np.asarray(mask), "off": np.asarray(off),
         **{k: np.asarray(x) for k, x in out.items()}}
    live = s["mask"].reshape(-1) > 0
    pos = global_positions(g_ref, s["off"]).reshape(-1, 3)[live]
    return {"g_ref": g_ref, "g_port": CellGrid(g_ref.box, g_ref.cdim,
                                               g_ref.K),
            "s": s, "live": live, "pos": pos, "box": ic["box"]}


def _flat(x, live):
    """(C, K, ...) -> the live slots' (N, ...)."""
    x = np.asarray(x)
    return x.reshape((-1,) + x.shape[2:])[live]


def _loop_inputs(ls):
    s = ls["s"]
    return ({k: jnp.asarray(v) for k, v in s.items()},
            state_from_reference(s, CPU))


_LOOP_CACHE = {}


def _loops(ls, scheme, kernel, with_flat):
    """{loop: (reference flat or None, brute force, port)} per case;
    the reference's flat loops for the loops in ``with_flat``."""
    key = (scheme, kernel)
    if key in _LOOP_CACHE:
        return _LOOP_CACHE[key]
    pr, pp = _params(scheme, kernel)
    sj, st = _loop_inputs(ls)
    cr, cp = RefCosmo(**COSMO), CosmoFactors(**COSMO)
    g_ref, g_port, live = ls["g_ref"], ls["g_port"], ls["live"]
    s = ls["s"]

    def fl(name):
        return jnp.asarray(_flat(s[name], live))

    pos = jnp.asarray(ls["pos"], jnp.float32)
    out = {}
    out["density"] = (
        hydro_pallas.density_loop(g_ref, sj, pr, interpret=True,
                                  engine="flat")
        if "density" in with_flat else None,
        bruteforce.density_bruteforce(pr, pos, fl("h"), fl("m"), fl("v"),
                                      box=ls["box"], u=fl("u")),
        hydro_flat.density_loop(g_port, st, pp))
    if pp.mod.HAS_GRADIENT_LOOP:
        out["gradient"] = (
            hydro_pallas.gradient_loop(g_ref, sj, pr, cr, interpret=True,
                                       engine="flat")
            if "gradient" in with_flat else None,
            bruteforce.gradient_bruteforce(
                pr, pos, fl("h"), fl("m"), fl("v"), fl("u"), fl("rho"),
                fl("soundspeed"), fl("alpha_visc"), fl("v_sig"),
                fl("alpha_visc_max_ngb"), cr, box=ls["box"]),
            hydro_flat.gradient_loop(g_port, st, pp, cp))
    out["force"] = (
        hydro_pallas.force_loop(g_ref, sj, pr, cr, interpret=True,
                                engine="flat")
        if "force" in with_flat else None,
        bruteforce.force_bruteforce(
            pr, pos, fl("h"), fl("m"), fl("v"), fl("rho"), fl("pressure"),
            fl("soundspeed"), fl("f_gradh"), fl("balsara"),
            fl("alpha_visc"), fl("alpha_diff"), fl("u"), fl("v_sig"), cr,
            box=ls["box"]),
        hydro_flat.force_loop(g_port, st, pp, cp))
    _LOOP_CACHE[key] = out
    return out


LOOP_TESTS = [(s, k, f, loop) for s, k, f in LOOP_CASES
              for loop in ("density", "gradient", "force")
              if loop != "gradient" or s in ("anarchy-pu", "sphenix")]


@pytest.mark.parametrize("scheme,kernel,with_flat,loop", LOOP_TESTS,
                         ids=[f"{s}-{k}-{lp}" for s, k, _, lp in LOOP_TESTS])
def test_loop_matches_reference_and_bruteforce(loop_state, scheme, kernel,
                                               with_flat, loop):
    ref_flat, brute, port = _loops(loop_state, scheme, kernel,
                                   with_flat)[loop]
    live = loop_state["live"]
    assert set(brute) <= set(port)
    for k in port:
        if k == "min_ngb_time_bin":
            if ref_flat is not None:
                assert np.array_equal(np.asarray(ref_flat[k]),
                                      port[k].numpy())
            continue
        is_max = k in ("v_sig", "alpha_visc_max_ngb")
        if ref_flat is not None:
            a = np.asarray(ref_flat[k])
            b = port[k].numpy()
            if is_max:       # maxes: the same pair values, 1e-6 relative
                assert np.allclose(b, a, rtol=1e-6, atol=0.0), k
            else:            # sums: 5e-5 of max (summation order)
                assert _rel_max(a, b) <= 5e-5, k
        if k in brute:       # all pairs, in float32
            tol = 2e-3 if k.endswith("_dh") else 5e-4
            assert _rel_max(np.asarray(brute[k]),
                            _flat(port[k].numpy(), live)) <= tol, k
    if loop == "density":
        assert set(SCHEME_MODULES[scheme].DENSITY_EXTRA_KEYS) <= set(brute)


# ---------------------------------------------------------------------------
# the engine: init + 4 steps against the reference Engine
# ---------------------------------------------------------------------------

N_STEPS = 4
# (scheme, kernel, n, self-gravity, the reference's backend): n keeps
# gamma h within the 3 x 3 columns for the kernel.  The reference's flat
# Engine compiles its Pallas interpreter for the init pass and the step
# (~45 s each here), its xla Engine in ~4 s: the schemes without gravity
# are held against the xla Engine on its 27-cell grid, Anarchy-PU with
# Wendland C2 and P3M against the flat one (the reference's two backends
# differ by ~2% of max in a_grav on this P3M setup).  Gadget2's engine is
# held on the flat backend by tests/test_torch_sodshock.py.
ENGINE_CASES = [("minimal", "cubic-spline", 6, False, "xla"),
                ("pressure-energy", "cubic-spline", 6, False, "xla"),
                ("anarchy-pu", "wendland-C2", 7, True, "flat")]


def _engine_setup(pkg_grid, pkg_gravity, pkg_engine, P, n, gravity,
                  backend, **dev):
    """The engine on ``backend``: "flat" on the column grid (the port),
    "xla" on the reference's 27-cell grid."""
    ic = uniform_box_ic(n=n, jitter=0.15, seed=3)
    reach = float(ic["h"].max() * P.kernel.gamma * 1.25)
    gp = pkg_gravity.GravityParams(G=1.0, eps=0.5 / n, mesh_N=32)
    if gravity:
        reach = max(reach, 1.15 * gp.r_cut_ratio * gp.a_smooth / gp.mesh_N)
    if backend == "flat":
        grid = pkg_grid.build_columns(ic["box"], interaction_range=reach,
                                      pos=ic["pos"])
    else:
        grid = pkg_grid.build(ic["box"], reach, len(ic["pos"]))
    if not gravity:
        cfg = pkg_engine.EngineConfig(dt_max=5e-4, backend=backend)
        eng = pkg_engine.Engine(grid, P, cfg, 0.0, 1.0, **dev)
    else:
        solver = pkg_gravity.GravitySolver(gp, grid, **dev)
        cfg = pkg_engine.EngineConfig(
            dt_max=2e-4, with_self_gravity=True, eps_soft=gp.eps,
            eta_grav=gp.eta, mesh_dt_max=64 * 2e-4,
            p2p_reach=solver.pm.r_cut, backend=backend)
        eng = pkg_engine.Engine(grid, P, cfg, 0.0, 1.0,
                                gravity_fn=solver.gas_short_range_fn(),
                                mesh_fn=solver.gas_mesh_fn(),
                                mesh_dt_scale=solver.pm.r_s, **dev)
        eng.solver_builder = lambda g: pkg_gravity.GravitySolver(gp, g,
                                                                 **dev)
    eng.load_particles(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
    return eng


def _np_state(state):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).copy() for k, v in state.items()}


@pytest.fixture(scope="module", params=ENGINE_CASES,
                ids=[f"{s}-{k}{'-p3m' if g else ''}"
                     for s, k, _, g, _ in ENGINE_CASES])
def engine_runs(request):
    scheme, kernel, n, gravity, ref_backend = request.param
    pr, pp = _params(scheme, kernel, h_max=0.4)
    runs = {}
    for name, P, grid, grav, eng_mod, backend, dev in (
            ("ref", pr, RefGrid, ref_gravity, ref_engine, ref_backend, {}),
            ("port", pp, CellGrid, port_gravity, port_engine, "flat",
             {"device": CPU})):
        eng = _engine_setup(grid, grav, eng_mod, P, n, gravity, backend,
                            **dev)
        eng.init_particles()
        init = _np_state(eng.state)
        for _ in range(N_STEPS):
            eng.step()
        runs[name] = {"init": init, "final": _np_state(eng.state),
                      "steps": eng.step_count}
    return request.param, runs


def _perpid(s, x):
    pid = s["pid"].ravel()
    m = s["mask"].ravel() > 0
    x = np.asarray(x)
    x = x.reshape((-1,) + x.shape[2:])[m]
    return x[np.argsort(pid[m])]


@pytest.mark.parametrize("when", ["init", "final"])
def test_engine_matches_reference_per_pid(engine_runs, when):
    (scheme, kernel, n, gravity, _), runs = engine_runs
    r, p = runs["ref"][when], runs["port"][when]
    assert np.array_equal(np.sort(_perpid(r, r["pid"])),
                          np.sort(_perpid(p, p["pid"])))
    keys = ["rho", "h", "u_full"]
    if SCHEME_MODULES[scheme].DENSITY_NEEDS_U:
        keys.append("pressure_bar")
    for k in keys:
        a, b = _perpid(r, r[k]), _perpid(p, p[k])
        assert np.max(np.abs(b - a) / np.abs(a)) <= 1e-3, k
    for k in ("a_hydro",) + (("a_grav",) if gravity else ()):
        assert _rel_max(_perpid(r, r[k]), _perpid(p, p[k])) <= 1e-3, k
    assert np.array_equal(_perpid(r, r["time_bin"]),
                          _perpid(p, p["time_bin"]))
    assert all(np.all(np.isfinite(v)) for v in p.values()
               if np.asarray(v).dtype.kind == "f")


def test_engine_takes_the_steps(engine_runs):
    _, runs = engine_runs
    assert runs["ref"]["steps"] == runs["port"]["steps"] == N_STEPS


def test_state_from_reference_carries_the_scheme_state(engine_runs):
    (scheme, _, _, _, _), runs = engine_runs
    ref = runs["ref"]["final"]
    st = state_from_reference(ref, CPU)
    keys = SCHEME_MODULES[scheme].EXTRA_STATE_KEYS
    assert set(keys) <= set(runs["port"]["final"])
    for k in keys:
        assert np.array_equal(st[k].numpy(), ref[k]), k


# ---------------------------------------------------------------------------
# modes and refusals
# ---------------------------------------------------------------------------

def test_sph_mode_names():
    assert hydro_flat.sph_mode(SCHEMES["sphenix"]()) == ""
    assert hydro_flat.sph_mode(SCHEMES["minimal"](
        kernel=kernels.WENDLAND_C2)) == "minimal/wendland-C2"
    assert hydro_flat.sph_mode(SCHEMES["sphenix"](
        kernel=kernels.QUARTIC_SPLINE)) == "sphenix/quartic-spline"


@pytest.mark.parametrize("name", ["gizmo-mfm", "gizmo-mfv"])
def test_unported_scheme_names_raise(name):
    with pytest.raises(NotImplementedError, match=f"'{name}' is not "
                       "ported yet"):
        SCHEMES[name]
    with pytest.raises(KeyError, match="unknown SPH scheme"):
        SCHEMES["no-such-scheme"]


@pytest.mark.parametrize("name", ["pressure-entropy", "phantom", "gasoline",
                                  "none", "planetary",
                                  "pressure-energy-monaghan"])
def test_flat_schemes_build_their_params_and_mode(name):
    """Every scheme the reference runs on its flat backend is registered:
    its params build and name their module, and each kernel gives it a
    mode of K1."""
    P = SCHEMES[name]()
    assert P.mod is SCHEME_MODULES[name] and P.mod.NAME == name
    assert hydro_flat.sph_mode(P) == f"{name}/cubic-spline"
    assert hydro_flat.sph_mode(SCHEMES[name](
        kernel=kernels.WENDLAND_C2)) == f"{name}/wendland-C2"


@pytest.mark.parametrize("backend", ["pallas", "pallas_ring"])
@pytest.mark.parametrize("scheme,kernel", [("minimal", "cubic-spline"),
                                           ("sphenix", "wendland-C2"),
                                           ("gasoline", "cubic-spline")])
def test_27_cell_backends_refuse_other_modes(backend, scheme, kernel):
    _, pp = _params(scheme, kernel)
    grid = CellGrid(box=(1.0, 1.0, 1.0), cdim=(3, 3, 3), K=64)
    with pytest.raises(NotImplementedError, match=f"'{scheme}'"):
        port_engine.Engine(grid, pp, port_engine.EngineConfig(
            backend=backend), 0.0, 1.0, device=CPU)


@pytest.mark.parametrize("engine", ["packed", "ring"])
def test_27_cell_loops_refuse_other_modes(loop_state, engine):
    _, pp = _params("gadget2")
    st = state_from_reference(loop_state["s"], CPU)
    with pytest.raises(NotImplementedError, match="gadget2/cubic-spline"):
        hydro_flat.density_loop(loop_state["g_port"], st, pp, engine=engine)


@pytest.mark.parametrize("scheme,kernel", [("anarchy-pu", "cubic-spline"),
                                           ("sphenix", "wendland-C6"),
                                           ("phantom", "cubic-spline")])
def test_multi_engine_refuses_other_modes(scheme, kernel):
    _, pp = _params(scheme, kernel)
    grid = CellGrid(box=(1.0, 1.0, 1.0), cdim=(3, 3, 1), K=128)
    with pytest.raises(NotImplementedError, match="MultiEngine"):
        MultiEngine(grid, pp, port_engine.EngineConfig(), 0.0, 1.0,
                    device=CPU)


def test_schemes_without_gradient_loop_refuse_the_gradient_pass(loop_state):
    st = state_from_reference(loop_state["s"], CPU)
    for scheme, mod in SCHEME_MODULES.items():
        if mod.HAS_GRADIENT_LOOP:
            continue
        _, pp = _params(scheme)
        with pytest.raises(ValueError, match="no gradient loop"):
            hydro_flat.gradient_pass(st, pp, CosmoFactors(**NO_COSMO))

"""Port vs reference: Pressure-Entropy, Pressure-Energy-Monaghan, Phantom,
Gasoline and None as K1's modes.

Each scheme through the port's plain torch versions (the CPU side of the
flat kernel's bodies) and the JAX reference on the same seeded numpy
inputs:

* pair terms (density, gradient where the scheme has one, force) under
  the cubic spline and Wendland C2, with a cosmology whose factors are
  all away from 1: within 1e-5 of max |reference| (rsqrt differs by an
  ulp between the two libraries, and the kick 3 w + u dw cancels);
* lifecycle hooks on a tiled state with empty slots: within 1e-6 of max
  |reference| (the same f32 operations);
* each scheme's own loops on uniform_box_ic(n=6, jitter=0.15) on a 3 x 3
  column grid (Pressure-Entropy's density and force, Pressure-Energy-
  Monaghan's force, Phantom's gradient and force, Gasoline's density,
  gradient and force, None's force) against the reference's
  ``hydro_pallas`` loops on ``engine="flat"`` in the Pallas interpreter
  and against ``ops/bruteforce.py`` per particle id: sums within 1e-5 of
  max, maxes within 1e-6 relative; the h derivatives' pair term 3 w +
  u dw cancels, so against the brute force (N^2 f32 sums in another
  order) they are held within the 2e-3 of max of
  tests/test_torch_sph_schemes.py;
* the whole ``Engine`` on the flat backend, init + 4 steps, against the
  reference Engine per pid (rho, h and u_full within 1e-3 relative,
  a_hydro within 1e-3 of max, the time bins equal): Gasoline against
  the reference's flat Engine (its gradient's j-side fields are the flat
  path's risk), the others against its xla Engine; for None, a_hydro and
  u_dt exactly 0 and u_full unchanged.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.grid import bucket_fields as ref_bucket
from swift_subtask_dev_tpu.grid.cellgrid import global_positions
from swift_subtask_dev_tpu.models.sph import SCHEMES as REF_SCHEMES
from swift_subtask_dev_tpu.models.sph import kernels as ref_kernels
from swift_subtask_dev_tpu.models.sph.sphenix import \
    CosmoFactors as RefCosmo
from swift_subtask_dev_tpu.ops import bruteforce, hydro_pallas
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
from swift_subtask_dev_tpu_torch.interop import state_from_reference
from swift_subtask_dev_tpu_torch.models.sph import (SCHEME_MODULES, SCHEMES,
                                                    kernels, u_is_entropy)
from swift_subtask_dev_tpu_torch.models.sph.sphenix import CosmoFactors
from swift_subtask_dev_tpu_torch.ops import hydro_flat, pair_flat

CPU = torch.device("cpu")
NEW_SCHEMES = ("pressure-entropy", "pressure-energy-monaghan", "phantom",
               "gasoline", "none")
COSMO = dict(a=0.5, H=1.3, a_inv2=4.0, fac_mu=0.7,
             a_factor_sound_speed=1.2, a_factor_Balsara_eps=0.9,
             a_factor_internal_energy=1.1)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """torch on two threads (several test workers share the cores; the
    reference's XLA runs its own pool beside it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def test_protocol_is_declared_in_full():
    """Each new module declares the scheme protocol, its lists as the
    reference's (its defaults where the reference has none)."""
    from swift_subtask_dev_tpu.models.sph import (gasoline, none, phantom,
                                                  pressure_energy_mm,
                                                  pressure_entropy)
    defaults = {"DENSITY_NEEDS_U": False, "DENSITY_EXTRA_KEYS": (),
                "EXTRA_STATE_KEYS": (), "EXTRA_STATE_INT_KEYS": (),
                "GRADIENT_J_EXTRA": (), "GRADIENT_SUM_KEYS": ("laplace_u",),
                "PREPARE_GRADIENT_KEYS": ("f_gradh", "pressure",
                                          "soundspeed", "balsara"),
                "GRADIENT_END_KEYS": ("laplace_u",),
                "PREPARE_FORCE_KEYS": ("alpha_visc", "div_v_prev",
                                       "alpha_diff")}
    for name, ref in (("pressure-entropy", pressure_entropy),
                      ("pressure-energy-monaghan", pressure_energy_mm),
                      ("phantom", phantom), ("gasoline", gasoline),
                      ("none", none)):
        assert REF_SCHEMES[name]().mod is ref
        mod = SCHEME_MODULES[name]
        assert mod.NAME == name
        assert mod.HAS_GRADIENT_LOOP == ref.HAS_GRADIENT_LOOP
        for key, default in defaults.items():
            assert getattr(mod, key) == getattr(ref, key, default), \
                (name, key)
        assert pair_flat.SCHEME_STRUCTS[name] == mod.CUDA_STRUCT


@pytest.mark.parametrize("scheme", tuple(SCHEME_MODULES))
def test_u_is_entropy_as_the_reference(scheme):
    """A scheme's u slot holds the entropy where the reference's module
    carries the conversions (Gadget2, Pressure-Entropy); there the port's
    conversions match the reference's within 1e-6 relative and round
    trip."""
    pr, pp = _params(scheme)
    entropy = u_is_entropy(pp)
    assert entropy == hasattr(pr.mod, "entropy_from_internal_energy")
    assert entropy == (scheme in ("gadget2", "pressure-entropy"))
    if not entropy:
        return
    rng = np.random.default_rng(5)
    rho = rng.uniform(0.1, 2.0, 64).astype(np.float32)
    u = rng.uniform(0.5, 3.0, 64).astype(np.float32)
    A = pp.mod.entropy_from_internal_energy(pp, rho, u)
    A_ref = pr.mod.entropy_from_internal_energy(pr, jnp.asarray(rho),
                                                jnp.asarray(u))
    assert np.max(np.abs(A.numpy() - np.asarray(A_ref))
                  / np.abs(np.asarray(A_ref))) <= 1e-6
    back = pp.mod.internal_energy_from_entropy(pp, torch.as_tensor(rho), A)
    assert np.max(np.abs(back.numpy() - u) / u) <= 1e-6


# ---------------------------------------------------------------------------
# pair terms and lifecycle hooks
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
    tensor = u(0.0, 2.0)
    tensor[::5] = 0.0                      # the shock ratio's zero branch
    return [dx, r2, 1 / h_i, 1 / h_j, m_i, m_j, 1 / m_i, 1 / m_j,
            [u(-1, 1) for _ in range(3)], rho_i, rho_j, 1 / rho_i,
            1 / rho_j, P_i / rho_i ** 2, P_j / rho_j ** 2, P_i, P_j,
            u(0.8, 1.5), u(0.8, 1.5), u(-0.1, 0.1), u(-0.1, 0.1),
            u(0, 1), u(0, 1), u(0, 1), u(0, 1), u(0, 0.5), u(0, 0.5),
            u(0.5, 2), u(0.5, 2), u(-3, 3), u(-3, 3), u(0.0, 2.0), tensor]


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


def _terms(mod, p, name, to, cosmo, proto):
    """``mod``'s pair terms ``name`` on the seeded inputs; ``proto`` (the
    port's module) says which optional arguments the scheme takes."""
    a = _conv(_pair_inputs(), to)
    if name == "density":
        args = (a[0], a[1], a[2], a[5], a[8])
        if proto.DENSITY_NEEDS_U:
            args += (a[28],)
        return mod.density_terms(p, *args)
    if name == "gradient":
        extra = (a[29], a[30], a[31], a[32]) if proto.GRADIENT_J_EXTRA \
            else ()
        return mod.gradient_terms(p, a[0], a[1], a[2], a[5], a[8], a[27],
                                  a[28], a[12], a[17], a[18], a[24],
                                  *extra, cosmo)
    return mod.force_terms(p, *a[:29], cosmo)


TERM_CASES = [(s, k, t) for s in NEW_SCHEMES
              for k in ("cubic-spline", "wendland-C2")
              for t in ("density", "gradient", "force")
              if t != "gradient" or SCHEME_MODULES[s].HAS_GRADIENT_LOOP]


@pytest.mark.parametrize("scheme,kernel,name", TERM_CASES)
def test_pair_terms_match(scheme, kernel, name):
    pr, pp = _params(scheme, kernel)
    out_r = _flatten(_terms(pr.mod, pr, name, "jax", RefCosmo(**COSMO),
                            pp.mod))
    out_p = _flatten(_terms(pp.mod, pp, name, "torch",
                            CosmoFactors(**COSMO), pp.mod))
    assert out_r.keys() == out_p.keys()
    for k in out_r:
        assert _rel_max(out_r[k], out_p[k]) <= 1e-5, k


SHAPE = (6, 128)
_VGRAD = tuple(f"vgrad{i}{j}" for i in range(3) for j in range(3))


def _state(seed=0):
    """A tiled gas state with plausible values, some empty slots, and
    every new scheme's own keys."""
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
        "balsara": u(0.0, 1.0), "pressure": u(0.3, 2.0),
        "f_gradh": u(-0.05, 0.05),
        "a_hydro": u(-1, 1, SHAPE + (3,)), "v": u(-1, 1, SHAPE + (3,)),
        "v_full": u(-1, 1, SHAPE + (3,)), "pressure_bar": u(0.2, 2.0),
        "pressure_bar_dh": u(-40, -2), "rho_bar": u(0.5, 2.0),
        "rho_bar_dh": u(-50, -5),
        "grad_P0": u(-3, 3), "grad_P1": u(-3, 3), "grad_P2": u(-3, 3),
        "weighted_wcount": u(-60, -10), "shock_limiter": u(0, 2),
        "wncount_ngb": u(-60, -10), "shock_indicator": u(-5, 5),
        "tensor_norm": u(0, 5), "shock_indicator_prev": u(-5, 5),
    }
    for k in _VGRAD:
        s[k] = u(-3, 3)
    s["h_dt"][:, :5] = 0.0
    s["wcount"][0, :7] = 0.0               # no-neighbour fallback rows
    s["weighted_wcount"][1, :5] = 0.0      # Gasoline's ww == 0 branch
    s["wncount_ngb"][2, :5] = 0.0          # and its f = 1 branch
    return s


LIFECYCLE = [
    ("end_density", lambda m, P, s, c: m.end_density(P, s, c)),
    ("no_neighbours_fallback",
     lambda m, P, s, c: m.no_neighbours_fallback(P, s)),
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
        assert _rel_max(out_r[k], out_p[k]) <= 1e-6, (name, k)


# ---------------------------------------------------------------------------
# loops: the plain versions of the new modes against hydro_pallas (flat, in
# the interpreter) and the brute force
# ---------------------------------------------------------------------------

LOOP_CASES = [("pressure-entropy", "density"), ("pressure-entropy", "force"),
              ("pressure-energy-monaghan", "force"), ("phantom", "gradient"),
              ("phantom", "force"), ("gasoline", "density"),
              ("gasoline", "gradient"), ("gasoline", "force"),
              ("none", "force")]


@pytest.fixture(scope="module")
def loop_state():
    """uniform_box_ic(n=6, jitter=0.15) bucketed by the reference on a
    3 x 3 column grid, with seeded per-particle hydro fields (Gasoline's
    shock indicator and shear norm among them)."""
    ic = uniform_box_ic(n=6, jitter=0.15, seed=3)
    n = len(ic["pos"])
    rng = np.random.default_rng(0)

    def u(lo, hi):
        return rng.uniform(lo, hi, n).astype(np.float32)

    tensor = u(0.0, 2.0)
    tensor[::7] = 0.0
    fields = {
        "m": ic["m"], "v": rng.normal(0, 0.3, (n, 3)).astype(np.float32),
        "h": (0.8 * ic["h"] * u(0.9, 1.0)).astype(np.float32),
        "u": u(0.8, 1.2), "rho": u(0.9, 1.1),
        "pressure": u(0.5, 0.7), "soundspeed": u(0.9, 1.0),
        "f_gradh": u(-0.05, 0.05), "balsara": u(0.0, 0.8),
        "alpha_visc": u(0.1, 0.8), "alpha_diff": u(0.0, 0.3),
        "v_sig": u(1.5, 2.0), "alpha_visc_max_ngb": u(0.0, 0.5),
        "shock_indicator": u(-3.0, 3.0), "tensor_norm": tensor,
        "time_bin": rng.integers(1, 6, n).astype(np.int32),
        "pid": np.arange(n, dtype=np.int32),
    }
    g_ref = RefGrid.build_columns(ic["box"], 1.0 / 3.0, ic["pos"])
    assert g_ref.cdim == (3, 3, 1)
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


def _loop(ls, scheme, loop):
    """(reference flat loop, brute force, port loop) of one case."""
    pr, pp = _params(scheme)
    s = ls["s"]
    sj = {k: jnp.asarray(v) for k, v in s.items()}
    st = state_from_reference(s, CPU)
    cr, cp = RefCosmo(**COSMO), CosmoFactors(**COSMO)
    g_ref, g_port, live = ls["g_ref"], ls["g_port"], ls["live"]

    def fl(name):
        return jnp.asarray(_flat(s[name], live))

    pos = jnp.asarray(ls["pos"], jnp.float32)
    if loop == "density":
        return (hydro_pallas.density_loop(g_ref, sj, pr, interpret=True,
                                          engine="flat"),
                bruteforce.density_bruteforce(pr, pos, fl("h"), fl("m"),
                                              fl("v"), box=ls["box"],
                                              u=fl("u")),
                hydro_flat.density_loop(g_port, st, pp))
    if loop == "gradient":
        extra = {k: fl(k) for k in pp.mod.GRADIENT_J_EXTRA}
        return (hydro_pallas.gradient_loop(g_ref, sj, pr, cr, interpret=True,
                                           engine="flat"),
                bruteforce.gradient_bruteforce(
                    pr, pos, fl("h"), fl("m"), fl("v"), fl("u"), fl("rho"),
                    fl("soundspeed"), fl("alpha_visc"), fl("v_sig"),
                    fl("alpha_visc_max_ngb"), cr, box=ls["box"],
                    extra=extra),
                hydro_flat.gradient_loop(g_port, st, pp, cp))
    return (hydro_pallas.force_loop(g_ref, sj, pr, cr, interpret=True,
                                    engine="flat"),
            bruteforce.force_bruteforce(
                pr, pos, fl("h"), fl("m"), fl("v"), fl("rho"),
                fl("pressure"), fl("soundspeed"), fl("f_gradh"),
                fl("balsara"), fl("alpha_visc"), fl("alpha_diff"), fl("u"),
                fl("v_sig"), cr, box=ls["box"]),
            hydro_flat.force_loop(g_port, st, pp, cp))


@pytest.mark.parametrize("scheme,loop", LOOP_CASES,
                         ids=[f"{s}-{lp}" for s, lp in LOOP_CASES])
def test_loop_matches_reference_and_bruteforce(loop_state, scheme, loop):
    ref_flat, brute, port = _loop(loop_state, scheme, loop)
    live = loop_state["live"]
    assert set(brute) <= set(port) and set(port) == set(ref_flat)
    for k in port:
        if k == "min_ngb_time_bin":
            assert np.array_equal(np.asarray(ref_flat[k]), port[k].numpy())
            continue
        is_max = k in ("v_sig", "alpha_visc_max_ngb")
        a, b = np.asarray(ref_flat[k]), port[k].numpy()
        if is_max:           # maxes: the same pair values, 1e-6 relative
            assert np.allclose(b, a, rtol=1e-6, atol=0.0), k
        else:
            assert _rel_max(a, b) <= 1e-5, k
        if k in brute:       # all pairs, in float32
            tol = 2e-3 if k.endswith("_dh") else 1e-5
            assert _rel_max(np.asarray(brute[k]),
                            _flat(b, live)) <= tol, k
    if loop == "density":
        assert set(SCHEME_MODULES[scheme].DENSITY_EXTRA_KEYS) <= set(port)
    if loop == "gradient":
        assert set(SCHEME_MODULES[scheme].GRADIENT_SUM_KEYS) <= set(port)
    if scheme == "none":
        for k in ("a_hydro", "u_dt", "h_dt"):
            assert not port[k].any(), k


# ---------------------------------------------------------------------------
# the engine: init + 4 steps against the reference Engine
# ---------------------------------------------------------------------------

N_STEPS = 4
# (scheme, the reference's backend): the reference's xla Engine compiles
# in seconds, its flat Engine's Pallas interpreter in ~45 s a pass;
# Gasoline's gradient reads j-side fields, which only the flat path's
# field layout carries, so it is held against the flat Engine
ENGINE_CASES = [("pressure-entropy", "xla"),
                ("pressure-energy-monaghan", "xla"), ("phantom", "xla"),
                ("gasoline", "flat"), ("none", "xla")]


def _engine(pkg_grid, pkg_engine, P, backend, **dev):
    ic = uniform_box_ic(n=6, jitter=0.15, seed=3)
    reach = float(ic["h"].max() * P.kernel.gamma * 1.25)
    if backend == "flat":
        grid = pkg_grid.build_columns(ic["box"], interaction_range=reach,
                                      pos=ic["pos"])
    else:
        grid = pkg_grid.build(ic["box"], reach, len(ic["pos"]))
    eng = pkg_engine.Engine(grid, P, pkg_engine.EngineConfig(
        dt_max=5e-4, backend=backend), 0.0, 1.0, **dev)
    rng = np.random.default_rng(7)
    v = (ic["v"] + rng.normal(0, 0.3, ic["v"].shape)).astype(np.float32)
    u = (ic["u"] * rng.uniform(0.8, 1.2, len(ic["u"]))).astype(np.float32)
    eng.load_particles(ic["pos"], ic["m"], v, u, ic["h"])
    return eng


def _np_state(state):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).copy() for k, v in state.items()}


@pytest.fixture(scope="module", params=ENGINE_CASES,
                ids=[s for s, _ in ENGINE_CASES])
def engine_runs(request):
    scheme, ref_backend = request.param
    pr, pp = _params(scheme, h_max=0.4)
    runs = {}
    for name, P, grid, eng_mod, backend, dev in (
            ("ref", pr, RefGrid, ref_engine, ref_backend, {}),
            ("port", pp, CellGrid, port_engine, "flat", {"device": CPU})):
        eng = _engine(grid, eng_mod, P, backend, **dev)
        loaded = _np_state(eng.state)
        eng.init_particles()
        init = _np_state(eng.state)
        for _ in range(N_STEPS):
            eng.step()
        runs[name] = {"loaded": loaded, "init": init,
                      "final": _np_state(eng.state), "steps": eng.step_count}
    return request.param, runs


def _perpid(s, x):
    pid = s["pid"].ravel()
    m = s["mask"].ravel() > 0
    x = np.asarray(x)
    x = x.reshape((-1,) + x.shape[2:])[m]
    return x[np.argsort(pid[m])]


@pytest.mark.parametrize("when", ["init", "final"])
def test_engine_matches_reference_per_pid(engine_runs, when):
    (scheme, _), runs = engine_runs
    r, p = runs["ref"][when], runs["port"][when]
    assert np.array_equal(np.sort(_perpid(r, r["pid"])),
                          np.sort(_perpid(p, p["pid"])))
    for k in ("rho", "h", "u_full") + tuple(
            k for k in SCHEME_MODULES[scheme].EXTRA_STATE_KEYS
            if k in ("pressure_bar", "rho_bar")):
        a, b = _perpid(r, r[k]), _perpid(p, p[k])
        assert np.max(np.abs(b - a) / np.abs(a)) <= 1e-3, k
    if scheme != "none":
        assert _rel_max(_perpid(r, r["a_hydro"]),
                        _perpid(p, p["a_hydro"])) <= 1e-3
    assert np.array_equal(_perpid(r, r["time_bin"]),
                          _perpid(p, p["time_bin"]))
    assert all(np.all(np.isfinite(v)) for v in p.values()
               if np.asarray(v).dtype.kind == "f")


def test_engine_takes_the_steps(engine_runs):
    _, runs = engine_runs
    assert runs["ref"]["steps"] == runs["port"]["steps"] == N_STEPS


def test_none_moves_nothing_by_hydro():
    """The None scheme on the port's flat Engine: a_hydro and u_dt exactly
    0 and u_full unchanged, per pid, over init + 4 steps."""
    _, pp = _params("none", h_max=0.4)
    eng = _engine(CellGrid, port_engine, pp, "flat", device=CPU)
    loaded = _np_state(eng.state)
    eng.init_particles()
    for _ in range(N_STEPS):
        eng.step()
    p = _np_state(eng.state)
    live = p["mask"] > 0
    assert not np.any(p["a_hydro"][live]) and not np.any(p["u_dt"][live])
    assert np.array_equal(_perpid(p, p["u_full"]),
                          _perpid(loaded, loaded["u_full"]))


def test_state_from_reference_carries_the_scheme_state(engine_runs):
    (scheme, _), runs = engine_runs
    ref = runs["ref"]["final"]
    st = state_from_reference(ref, CPU)
    for k in SCHEME_MODULES[scheme].EXTRA_STATE_KEYS:
        assert k in runs["port"]["final"], k
        assert np.array_equal(st[k].numpy(), ref[k]), k

"""Port vs reference: SPHENIX pair terms, lifecycle functions, kernel, EOS.

Seeded numpy inputs through models/sph of both packages (identity
cosmology as python floats, as both engines run it); every output within
2e-6 of max |reference| (f32 rounding of reordered sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu.engine import _NO_COSMO_LIT
from swift_subtask_dev_tpu.models.sph import sphenix as ref
from swift_subtask_dev_tpu_torch.models.sph import sphenix as port

TOL = 2e-6
SHAPE = (6, 128)
P_REF = ref.SPHENIXParams(h_max=0.3)
P_PORT = port.SPHENIXParams(h_max=0.3)
COSMO = port.CosmoFactors.no_cosmo()


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float64)
    b = b.cpu().numpy().astype(np.float64) if isinstance(b, torch.Tensor) \
        else np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = np.max(np.abs(a)) + 1e-30
    assert np.all(np.isfinite(b) == np.isfinite(a))
    fin = np.isfinite(a)
    return np.max(np.abs(a[fin] - b[fin]), initial=0.0) / scale <= tol


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
        "v_full": u(-1, 1, SHAPE + (3,)),
    }
    s["h_dt"][:, :5] = 0.0
    s["wcount"][0, :7] = 0.0               # no-neighbour fallback rows
    return s


def _split(s):
    return ({k: jnp.asarray(v) for k, v in s.items()},
            {k: torch.from_numpy(v.copy()) for k, v in s.items()})


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
    return {
        "dx": dx, "r2": r2, "dv": [u(-1, 1) for _ in range(3)],
        "hinv_i": 1 / h_i, "hinv_j": 1 / h_j, "m_i": m_i, "m_j": m_j,
        "minv_i": 1 / m_i, "minv_j": 1 / m_j, "rho_i": rho_i,
        "rho_j": rho_j, "rhoinv_i": 1 / rho_i, "rhoinv_j": 1 / rho_j,
        "pr2_i": P_i / rho_i ** 2, "pr2_j": P_j / rho_j ** 2,
        "P_i": P_i, "P_j": P_j, "cs_i": u(0.8, 1.5), "cs_j": u(0.8, 1.5),
        "f_i": u(-0.1, 0.1), "f_j": u(-0.1, 0.1), "bal_i": u(0, 1),
        "bal_j": u(0, 1), "al_i": u(0, 1), "al_j": u(0, 1),
        "ad_i": u(0, 0.5), "ad_j": u(0, 0.5), "u_i": u(0.5, 2),
        "u_j": u(0.5, 2),
    }


def _conv(x, to):
    if isinstance(x, list):
        return tuple(_conv(v, to) for v in x)
    return jnp.asarray(x) if to == "jax" else torch.from_numpy(x.copy())


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _pair_args(name, to):
    a = {k: _conv(v, to) for k, v in _pair_inputs().items()}
    if name == "density":
        return (a["dx"], a["r2"], a["hinv_i"], a["m_j"], a["dv"])
    if name == "gradient":
        return (a["dx"], a["r2"], a["hinv_i"], a["m_j"], a["dv"], a["u_i"],
                a["u_j"], a["rhoinv_j"], a["cs_i"], a["cs_j"], a["al_j"])
    return (a["dx"], a["r2"], a["hinv_i"], a["hinv_j"], a["m_i"], a["m_j"],
            a["minv_i"], a["minv_j"], a["dv"], a["rho_i"], a["rho_j"],
            a["rhoinv_i"], a["rhoinv_j"], a["pr2_i"], a["pr2_j"],
            a["P_i"], a["P_j"], a["cs_i"], a["cs_j"], a["f_i"], a["f_j"],
            a["bal_i"], a["bal_j"], a["al_i"], a["al_j"], a["ad_i"],
            a["ad_j"], a["u_i"], a["u_j"])


@pytest.mark.parametrize("name", ["density", "gradient", "force"])
def test_pair_terms_match(name):
    fr = getattr(ref, f"{name}_terms")
    fp = getattr(port, f"{name}_terms")
    extra_r = () if name == "density" else (_NO_COSMO_LIT,)
    extra_p = () if name == "density" else (COSMO,)
    out_r = _flatten(fr(P_REF, *_pair_args(name, "jax"), *extra_r))
    out_p = _flatten(fp(P_PORT, *_pair_args(name, "torch"), *extra_p))
    assert out_r.keys() == out_p.keys()
    for k in out_r:
        assert _close(out_r[k], out_p[k]), k


def test_kernel_and_eos_match():
    u = np.linspace(0.0, 2.2, 2001).astype(np.float32)
    wr, dr = P_REF.kernel.deval(jnp.asarray(u))
    wp, dp = P_PORT.kernel.deval(torch.from_numpy(u))
    assert _close(wr, wp) and _close(dr, dp)
    k_r, k_p = P_REF.kernel, P_PORT.kernel
    for attr in ("gamma", "gamma2", "gamma_inv", "root"):
        assert getattr(k_r, attr) == pytest.approx(getattr(k_p, attr),
                                                   rel=1e-15)
    rho = np.linspace(0.1, 3, 64).astype(np.float32)
    uu = np.linspace(0.1, 5, 64).astype(np.float32)
    Pr = P_REF.eos.pressure_from_internal_energy(jnp.asarray(rho),
                                                 jnp.asarray(uu))
    Pp = P_PORT.eos.pressure_from_internal_energy(torch.from_numpy(rho),
                                                  torch.from_numpy(uu))
    assert _close(Pr, Pp)
    assert _close(P_REF.eos.soundspeed_from_pressure(jnp.asarray(rho), Pr),
                  P_PORT.eos.soundspeed_from_pressure(
                      torch.from_numpy(rho), Pp))


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
]


@pytest.mark.parametrize("name,fn", LIFECYCLE, ids=[n for n, _ in LIFECYCLE])
def test_lifecycle_matches(name, fn):
    sj, st = _split(_state())
    out_r = fn(ref, P_REF, sj, _NO_COSMO_LIT)
    out_p = fn(port, P_PORT, st, COSMO)
    for k in out_r:
        assert _close(out_r[k], out_p[k]), (name, k)


def test_ghost_h_update_matches():
    rng = np.random.default_rng(4)
    n = 4096
    h = rng.uniform(0.05, 0.12, n).astype(np.float32)
    # mixed regimes: below/above target, no neighbours, brackets hit
    wcount = (P_REF.eta_dim / h ** 3
              * rng.uniform(0.5, 1.5, n)).astype(np.float32)
    wcount_dh = (-3 * wcount / h * rng.uniform(0.5, 1.5, n)) \
        .astype(np.float32)
    left = np.where(rng.uniform(size=n) < 0.3, h * 0.9, 0.0) \
        .astype(np.float32)
    right = np.where(rng.uniform(size=n) < 0.3, h * 1.1, 0.3) \
        .astype(np.float32)
    left[:64], right[:64] = h[:64], h[:64] * 1.001   # ping-pong rows
    has = rng.uniform(size=n) > 0.05
    args = (h, wcount, wcount_dh, left, right)
    out_r = ref.ghost_h_update(P_REF, *map(jnp.asarray, args),
                               jnp.asarray(has))
    out_p = port.ghost_h_update(P_PORT, *map(torch.from_numpy, args),
                                torch.from_numpy(has))
    for a, b in zip(out_r[:3], out_p[:3]):
        assert _close(a, b)
    assert np.array_equal(np.asarray(out_r[3]), out_p[3].numpy())

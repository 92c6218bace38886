"""Port vs reference: the Sod shock example (examples/sodshock.py).

The port's example (flat backend, column grid) and the reference Engine
on the same grid (backend "flat", its Pallas kernel in the interpreter)
from the same IC: sod_shock_ic(n_l=12, y_aspect=1.0), 3,888 particles
on 4 x 3 columns (the example's 1.4 gamma h_max reach needs three
columns across the tube: at n = 12 that is y_aspect 1.0, not the
reference's 0.5).  The scheme is
Gadget2, so the example's entropy conversion of the IC is in the path.
init_particles() and STEPS steps in both, compared per particle id: rho,
h and u_full (the entropy) within 1e-3 relative and v_full within 1e-3 of
max (as tests/test_torch_engine.py's slice); L1(rho)/mean and L1(vx)
against the exact solution within 1e-3 of the reference state's.  The
IC and the exact solution are the reference's, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu import ics as ref_ics
from swift_subtask_dev_tpu import validation as ref_validation
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.grid.cellgrid import global_positions
from swift_subtask_dev_tpu.models.sph import SCHEMES as REF_SCHEMES
from swift_subtask_dev_tpu.models.sph import gadget2 as ref_gadget2
from swift_subtask_dev_tpu_torch import ics, validation
from swift_subtask_dev_tpu_torch.examples import sodshock

CPU = torch.device("cpu")
N, Y_ASPECT, SCHEME, STEPS, T_END = 12, 1.0, "gadget2", 2, 0.2


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """torch on two threads (several test workers share the cores; the
    reference's XLA runs its own pool beside it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_state(state):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).copy() for k, v in state.items()}


@pytest.fixture(scope="module")
def runs():
    port = sodshock.make_engine(N, T_END, SCHEME, device=CPU,
                                y_aspect=Y_ASPECT)
    ic = ref_ics.sod_shock_ic(n_l=N, y_aspect=Y_ASPECT)
    P = REF_SCHEMES[SCHEME](h_max=float(ic["h"].max() * 4))
    grid = RefGrid.build_columns(
        ic["box"], interaction_range=float(ic["h"].max() * P.kernel.gamma
                                           * 1.4), pos=ic["pos"])
    assert (grid.cdim, grid.K) == (port.grid.cdim, port.grid.K)
    ref = ref_engine.Engine(grid, P, ref_engine.EngineConfig(
        dt_max=1e-2, backend="flat"), 0.0, T_END + 1e-9)
    rho0 = np.where(ic["pos"][:, 0] < 1.0, 1.0, 0.125).astype(np.float32)
    A = np.asarray(ref_gadget2.entropy_from_internal_energy(
        P, jnp.asarray(rho0), jnp.asarray(ic["u"])), np.float32)
    ref.load_particles(ic["pos"], ic["m"], ic["v"], A, ic["h"])
    out = {"loaded": (_np_state(ref.state), _np_state(port.state))}
    ref.init_particles()
    port.init_particles()
    out["init"] = (_np_state(ref.state), _np_state(port.state))
    for _ in range(STEPS):
        ref.step()
        port.step()
    out["final"] = (_np_state(ref.state), _np_state(port.state))
    out["errors"] = (_ref_errors(ref), sodshock.profile_errors(port))
    out["times"] = (ref.time, port.time)
    return out


def _ref_errors(eng):
    """The reference example's L1 measure on its engine's state."""
    s = eng.state
    mask = np.asarray(s["mask"]) > 0
    x = global_positions(eng.grid, np.asarray(s["off"]))[mask][:, 0]
    rho = np.asarray(s["rho"])[mask]
    vx = np.asarray(s["v_full"])[mask][:, 0]
    sel = (x > 0.35) & (x < 1.75)
    rho_ex, v_ex, _ = ref_validation.sod_solution(x[sel], eng.time)
    return {"l1_rho": float(np.mean(np.abs(rho[sel] - rho_ex))
                            / rho_ex.mean()),
            "l1_vx": float(np.mean(np.abs(vx[sel] - v_ex)))}


def _perpid(s, x):
    pid = s["pid"].ravel()
    m = s["mask"].ravel() > 0
    x = np.asarray(x)
    x = x.reshape((-1,) + x.shape[2:])[m]
    return x[np.argsort(pid[m])]


def test_ic_and_exact_solution_are_the_reference_s():
    a = ref_ics.sod_shock_ic(n_l=N, y_aspect=Y_ASPECT)
    b = ics.sod_shock_ic(n_l=N, y_aspect=Y_ASPECT)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    x = np.linspace(0.0, 2.0, 4001)
    for t in (0.0, 0.05, 0.2):
        for u, v in zip(ref_validation.sod_solution(x, t),
                        validation.sod_solution(x, t)):
            assert np.array_equal(u, v)


def test_example_loads_the_entropy(runs):
    r, p = runs["loaded"]
    assert np.array_equal(_perpid(r, r["u_full"]), _perpid(p, p["u_full"]))


@pytest.mark.parametrize("when", ["init", "final"])
def test_example_matches_reference_per_pid(runs, when):
    r, p = runs[when]
    for k in ("rho", "h", "u_full"):
        a, b = _perpid(r, r[k]), _perpid(p, p[k])
        assert np.max(np.abs(b - a) / np.abs(a)) <= 1e-3, k
    a, b = _perpid(r, r["v_full"]), _perpid(p, p["v_full"])
    assert np.max(np.abs(b - a)) <= 1e-3 * (np.max(np.abs(a)) + 1e-30)
    assert np.array_equal(_perpid(r, r["time_bin"]),
                          _perpid(p, p["time_bin"]))


def test_example_l1_matches_reference(runs):
    (er, ep), (tr, tp) = runs["errors"], runs["times"]
    assert tr == pytest.approx(tp, rel=1e-12)
    assert tp > 0.0
    for k in ("l1_rho", "l1_vx"):
        assert ep[k] == pytest.approx(er[k], rel=1e-3, abs=1e-6), k

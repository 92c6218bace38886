"""Port vs reference: the gravity-only DMEngine.

``test_dm_engine.py``'s two cases, on the flat column grid with split
mesh kicks (the port's gravity), in both packages (the reference's flat
P2P kernel in the Pallas interpreter): a uniform bcc 6^3 lattice (3
steps; it stays static) and two isolated particles (10 steps; they fall
towards each other at G m / r^2).  Compared per particle id: positions
1e-5 of the box, time bins equal, v_full, a_grav and a_grav_mesh 1e-4 of
max for the two bodies; on the lattice, whose net forces cancel to
round-off (~1e-7), 1e-5 of the pull of one nearest neighbour, G m / d^2.
"""

import numpy as np
import pytest
import torch

from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.grid.cellgrid import global_positions as ref_gpos
from swift_subtask_dev_tpu.models import gravity as ref_gravity
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.grid.cellgrid import global_positions
from swift_subtask_dev_tpu_torch.ics import bcc_lattice
from swift_subtask_dev_tpu_torch.models import gravity as port_gravity

CPU = torch.device("cpu")
MESH_N = 32


def _setup(pkg_grid, pkg_gravity, pkg_engine, pos, m, v, eps, dt_max,
           **dev):
    gp = pkg_gravity.GravityParams(G=1.0, eps=eps, mesh_N=MESH_N)
    r_cut = gp.r_cut_ratio * gp.a_smooth / gp.mesh_N
    grid = pkg_grid.build_columns((1.0, 1.0, 1.0), r_cut * 1.15, pos)
    solver = pkg_gravity.GravitySolver(gp, grid, **dev)
    cfg = pkg_engine.EngineConfig(dt_max=dt_max, eta_grav=gp.eta,
                                  p2p_reach=solver.pm.r_cut, backend="flat")
    eng = pkg_engine.DMEngine(grid, cfg, 0.0, 1.0,
                              gravity_fn=solver.gas_short_range_fn(),
                              eps_soft=eps, mesh_fn=solver.gas_mesh_fn(),
                              mesh_dt_scale=solver.pm.r_s, **dev)
    eng.load_dm(pos, m, v)
    return eng


def _per_pid(eng, gpos):
    s = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v)) for k, v in eng.state.items()}
    mask = s["mask"] > 0
    order = np.argsort(s["pid"][mask])
    out = {"pos": gpos(eng.grid, s["off"])[mask][order]}
    for k in ("v_full", "a_grav", "a_grav_mesh", "time_bin", "pid"):
        out[k] = s[k][mask][order]
    return out


def _run(case, n_steps):
    if case == "lattice":
        pos = bcc_lattice((6, 6, 6), (1.0, 1.0, 1.0))
        n = len(pos)
        args = (pos, np.full(n, 1.0 / n, np.float32),
                np.zeros((n, 3), np.float32), 2e-3, 1e-3)
    else:
        pos = np.array([[0.45, 0.5, 0.5], [0.55, 0.5, 0.5]])
        args = (pos, np.array([1e-4, 1e-4], np.float32),
                np.zeros((2, 3), np.float32), 2e-3, 1e-4)
    out = {}
    for label, pkg, dev, gpos in (
            ("ref", (RefGrid, ref_gravity, ref_engine), {}, ref_gpos),
            ("port", (CellGrid, port_gravity, port_engine),
             {"device": CPU}, global_positions)):
        eng = _setup(*pkg, *args, **dev)
        eng.init_particles()
        init = _per_pid(eng, gpos)
        for _ in range(n_steps):
            eng.step()
        out[label] = {"init": init, "final": _per_pid(eng, gpos),
                      "time": eng.time, "steps": eng.step_count}
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def _same(ref, port, scale=None):
    assert np.array_equal(ref["pid"], port["pid"])
    assert np.abs(ref["pos"] - port["pos"]).max() <= 1e-5
    for k in ("v_full", "a_grav", "a_grav_mesh"):
        if scale is None:
            assert _rel(ref[k], port[k]) <= 1e-4, k
        else:
            assert np.abs(ref[k] - port[k]).max() <= 1e-5 * scale, k
    assert np.array_equal(ref["time_bin"], port["time_bin"])


def test_lattice_matches_reference_and_stays_static():
    """Per pid after init_particles() and after 3 steps; a uniform
    periodic lattice has zero net force, so the velocity growth from
    residual lattice forces stays tiny against ~1.  (One test per run:
    the reference's run is the expensive part.)"""
    lattice = _run("lattice", 3)
    # G m / d^2 of the bcc 6^3 lattice (m = 1/432, d = sqrt(3)/12)
    for when in ("init", "final"):
        _same(lattice["ref"][when], lattice["port"][when],
              scale=(1.0 / 432) / (3.0 / 144))
    assert lattice["port"]["steps"] == 3
    assert np.abs(lattice["port"]["final"]["v_full"]).max() < 5e-3


def test_two_body_matches_reference_and_attracts():
    """Per pid after init_particles() and after 10 steps; |a| = G m / r^2
    = 1e-2 towards the other particle (P2P plus mesh), and infall
    velocities develop (a t)."""
    two_body = _run("two_body", 10)
    for when in ("init", "final"):
        _same(two_body["ref"][when], two_body["port"][when])
    init, final = two_body["port"]["init"], two_body["port"]["final"]
    ax = (init["a_grav"] + init["a_grav_mesh"])[:, 0]
    assert np.isclose(ax[0], 1e-2, rtol=0.05), ax
    assert np.isclose(ax[1], -1e-2, rtol=0.05), ax
    vx = final["v_full"][:, 0]
    expect_v = 1e-2 * two_body["port"]["time"]
    assert vx[0] > 0.5 * expect_v and vx[1] < -0.5 * expect_v, (vx,
                                                                expect_v)


def test_dm_engine_refuses_other_backends():
    with pytest.raises(ValueError, match="flat"):
        port_engine.DMEngine(
            CellGrid((1.0, 1.0, 1.0), (3, 3, 3), 8),
            port_engine.EngineConfig(backend="pallas"), 0.0, 1.0,
            gravity_fn=None, eps_soft=1e-3, device=CPU)

"""Port vs reference: re-gridding through the step's retry.

The Sedov IC (sedov_ic(n=10, E0=100)) on a 27-cell grid whose edge just
covers the initial kernel reach (interaction range gamma * h: cdim
(5, 5, 5)), with headroom 1.05 (K = 24) and h_max = 0.3.  At this size a
grid with headroom 1.05 alone never overflows within 8 steps (the drift
trigger stays below its margin), so the wall hit here is the coverage
one: the blast grows h past the cell edge at step 6.  Both engines
restore the pre-step state, re-grid to cdim (4, 4, 4), K = 56, and retry;
per pid the state then matches as in test_torch_sedov.py.  The port's
overflow wall and occupancy shrink are exercised on their own.
"""

import numpy as np
import pytest
import torch

from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as RefP
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch.grid import CellGrid, global_positions
from swift_subtask_dev_tpu_torch.ics import sedov_ic
from swift_subtask_dev_tpu_torch.models.sph.sphenix import SPHENIXParams

from test_torch_sedov import _np_state, _perpid

CPU = torch.device("cpu")
GAMMA = 1.825742
STEPS = 8


def _record_regrids(eng, log):
    orig = eng.regrid

    def regrid(*a, **kw):
        orig(*a, **kw)
        log.append((eng.step_count, eng.grid.cdim, eng.grid.K))
    eng.regrid = regrid


@pytest.fixture(scope="module")
def tight_runs():
    ic = sedov_ic(n=10, E0=100.0)
    reach = GAMMA * float(ic["h"].max())
    out = {}
    for name, Grid, P, make in (
            ("ref", RefGrid, RefP,
             lambda g, P: ref_engine.Engine(
                 g, P, ref_engine.EngineConfig(dt_max=1e-3, backend="xla"),
                 0.0, 1.0)),
            ("port", CellGrid, SPHENIXParams,
             lambda g, P: port_engine.Engine(
                 g, P, port_engine.EngineConfig(dt_max=1e-3,
                                                backend="pallas"),
                 0.0, 1.0, device=CPU))):
        grid = Grid.build_for_positions(ic["box"], reach, ic["pos"],
                                        headroom=1.05)
        eng = make(grid, P(h_max=0.3, CFL=0.1))
        eng.load_particles(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
        log = []
        _record_regrids(eng, log)
        eng.init_particles()
        untouched = []
        for _ in range(STEPS):
            before = eng.state
            if name == "port":
                copies = {k: v.clone() for k, v in before.items()}
                retries = eng.n_regrid_retries
            eng.step()
            if name == "port" and eng.n_regrid_retries > retries:
                untouched.append(
                    eng.state is not before
                    and all(torch.equal(before[k], copies[k])
                            for k in copies))
        out[name] = {"grid0": (grid.cdim, grid.K), "log": log,
                     "ti": eng.timeline.ti_current, "eng": eng,
                     "final": _np_state(eng.state), "untouched": untouched}
    return out


def test_regrid_matches_reference_grid_and_step(tight_runs):
    """Same re-grid (step, cdim, K) as the reference; per pid the state
    after the retried steps matches; the failed attempt left the tensors
    of the pre-step state bit-identical (the step never writes into the
    tensors it is given).  One test, so the fixture's two runs are made
    once even when the tests are spread over several workers."""
    r, p = tight_runs["ref"], tight_runs["port"]
    assert r["grid0"] == p["grid0"] == ((5, 5, 5), 24)
    assert p["log"] == r["log"]
    assert len(p["log"]) == 1 and p["log"][0][1:] == ((4, 4, 4), 56)
    assert p["eng"].n_regrids == p["eng"].n_regrid_retries == 1

    assert r["ti"] == p["ti"]
    rf, pf = r["final"], p["final"]
    assert np.array_equal(_perpid(rf, rf["pid"]), _perpid(pf, pf["pid"]))
    assert np.array_equal(_perpid(rf, rf["time_bin"]),
                          _perpid(pf, pf["time_bin"]))
    for k in ("rho", "h", "u_full"):
        a, b = _perpid(rf, rf[k]), _perpid(pf, pf[k])
        assert np.max(np.abs(a - b) / (np.abs(a) + 1e-10)) < 1e-3, k

    assert p["untouched"] == [True]


def _sedov_engine(headroom, **cfg):
    ic = sedov_ic(n=10, E0=100.0)
    grid = CellGrid.build_for_positions(
        ic["box"], 3.2 * float(ic["h"].max()), ic["pos"], headroom=headroom)
    eng = port_engine.Engine(
        grid, SPHENIXParams(h_max=float(min(grid.edge) / GAMMA * 0.98),
                            CFL=0.1),
        port_engine.EngineConfig(dt_max=1e-3, backend="pallas", **cfg),
        0.0, 1.0, device=CPU)
    eng.load_particles(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
    return eng


def test_cell_overflow_regrids_through_the_retry():
    """Ten particles moved into the fullest cell of a K = max-count grid
    overflow its rebucket: the step raises RegridNeeded inside, the engine
    restores, re-grids from the live particles (edge >= 1.05 gamma h_max,
    K from the new fullest cell) and completes the step."""
    eng = _sedov_engine(1.0)
    eng.init_particles()
    s = eng.state
    counts = (s["mask"] > 0).sum(1)
    c = int(torch.argmax(counts))
    ncx, ncy, ncz = eng.grid.cdim
    ix, iy, iz = c // (ncy * ncz), (c // ncz) % ncy, c % ncz
    donor = eng.grid.linear_cell_of(torch.tensor([ix + 1, iy, iz]))
    off = s["off"].clone()
    off[donor, :10, 0] -= eng.grid.edge[0]       # now inside cell c
    eng.state = {**s, "off": off, "drift_accum": torch.tensor(1e30)}
    grid0 = eng.grid
    assert int(counts[c]) + 10 > grid0.K
    before = eng.state
    copies = {k: v.clone() for k, v in before.items()}
    eng.step()
    assert eng.n_regrid_retries == eng.n_regrids == 1
    assert eng.step_count == 1 and eng.grid != grid0
    reach = float(s["h"][s["mask"] > 0].max()) * GAMMA * 1.05
    assert min(eng.grid.edge) >= reach
    assert all(torch.equal(before[k], copies[k]) for k in copies)
    pid = eng.state["pid"][eng.state["mask"] > 0]
    assert torch.equal(torch.sort(pid).values, torch.arange(2000,
                                                            dtype=pid.dtype))
    assert float(eng.state["drift_accum"]) < 0.01   # the forced 1e30 went


def test_occupancy_shrink_regrids_after_the_cooldown():
    """A grid with K > 128 whose fullest cell x 1.7 is below half of K is
    rebuilt with headroom 1.6 once the cooldown has passed."""
    eng = _sedov_engine(5.0, regrid_cooldown=2)
    eng.init_particles()
    assert eng.grid.K == 456
    eng.step()
    assert eng.n_shrink_regrids == 0
    eng.step()
    assert eng.n_shrink_regrids == eng.n_regrids == 1
    live = eng.state["mask"] > 0
    pos = global_positions(eng.grid, eng.state["off"])[live.numpy()]
    reach = float(eng.state["h"][live].max()) * GAMMA * 1.05
    want = RefGrid.build_for_positions(eng.grid.box, reach, pos,
                                       headroom=1.6)
    assert (eng.grid.cdim, eng.grid.K) == (want.cdim, want.K)
    assert eng.grid.K < 456

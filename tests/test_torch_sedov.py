"""Port vs reference: the Sedov blast with hierarchical time-steps.

The Sedov example (sedov_ic(n=10, E0=100): 2,000 particles) runs
init_particles() and 8 step()s in the port on the CPU, on both port paths:

* ``pallas``: the example's 27-cell grid (cdim (3, 3, 3), K = 208) and the
  packed pair engine;
* ``flat``: 3 x 3 columns, the flat pair engine and the timestep limiter.

Each is held against the reference Engine with ``backend="xla"`` (the same
27-cell physics, and the example's default), with the limiter for the flat
path.  Per pid: time_bin identical; rho, h and u_full within 1e-3
relative, v_full within 1e-3 of |v|; ti_current equal after every step;
n_woken equal at every step.

Without the limiter the example's configuration loses energy once the
blast outruns its neighbours' time steps; at E0 = 1e3 the reference and
the port lose the same ~29% at the same step.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.io import statistics as ref_statistics
from swift_subtask_dev_tpu.models.sph.sphenix import CosmoFactors as RefCF
from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as RefP
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch.examples import sedov
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.ics import sedov_ic
from swift_subtask_dev_tpu_torch.interop import state_from_reference
from swift_subtask_dev_tpu_torch.io.statistics import gas_statistics
from swift_subtask_dev_tpu_torch.models.sph.sphenix import (CosmoFactors,
                                                            SPHENIXParams)

CPU = torch.device("cpu")
N, E0, STEPS = 10, 100.0, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_state(state):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).copy() for k, v in state.items()}


def _perpid(s, x):
    pid = s["pid"].ravel()
    m = s["mask"].ravel() > 0
    x = np.asarray(x).reshape(-1, *np.asarray(x).shape[2:])
    return x[m][np.argsort(pid[m])]


def _hist(diag):
    bc = np.asarray(diag["bin_counts"])
    return {"bins": int((bc > 0).sum()), "n_woken": int(diag["n_woken"]),
            "n_active": int(diag["n_active"])}


def _ref_blast(E0, limiter, h_max):
    """The reference Engine on the example's grid, backend "xla"."""
    ic = sedov_ic(n=N, E0=E0)
    grid = RefGrid.build_for_positions(ic["box"], float(ic["h"].max() * 3.2),
                                       ic["pos"], headroom=2.2)
    ref = ref_engine.Engine(
        grid, RefP(h_max=h_max, CFL=0.1),
        ref_engine.EngineConfig(dt_max=1e-3, backend="xla",
                                with_timestep_limiter=limiter),
        0.0, 1.0 + 1e-9)
    ref.load_particles(ic["pos"], ic["m"], ic["v"], ic["u"], ic["h"])
    return ref


@pytest.fixture(scope="module", params=["pallas", "flat"])
def blast_runs(request):
    backend = request.param
    limiter = backend == "flat"
    port = sedov.make_engine(N, 1.0, backend, limiter, CPU, E0)
    ref = _ref_blast(E0, limiter, port.sph.h_max)
    out = {"backend": backend, "port": port, "ref": ref}
    for name, eng in (("port", port), ("ref", ref)):
        eng.init_particles()
        hist = []
        for _ in range(STEPS):
            d = eng.step()
            hist.append({**_hist(d), "ti": eng.timeline.ti_current})
        out[name + "_hist"] = hist
        out[name + "_final"] = _np_state(eng.state)
    return out


def test_sedov_slice_matches_reference(blast_runs):
    """One test per path, so the two runs of its fixture are made once
    each even when the tests are spread over several workers."""
    r, p = blast_runs["ref_final"], blast_runs["port_final"]
    assert [h["ti"] for h in blast_runs["port_hist"]] == \
        [h["ti"] for h in blast_runs["ref_hist"]]
    assert blast_runs["port"].step_count == blast_runs["ref"].step_count
    assert np.array_equal(_perpid(r, r["pid"]), _perpid(p, p["pid"]))
    assert np.array_equal(_perpid(r, r["time_bin"]),
                          _perpid(p, p["time_bin"]))
    for k in ("rho", "h", "u_full"):
        a, b = _perpid(r, r[k]), _perpid(p, p[k])
        assert np.max(np.abs(a - b) / (np.abs(a) + 1e-10)) < 1e-3, k
    # velocities per pid, as vectors: |dv| within 1e-3 of |v| (of 1e-3
    # of the fastest particle's |v| where a particle barely moves)
    a, b = _perpid(r, r["v_full"]), _perpid(p, p["v_full"])
    speed = np.linalg.norm(a, axis=-1)
    floor = 1e-3 * speed.max()
    assert speed.max() > 0
    assert np.max(np.linalg.norm(a - b, axis=-1)
                  / np.maximum(speed, floor)) < 1e-3
    for k, v in p.items():
        assert np.all(np.isfinite(v)), k
    assert [h["n_woken"] for h in blast_runs["port_hist"]] == \
        [h["n_woken"] for h in blast_runs["ref_hist"]]
    assert [h["n_active"] for h in blast_runs["port_hist"]] == \
        [h["n_active"] for h in blast_runs["ref_hist"]]

    # the run exercises what it claims to: >= 3 populated time bins, and
    # wakes on the limiter path
    hist = blast_runs["port_hist"]
    assert max(h["bins"] for h in hist) >= 3
    assert min(h["n_active"] for h in hist) < 2000
    woken = sum(h["n_woken"] for h in hist)
    if blast_runs["backend"] == "flat":
        assert woken > 0
    else:
        assert woken == 0


def test_energy_loss_without_the_limiter_is_the_references():
    """The example's configuration (27-cell grid, no timestep limiter)
    does not conserve energy once the blast outruns its neighbours' time
    steps: at E0 = 1e3 the total energy drops by ~29% at step 25, in the
    reference (backend "xla") and in the port (backend "pallas") alike.
    Per step, the two drifts agree within 1e-4."""
    E0_loss, steps = 1e3, 25
    port = sedov.make_engine(N, 1.0, "pallas", False, CPU, E0_loss)
    ref = _ref_blast(E0_loss, False, port.sph.h_max)
    drifts = []
    for eng, stats in ((ref, ref_statistics.gas_statistics),
                       (port, gas_statistics)):
        eng.init_particles()
        e0 = float(stats(eng.state)["e_tot"])
        d = []
        for _ in range(steps):
            eng.step()
            d.append(abs(float(stats(eng.state)["e_tot"]) - e0) / e0)
        drifts.append(np.array(d))
    d_ref, d_port = drifts
    assert ref.timeline.ti_current == port.timeline.ti_current
    assert np.max(np.abs(d_ref - d_port)) < 1e-4
    assert d_ref[:20].max() < 0.05 and d_ref[-1] > 0.25


def _engines(ti):
    """A reference and a port engine with the limiter, at ti (no
    particles: the tables need only the timeline)."""
    grid = ((1.0, 1.0, 1.0), (3, 3, 3), 8)
    P = dict(h_max=0.1, CFL=0.1)
    ref = ref_engine.Engine(
        RefGrid(*grid), RefP(**P),
        ref_engine.EngineConfig(backend="xla", with_timestep_limiter=True),
        0.0, 1.0)
    port = port_engine.Engine(
        CellGrid(*grid), SPHENIXParams(**P),
        port_engine.EngineConfig(with_timestep_limiter=True), 0.0, 1.0,
        device=CPU)
    ref.timeline.ti_current = port.timeline.ti_current = ti
    return ref, port


@pytest.mark.parametrize("ti", [0, 1, 4096, 3 << 40, (1 << 50) + 12,
                                (1 << 57) - 8])
def test_wake_tables_bit_identical(ti):
    ref, port = _engines(ti)
    a_dv, a_du = ref._wake_tables(ti)
    b_dv, b_du = port._wake_tables(ti)
    assert a_dv.dtype == b_dv.dtype == np.float32
    assert np.array_equal(a_dv.view(np.uint32), b_dv.view(np.uint32))
    assert np.array_equal(a_du.view(np.uint32), b_du.view(np.uint32))
    assert (ti <= 0) == (not a_dv.any())
    T = port._tables()
    assert torch.equal(T.wake_dv, torch.from_numpy(b_dv))


def test_apply_wake_exact():
    """Waking re-bins the chosen inactive particles and swaps their long
    half-kick for the short-step kicks, bit for bit as the reference."""
    ti = (1 << 45) + (1 << 43)
    ref, port = _engines(ti)
    rng = np.random.default_rng(4)
    C, K = 27, 8
    s = {"mask": (rng.uniform(size=(C, K)) < 0.9).astype(np.float32),
         "v_full": rng.normal(size=(C, K, 3)).astype(np.float32),
         "a_hydro": rng.normal(size=(C, K, 3)).astype(np.float32),
         "a_grav": rng.normal(size=(C, K, 3)).astype(np.float32),
         "u_full": rng.uniform(1, 2, (C, K)).astype(np.float32),
         "u_dt": rng.normal(size=(C, K)).astype(np.float32),
         "time_bin": rng.integers(40, 50, (C, K)).astype(np.int32)}
    wake = (rng.uniform(size=(C, K)) < 0.3) & (s["mask"] > 0)
    new_bin = np.minimum(rng.integers(38, 48, (C, K)),
                         s["time_bin"]).astype(np.int32)
    a = ref_engine.apply_wake(
        RefP(h_max=0.1, CFL=0.1), RefCF.no_cosmo(),
        {k: jnp.asarray(v) for k, v in s.items()}, ref._tables(),
        jnp.asarray(wake), jnp.asarray(new_bin))
    b = port_engine.apply_wake(
        SPHENIXParams(h_max=0.1, CFL=0.1), CosmoFactors.no_cosmo(),
        state_from_reference(s, CPU), port._tables(),
        torch.from_numpy(wake), torch.from_numpy(new_bin))
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), b[k].numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    moved = np.asarray(a["v_full"]) != s["v_full"]
    assert moved.any(axis=-1)[wake].mean() > 0.5 and not moved[~wake].any()


def test_limiter_on_the_pallas_backend_is_not_ported():
    """The limiter on the pallas backend (the reference's 27-cell
    stencil.timebin_loop) is ported now: the engine takes it.  The xla
    backend is still refused."""
    eng = port_engine.Engine(
        CellGrid((1.0, 1.0, 1.0), (3, 3, 3), 8), SPHENIXParams(),
        port_engine.EngineConfig(backend="pallas",
                                 with_timestep_limiter=True),
        0.0, 1.0, device=CPU)
    assert eng.cfg.with_timestep_limiter
    with pytest.raises(ValueError, match="not ported"):
        port_engine.Engine(
            CellGrid((1.0, 1.0, 1.0), (3, 3, 3), 8), SPHENIXParams(),
            port_engine.EngineConfig(backend="xla"), 0.0, 1.0, device=CPU)


def test_example_main_runs_on_the_cpu(capsys):
    rc = sedov.main(["--cpu", "--n", "10", "--tend", "0.0015"])
    out = capsys.readouterr().out
    assert rc in (0, 1)
    assert "N = 2000" in out and "grid: (3, 3, 3) K=208" in out
    assert "shock radius:" in out and ("PASS" in out or "FAIL" in out)


def test_entry_points_default_to_the_card():
    """Called without a device, the entry points put nothing on the CPU:
    on this machine (no CUDA) they raise."""
    code = """
import numpy as np
from swift_subtask_dev_tpu_torch.engine import Engine, EngineConfig
from swift_subtask_dev_tpu_torch.grid import CellGrid, bucket_fields
from swift_subtask_dev_tpu_torch.models.gravity import (GravityParams,
                                                        GravitySolver)
from swift_subtask_dev_tpu_torch.models.sph.sphenix import SPHENIXParams
from swift_subtask_dev_tpu_torch.ops import pm_gravity
grid = CellGrid((1.0, 1.0, 1.0), (3, 3, 1), 128)
pos = np.random.default_rng(0).uniform(size=(10, 3))
calls = {
    "GravitySolver": lambda: GravitySolver(GravityParams(mesh_N=32), grid),
    "bucket_fields": lambda: bucket_fields(grid, pos, {}),
    "green_table": lambda: pm_gravity.green_table(
        pm_gravity.PMMeshParams(N=8, box=grid.box), 1.0),
    "Engine": lambda: Engine(grid, SPHENIXParams(), EngineConfig(), 0.0,
                             1.0).load_particles(
        pos, np.ones(10), np.zeros((10, 3)), np.ones(10), np.ones(10)),
}
for name, fn in calls.items():
    try:
        out = fn()
    except (AssertionError, RuntimeError) as e:
        print(name, "raised", type(e).__name__)
    else:
        raise SystemExit(f"{name} returned {out!r} without a card")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout
    assert res.stdout.count("raised") == 4, res.stdout

"""Port vs reference: the timestep limiter on the 27-cell grid.

* ``stencil.timebin_loop`` (the limiter's wake scan on the ``pallas`` and
  ``pallas_ring`` backends) against the reference's, unrolled as its
  engine calls it, on a bucketed Sedov IC with several time bins and a
  random active set: bit-exact.
* The Sedov example (sedov_ic(n=10, E0=100): 2,000 particles, cdim
  (3, 3, 3), K = 208) with the limiter on both 27-cell port backends
  against the reference Engine (backend "xla", with the limiter) over 8
  steps: per pid, time_bin identical; rho, h and u_full within 1e-3
  relative, v_full within 1e-3 of |v|; ti_current and the wakes of every
  step equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as RefP
from swift_subtask_dev_tpu.ops import stencil as ref_stencil
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch.examples import sedov
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.interop import state_from_reference
from swift_subtask_dev_tpu_torch.models.sph.sphenix import SPHENIXParams
from swift_subtask_dev_tpu_torch.ops import stencil

from test_torch_sedov import N, STEPS, _hist, _np_state, _perpid, _ref_blast

CPU = torch.device("cpu")
E0 = 100.0


@pytest.mark.parametrize("seed", [0, 1])
def test_timebin_loop_bit_exact(seed):
    eng = sedov.make_engine(N, 1.0, "pallas", device=CPU, E0=E0)
    s = {k: v.numpy().copy() for k, v in eng.state.items()}
    rng = np.random.default_rng(seed)
    live = s["mask"] > 0
    shape = s["mask"].shape
    s["h"] = (s["h"] * rng.uniform(0.6, 1.6, shape)).astype(np.float32)
    s["time_bin"] = np.where(live, rng.integers(38, 46, shape),
                             0).astype(np.int32)
    s["active"] = ((rng.uniform(size=shape) < 0.01) & live).astype(
        np.float32)
    sub = {k: s[k] for k in ("mask", "off", "h", "time_bin", "active")}
    g_ref = RefGrid(eng.grid.box, eng.grid.cdim, eng.grid.K)
    P_ref = RefP(h_max=eng.sph.h_max, CFL=0.1)
    ref = np.asarray(ref_stencil.timebin_loop(
        g_ref, {k: jnp.asarray(v) for k, v in sub.items()}, P_ref,
        use_scan=False))
    port = stencil.timebin_loop(eng.grid, state_from_reference(sub, CPU),
                                eng.sph).numpy()
    assert ref.dtype == port.dtype == np.int32
    assert np.array_equal(ref, port)
    found = port[live] < stencil.NBIN_SENTINEL
    assert 0.2 < found.mean() < 0.95         # some slots see no active j
    assert len(np.unique(port[live][found])) >= 4


def test_sedov_limiter_matches_reference_on_both_27cell_backends(
        monkeypatch):
    """One reference run, held against both port backends, so the
    reference's run is made once wherever the test lands.  Each port step
    runs its wake scan through stencil.timebin_loop."""
    scans = []
    real = stencil.timebin_loop

    def spy(grid, s, p):
        scans.append(grid.cdim)
        return real(grid, s, p)

    monkeypatch.setattr(stencil, "timebin_loop", spy)
    runs = {}
    for backend in ("pallas_ring", "pallas"):
        port = sedov.make_engine(N, 1.0, backend, True, CPU, E0)
        port.init_particles()
        runs[backend] = (port, [_hist(port.step()) | {
            "ti": port.timeline.ti_current} for _ in range(STEPS)])
    assert scans == [(3, 3, 3)] * (2 * STEPS)
    ref = _ref_blast(E0, True, runs["pallas"][0].sph.h_max)
    ref.init_particles()
    ref_hist = [_hist(ref.step()) | {"ti": ref.timeline.ti_current}
                for _ in range(STEPS)]
    r = _np_state(ref.state)
    assert sum(h["n_woken"] for h in ref_hist) > 0
    assert max(h["bins"] for h in ref_hist) >= 3
    for backend, (port, hist) in runs.items():
        p = _np_state(port.state)
        assert [h["ti"] for h in hist] == [h["ti"] for h in ref_hist]
        assert [h["n_woken"] for h in hist] == \
            [h["n_woken"] for h in ref_hist], backend
        assert [h["n_active"] for h in hist] == \
            [h["n_active"] for h in ref_hist], backend
        assert np.array_equal(_perpid(r, r["pid"]), _perpid(p, p["pid"]))
        assert np.array_equal(_perpid(r, r["time_bin"]),
                              _perpid(p, p["time_bin"])), backend
        for k in ("rho", "h", "u_full"):
            a, b = _perpid(r, r[k]), _perpid(p, p[k])
            assert np.max(np.abs(a - b) / (np.abs(a) + 1e-10)) < 1e-3, \
                (backend, k)
        a, b = _perpid(r, r["v_full"]), _perpid(p, p["v_full"])
        speed = np.linalg.norm(a, axis=-1)
        assert np.max(np.linalg.norm(a - b, axis=-1)
                      / np.maximum(speed, 1e-3 * speed.max())) < 1e-3, \
            backend
        for k, v in p.items():
            assert np.all(np.isfinite(v)), (backend, k)


def test_27cell_backends_take_the_limiter():
    """Engine(backend="pallas" or "pallas_ring", with the limiter) is
    built; an unported backend is still refused."""
    for backend in ("pallas", "pallas_ring"):
        eng = port_engine.Engine(
            CellGrid((1.0, 1.0, 1.0), (3, 3, 3), 8), SPHENIXParams(),
            port_engine.EngineConfig(backend=backend,
                                     with_timestep_limiter=True),
            0.0, 1.0, device=CPU)
        assert eng.cfg.with_timestep_limiter
    with pytest.raises(ValueError, match="not ported"):
        port_engine.Engine(
            CellGrid((1.0, 1.0, 1.0), (3, 3, 3), 8), SPHENIXParams(),
            port_engine.EngineConfig(backend="xla",
                                     with_timestep_limiter=True),
            0.0, 1.0, device=CPU)


def test_example_main_takes_pallas_ring_and_the_limiter(monkeypatch,
                                                       capsys):
    """The example's --backend pallas_ring --limiter reach the engine
    (the run itself is stubbed: the blast is tested above)."""
    seen = {}

    def run_blast(n, t_end, engine=None, **kw):
        seen["cfg"], seen["grid"] = engine.cfg, engine.grid
        return engine, {"steps": 0, "run_seconds": 0.0, "t": 0.0,
                        "n_regrids": 0, "energy_drift": 0.0, "r_shock": 0.0,
                        "r_sedov": 1.0, "radius_err": 1.0, "ok": False}

    monkeypatch.setattr(sedov, "run_blast", run_blast)
    rc = sedov.main(["--cpu", "--n", "10", "--backend", "pallas_ring",
                     "--limiter"])
    out = capsys.readouterr().out
    assert rc == 1 and "backend pallas_ring, limiter True" in out
    assert seen["cfg"].backend == "pallas_ring"
    assert seen["cfg"].with_timestep_limiter
    assert seen["grid"].cdim == (3, 3, 3) and seen["grid"].K == 208

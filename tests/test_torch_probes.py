"""Port vs reference: the two probes (FP32 throughput, flat-kernel cost).

* T1: the port's plain FMA chains against the reference's Pallas kernel
  (``tools/vpu_peak.kernel`` through ``pl.pallas_call(interpret=True)``,
  with the module's ITERS set to 2 for the test) on its (256, 128) tile:
  within ``vpu_peak.tolerance`` relative (the reference may round each
  multiply-add once or twice; the plain version rounds twice).
* T2: each of the six synthetic bodies (A00, A, B, C, D, E) through the
  port's plain flat engine against the reference's own body (captured by
  running ``tools/probe_kernel.main`` with its kernel calls recorded)
  through ``pallas_flat.pair_apply`` in the interpreter, on a small bench
  geometry (uniform_box_ic(n=12): 3,456 particles, 4 x 4 columns): sums
  within 1e-5 of max.  E keeps the reference's approximate reciprocal,
  which the interpreter evaluates within 2.6e-3 relative (the port's plain
  E divides exactly): each pair adds a <= 1/3 to a term >= 2.3 (r2b and
  exp(-r2) are ~1 at r2 < 0.0036), so E's sums agree within 4e-4
  relative; it is held at 5e-4 of max.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import swift_subtask_dev_tpu.ics as ref_ics
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.ops import pallas_flat
from swift_subtask_dev_tpu_torch.ops import pair_flat
from swift_subtask_dev_tpu_torch.ops.pair_flat import PairPass
from swift_subtask_dev_tpu_torch.probes import probe_kernel, vpu_peak

CPU = torch.device("cpu")
TOL = {"probe_e": 5e-4}     # other bodies: 1e-5
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_vpu_peak_plain_matches_reference_kernel(monkeypatch):
    ref = _load_tool("vpu_peak")
    assert ref.ITERS == vpu_peak.ITERS
    iters = 2
    monkeypatch.setattr(ref, "ITERS", iters)
    assert (ref.ROWS, ref.LANES, ref.INNER) == (
        vpu_peak.ROWS, vpu_peak.LANES, vpu_peak.INNER)
    x = np.random.default_rng(0).uniform(
        0.5, 1.5, (ref.ROWS, ref.LANES)).astype(np.float32)
    out_ref = np.asarray(pl.pallas_call(
        ref.kernel,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))
    out = vpu_peak.fma_chains(torch.from_numpy(x), iters)
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    rel = np.max(np.abs(out.numpy().astype(np.float64) - out_ref)
                 / np.abs(out_ref.astype(np.float64)))
    assert rel <= vpu_peak.tolerance(iters)
    # the reference's count: 2 multiply-adds = 4 flops per element-step
    assert vpu_peak.flops(x.size, vpu_peak.ITERS) == \
        ref.ROWS * ref.LANES * ref.INNER * vpu_peak.ITERS * 2 * 2


@pytest.fixture(scope="module")
def ref_probe_bodies():
    """The reference probe's six pair callbacks, in its order, recorded by
    running its ``main`` with the kernel calls and timings stubbed out
    (and a small IC, so the recording costs little)."""
    ref = _load_tool("probe_kernel")
    captured = []
    real_ic = ref_ics.uniform_box_ic

    def record(grid, fields, order, pair_fn, n_sum, n_max, **kw):
        captured.append((tuple(order), pair_fn, n_sum, n_max,
                         kw.get("range_scale")))
        return [jnp.zeros(fields["mask"].shape, jnp.float32)], []

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_flat, "pair_apply", record)
        mp.setattr(pallas_flat, "JB", pallas_flat.JB)
        mp.setattr(sys, "argv", ["probe_kernel.py"])
        mp.setattr(ref, "timed", lambda fn, *a, n=8: (fn(), 0.0)[1])
        mp.setattr(ref_ics, "uniform_box_ic",
                   lambda n, **kw: real_ic(n=4, **kw))
        ref.main()
    return captured


@pytest.fixture(scope="module")
def small_geometry():
    return probe_kernel.geometry(n1=12, reach=0.25, device=CPU)


@pytest.mark.parametrize("q", range(6))
def test_probe_body_plain_matches_reference(ref_probe_bodies, small_geometry,
                                            q):
    grid, f = small_geometry
    assert grid.cdim == (4, 4, 1) and int(f["mask"].sum()) == 3456
    order, pair_fn, n_sum, n_max, range_scale = ref_probe_bodies[q]
    body = probe_kernel.BODIES[q]
    assert order == body.fields and (n_sum, n_max) == (1, 0)
    assert range_scale == 1.0
    g_ref = RefGrid(grid.box, grid.cdim, grid.K)
    ref_sums, _ = pallas_flat.pair_apply(
        g_ref, {k: jnp.asarray(f[k].numpy()) for k in order}, list(order),
        pair_fn, n_sum=1, n_max=0, shifts_scale=g_ref.edge,
        range_scale=1.0, interpret=True)
    pair_flat.reset_launches()
    sums, maxes = pair_flat.pair_apply(
        grid, PairPass(body, {k: f[k] for k in body.fields},
                       range_scale=1.0))
    assert maxes == [] and pair_flat.LAUNCHES == {}
    a = np.asarray(ref_sums[0], np.float64)
    b = sums[0].numpy().astype(np.float64)
    live = f["mask"].numpy() > 0
    assert np.mean(b[live] != 0.0) > 0.8     # most live slots saw pairs
    tol = TOL.get(body.name, 1e-5)
    assert np.max(np.abs(a - b)) <= tol * np.max(np.abs(a)), body.name


def test_probe_visited_granules(small_geometry):
    grid, f = small_geometry
    nb = probe_kernel.visited_granules(grid, f)
    tiles = int(((f["mask"] > 0).sum(1) + 127).div(128, rounding_mode="floor")
                .sum())
    # every live tile visits its own column's granules at least
    assert tiles * 1 <= nb <= tiles * 9 * grid.K // pair_flat.GRAN


def test_probes_and_ring_engine_import_no_jax():
    """The new modules run on the machine with the card, which has no
    jax: importing them pulls in neither jax nor the JAX package."""
    import subprocess
    code = ("import sys\n"
            "import swift_subtask_dev_tpu_torch.ops.pair_ring\n"
            "import swift_subtask_dev_tpu_torch.ops.stencil\n"
            "import swift_subtask_dev_tpu_torch.probes.vpu_peak\n"
            "import swift_subtask_dev_tpu_torch.probes.probe_kernel\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] == 'swift_subtask_dev_tpu']\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(TOOLS), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr

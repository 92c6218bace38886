"""Port vs reference: column grid, z-sorted bucketing, rebucket, copies.

The same seeded numpy inputs go through swift_subtask_dev_tpu (JAX, on
the CPU) and swift_subtask_dev_tpu_torch; slot order, mask and offsets
must be bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu.grid import cellgrid as ref_grid
from swift_subtask_dev_tpu import ics as ref_ics
from swift_subtask_dev_tpu.utils import timeline as ref_tl
from swift_subtask_dev_tpu_torch.grid import cellgrid as port_grid
from swift_subtask_dev_tpu_torch import ics as port_ics
from swift_subtask_dev_tpu_torch.utils import timeline as port_tl

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ic():
    return port_ics.uniform_box_ic(n=8, jitter=0.25, seed=7)


@pytest.fixture(scope="module")
def grids(ic):
    rng = float(ic["h"].max() * 1.825742 * 1.25)
    g_ref = ref_grid.CellGrid.build_columns(ic["box"], rng, ic["pos"])
    g_port = port_grid.CellGrid.build_columns(ic["box"], rng, ic["pos"])
    return g_ref, g_port


def _fields(ic):
    n = len(ic["pos"])
    rng = np.random.default_rng(11)
    return {"pid": np.arange(n, dtype=np.int32),
            "m": ic["m"], "h": ic["h"],
            "v": rng.normal(size=(n, 3)).astype(np.float32),
            "time_bin": rng.integers(0, 40, n).astype(np.int32)}


def _bits_equal(a, b):
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b.cpu().numpy() if isinstance(b, torch.Tensor)
                             else b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_ics_and_timeline_copies_match():
    a = ref_ics.uniform_box_ic(n=6, jitter=0.2, seed=3)
    b = port_ics.uniform_box_ic(n=6, jitter=0.2, seed=3)
    for k in ("pos", "m", "h", "u", "v"):
        assert _bits_equal(a[k], b[k]), k
    assert np.array_equal(ref_ics.bcc_lattice((3, 4, 5), (1.0, 2.0, 3.0)),
                          port_ics.bcc_lattice((3, 4, 5), (1.0, 2.0, 3.0)))
    tr, tp = ref_tl.Timeline(0.0, 1.0), port_tl.Timeline(0.0, 1.0)
    for ti in (0, 8, 12, 1 << 40, 3 << 41):
        tr.ti_current = tp.ti_current = ti
        assert np.array_equal(tr.active_bins_mask(), tp.active_bins_mask())
        for b in (0, 1, 20, 56):
            assert ref_tl.get_integer_timestep(b) == \
                port_tl.get_integer_timestep(b)
            assert ref_tl.get_integer_time_end(ti, b) == \
                port_tl.get_integer_time_end(ti, b)
        counts = np.zeros(57, int)
        counts[[3, 20]] = 1
        assert tr.ti_end_min_from_bins(counts) == \
            tp.ti_end_min_from_bins(counts)


def test_build_columns_and_corners_match(grids):
    g_ref, g_port = grids
    assert (g_ref.box, g_ref.cdim, g_ref.K, g_ref.x_roll) == \
        (g_port.box, g_port.cdim, g_port.K, g_port.x_roll)
    assert g_port.cdim == (3, 3, 1)
    assert np.array_equal(g_ref.cell_corners(), g_port.cell_corners())
    rolled_ref = ref_grid.CellGrid(g_ref.box, g_ref.cdim, g_ref.K, x_roll=2)
    rolled = port_grid.CellGrid(g_ref.box, g_ref.cdim, g_ref.K, x_roll=2)
    assert np.array_equal(rolled_ref.cell_corners(), rolled.cell_corners())


@pytest.mark.parametrize("x_roll", [0, 1])
def test_bucket_fields_zsort_bit_identical(ic, grids, x_roll):
    g_ref, g_port = grids
    g_ref = ref_grid.CellGrid(g_ref.box, g_ref.cdim, g_ref.K, x_roll=x_roll)
    g_port = port_grid.CellGrid(g_ref.box, g_ref.cdim, g_ref.K,
                                x_roll=x_roll)
    f = _fields(ic)
    out_r, mask_r, off_r, nov_r = ref_grid.bucket_fields(
        g_ref, jnp.asarray(ic["pos"]), {k: jnp.asarray(v)
                                        for k, v in f.items()}, zsort=True)
    out_p, mask_p, off_p, nov_p = port_grid.bucket_fields(
        g_port, ic["pos"], f, device=CPU)
    assert int(nov_r) == int(nov_p) == 0
    assert _bits_equal(mask_r, mask_p)
    assert _bits_equal(off_r, off_p)
    for k in f:
        assert _bits_equal(out_r[k], out_p[k]), k
    # slots within a column are z-sorted and live slots form a prefix
    m = mask_p.numpy() > 0
    z = np.where(m, off_p[..., 2].numpy(), 2.0)
    assert np.all(np.diff(z, axis=1)[m[:, 1:]] >= 0)
    assert np.all(m[:, :-1] | ~m[:, 1:])


def test_bucket_fields_overflow_counts(ic, grids):
    g_ref, _ = grids
    tight_r = ref_grid.CellGrid(g_ref.box, g_ref.cdim, 64)
    tight_p = port_grid.CellGrid(g_ref.box, g_ref.cdim, 64)
    f = {"m": ic["m"]}
    _, mask_r, _, nov_r = ref_grid.bucket_fields(
        tight_r, jnp.asarray(ic["pos"]), {"m": jnp.asarray(ic["m"])},
        zsort=True)
    _, mask_p, _, nov_p = port_grid.bucket_fields(tight_p, ic["pos"], f,
                                                  device=CPU)
    assert int(nov_r) == int(nov_p) > 0
    assert _bits_equal(mask_r, mask_p)


def test_rank_in_run_matches():
    rng = np.random.default_rng(5)
    keys = np.sort(rng.integers(0, 30, 500)).astype(np.int32)
    a = np.asarray(ref_grid._rank_in_run(jnp.asarray(keys)))
    b = port_grid._rank_in_run(torch.from_numpy(keys)).numpy()
    assert np.array_equal(a, b)


def test_rebucket_offsets_after_drift_bit_identical(ic, grids):
    g_ref, g_port = grids
    f = _fields(ic)
    out_r, mask_r, off_r, _ = ref_grid.bucket_fields(
        g_ref, jnp.asarray(ic["pos"]),
        {k: jnp.asarray(v) for k, v in f.items()}, zsort=True)
    rng = np.random.default_rng(9)
    # drift far enough that many particles change column and z order
    disp = rng.normal(0.0, 0.08, np.asarray(off_r).shape).astype(np.float32)
    off_d = np.asarray(off_r) + disp * np.asarray(mask_r)[..., None]
    fields_np = {k: np.asarray(v) for k, v in out_r.items()}
    ref = ref_grid.rebucket_offsets(
        g_ref, mask_r, jnp.asarray(off_d),
        {k: jnp.asarray(v) for k, v in fields_np.items()}, zsort=True)
    port = port_grid.rebucket_offsets(
        g_port, torch.from_numpy(np.asarray(mask_r).copy()),
        torch.from_numpy(off_d), {k: torch.from_numpy(v.copy())
                                  for k, v in fields_np.items()})
    assert int(ref[3]) == int(port[3]) == 0
    assert _bits_equal(ref[1], port[1])
    assert _bits_equal(ref[2], port[2])
    for k in fields_np:
        assert _bits_equal(ref[0][k], port[0][k]), k
    moved = np.asarray(ref[0]["pid"]) != fields_np["pid"]
    assert moved.sum() > 100
    # empty slots carry the fills: pid -1, everything else 0
    empty = np.asarray(ref[1]) == 0
    assert np.all(port[0]["pid"].numpy()[empty] == -1)
    assert np.all(port[0]["time_bin"].numpy()[empty] == 0)


def test_global_positions_match(ic, grids):
    g_ref, g_port = grids
    _, _, off, _ = port_grid.bucket_fields(g_port, ic["pos"], {},
                                           device=CPU)
    a = ref_grid.global_positions(g_ref, off.numpy())
    b = port_grid.global_positions(g_port, off)
    assert np.array_equal(a, b)

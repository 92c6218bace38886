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


# --- the 27-cell grid of the packed backend (zsort=False) -------------------

@pytest.fixture(scope="module")
def sedov_grids():
    """The Sedov example's 27-cell grid at n=10 (2,000 particles), built
    by both packages."""
    ic = port_ics.sedov_ic(n=10, E0=100.0)
    rng = float(ic["h"].max() * 3.2)
    g_ref = ref_grid.CellGrid.build_for_positions(ic["box"], rng, ic["pos"],
                                                  headroom=2.2)
    g_port = port_grid.CellGrid.build_for_positions(ic["box"], rng,
                                                    ic["pos"], headroom=2.2)
    return ic, g_ref, g_port


def test_sedov_ic_copy_matches():
    a = ref_ics.sedov_ic(n=6, E0=3.0)
    b = port_ics.sedov_ic(n=6, E0=3.0)
    for k in ("pos", "m", "h", "u", "v"):
        assert _bits_equal(a[k], b[k]), k
    assert a["box"] == b["box"] and a["gamma"] == b["gamma"]


@pytest.mark.parametrize("n_part,occ", [(2000, 0.55), (54000, 0.3)])
def test_build_and_build_for_positions_match(sedov_grids, n_part, occ):
    ic, g_ref, g_port = sedov_grids
    assert (g_ref.cdim, g_ref.K) == (g_port.cdim, g_port.K) == ((3, 3, 3),
                                                                 208)
    rng = float(ic["h"].max() * 1.825742)
    for hr in (1.05, 1.6):
        a = ref_grid.CellGrid.build_for_positions(ic["box"], rng, ic["pos"],
                                                  headroom=hr)
        b = port_grid.CellGrid.build_for_positions(ic["box"], rng,
                                                   ic["pos"], headroom=hr)
        assert (a.box, a.cdim, a.K) == (b.box, b.cdim, b.K)
    a = ref_grid.CellGrid.build(ic["box"], rng, n_part, occupancy=occ)
    b = port_grid.CellGrid.build(ic["box"], rng, n_part, occupancy=occ)
    assert (a.box, a.cdim, a.K) == (b.box, b.cdim, b.K)
    with pytest.raises(ValueError, match="smaller than interaction range"):
        g_port.validate_range(0.5)
    with pytest.raises(ValueError, match="27-stencil needs >= 3"):
        port_grid.CellGrid((1.0, 1.0, 1.0), (2, 3, 3), 8)


def test_linear_cell_of_wraps_like_reference(sedov_grids):
    _, g_ref, g_port = sedov_grids
    ijk = np.random.default_rng(3).integers(-4, 7, (50, 3)).astype(np.int32)
    a = np.asarray(g_ref.linear_cell_of(jnp.asarray(ijk)))
    b = g_port.linear_cell_of(torch.from_numpy(ijk)).numpy()
    assert np.array_equal(a, b)


def test_bucket_fields_unsorted_bit_identical(sedov_grids):
    ic, g_ref, g_port = sedov_grids
    f = _fields(ic)
    out_r, mask_r, off_r, nov_r = ref_grid._bucket_fields_host(
        g_ref, ic["pos"], f, zsort=False)
    out_p, mask_p, off_p, nov_p = port_grid.bucket_fields(
        g_port, ic["pos"], f, device=CPU, zsort=False)
    assert int(nov_r) == int(nov_p) == 0
    assert _bits_equal(mask_r, mask_p)
    assert _bits_equal(off_r, off_p)
    for k in f:
        assert _bits_equal(out_r[k], out_p[k]), k
    # input order within each cell, live slots a prefix
    m = mask_p.numpy() > 0
    pid = np.where(m, out_p["pid"].numpy(), 1 << 30)
    assert np.all(np.diff(pid, axis=1)[m[:, 1:]] > 0)
    assert np.all(m[:, :-1] | ~m[:, 1:])


def test_rebucket_offsets_unsorted_after_drift_bit_identical(sedov_grids):
    ic, g_ref, g_port = sedov_grids
    f = _fields(ic)
    out_r, mask_r, off_r, _ = ref_grid._bucket_fields_host(
        g_ref, ic["pos"], f, zsort=False)
    rng = np.random.default_rng(9)
    disp = rng.normal(0.0, 0.1, np.asarray(off_r).shape).astype(np.float32)
    off_d = np.asarray(off_r) + disp * np.asarray(mask_r)[..., None]
    fields_np = {k: np.asarray(v) for k, v in out_r.items()}
    ref = ref_grid.rebucket_offsets(
        g_ref, mask_r, jnp.asarray(off_d),
        {k: jnp.asarray(v) for k, v in fields_np.items()}, zsort=False)
    port = port_grid.rebucket_offsets(
        g_port, torch.from_numpy(np.asarray(mask_r).copy()),
        torch.from_numpy(off_d), {k: torch.from_numpy(v.copy())
                                  for k, v in fields_np.items()},
        zsort=False)
    assert int(ref[3]) == int(port[3]) == 0
    assert _bits_equal(ref[1], port[1])
    assert _bits_equal(ref[2], port[2])
    for k in fields_np:
        assert _bits_equal(ref[0][k], port[0][k]), k
    assert (np.asarray(ref[0]["pid"]) != fields_np["pid"]).sum() > 100

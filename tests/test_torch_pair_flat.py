"""Port vs reference: the flat pair engine's range words and plain version.

``_block_ranges`` words must be bit-identical to the reference's (with and
without ``reach_floor`` and ``active_i``).  The plain version's subset and
output conventions are checked here; its five bodies are checked against
the reference kernel in test_torch_engine.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.grid import bucket_fields as ref_bucket
from swift_subtask_dev_tpu.ops import pallas_flat
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
from swift_subtask_dev_tpu_torch.interop import state_from_reference
from swift_subtask_dev_tpu_torch.models.sph.sphenix import SPHENIXParams
from swift_subtask_dev_tpu_torch.ops import (cuda_build, hydro_flat,
                                             pair_flat)

CPU = torch.device("cpu")
GAMMA = 1.825742


@pytest.fixture(scope="module")
def layout():
    """A bucketed IC (reference bucketing) with per-particle h and v."""
    ic = uniform_box_ic(n=8, jitter=0.25, seed=7)
    rng = np.random.default_rng(21)
    n = len(ic["pos"])
    h = (ic["h"] * rng.uniform(0.8, 1.2, n)).astype(np.float32)
    v = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    reach = float(h.max() * GAMMA * 1.25)
    g_ref = RefGrid.build_columns(ic["box"], reach, ic["pos"])
    out, mask, off, _ = ref_bucket(
        g_ref, jnp.asarray(ic["pos"]),
        {"h": jnp.asarray(h), "m": jnp.asarray(ic["m"]),
         "v": jnp.asarray(v)}, zsort=True)
    s = {"mask": np.asarray(mask), "off": np.asarray(off),
         **{k: np.asarray(x) for k, x in out.items()}}
    g_port = CellGrid(g_ref.box, g_ref.cdim, g_ref.K)
    return g_ref, g_port, s


def _active(s, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=s["mask"].shape) < 0.02) & (s["mask"] > 0)


def test_nbr_col_table_matches(layout):
    g_ref, g_port, _ = layout
    assert np.array_equal(pallas_flat.nbr_col_table(g_ref),
                          pair_flat.nbr_col_table(g_port))
    assert pair_flat.OFFSETS_9 == pallas_flat.OFFSETS_9


@pytest.mark.parametrize("sym,floor,h_scale", [
    (False, 0.0, 1.0), (True, 0.0, 1.0), (True, 0.15, 1.0),
    (False, 0.0, 3.0)])     # h_scale 3: reach covers the whole box
def test_block_range_words_bit_identical(layout, sym, floor, h_scale):
    g_ref, g_port, s = layout
    h = s["h"] * np.float32(h_scale)
    ref = pallas_flat._block_ranges(
        g_ref, jnp.asarray(s["mask"]), jnp.asarray(s["off"][..., 2]),
        jnp.asarray(h), GAMMA, sym, jb=pair_flat.GRAN, reach_floor=floor)
    port = pair_flat._block_ranges(
        g_port, torch.from_numpy(s["mask"].copy()),
        torch.from_numpy(s["off"][..., 2].copy()), torch.from_numpy(h),
        GAMMA, sym, jb=pair_flat.GRAN, reach_floor=floor)
    ref = np.asarray(ref)
    assert port.dtype == torch.int32
    assert np.array_equal(ref, port.numpy())
    counts = (ref >> 16) & 0xFFFF
    assert counts.sum() > 0
    if h_scale > 1:    # every live tile's window is the whole column
        live = (s["mask"] > 0).reshape(9, -1, 128).any(axis=2)
        assert np.all(counts[live][..., 0] == s["mask"].shape[1] // 16)


def test_active_i_zeroes_range_words(layout):
    g_ref, g_port, s = layout
    act = _active(s)
    pp = hydro_flat.density_pass(state_from_reference(s, CPU),
                                 SPHENIXParams())
    launch = pair_flat.prepare(g_port, pp,
                               active_i=torch.from_numpy(act))
    # the reference's zeroing (pallas_flat.py:395-398) on its own words
    ref = pallas_flat._block_ranges(
        g_ref, jnp.asarray(s["mask"]), jnp.asarray(s["off"][..., 2]),
        jnp.asarray(np.where(s["mask"] > 0, s["h"], 1.0)), GAMMA, False,
        jb=pair_flat.GRAN)
    tile_act = jnp.any(jnp.asarray(act).reshape(9, -1, 128), axis=2)
    ref = jnp.where(tile_act[:, :, None, None], ref, 0)
    assert np.array_equal(np.asarray(ref), launch.ranges.numpy())
    assert 0 < int(tile_act.sum()) < tile_act.size


def test_active_i_subset_recomputes_active_tiles_exactly(layout):
    """Tiles holding an active particle are computed in full (bit-equal to
    the unrestricted pass); the others are skipped and read 0."""
    _, g_port, s = layout
    act = _active(s)
    st = state_from_reference(s, CPU)
    full = hydro_flat.density_loop(g_port, st, SPHENIXParams())
    sub = hydro_flat.density_loop(g_port, st, SPHENIXParams(),
                                  active_i=torch.from_numpy(act))
    tile_act = act.reshape(9, -1, 128).any(axis=2)
    on = np.repeat(tile_act, 128, axis=1)
    for k in full:
        a, b = full[k].numpy(), sub[k].numpy()
        assert np.array_equal(a[on], b[on]), k
        assert np.all(b[~on] == 0.0), k


def test_dispatch_plain_on_cpu_and_no_kernel_launch(layout):
    _, g_port, s = layout
    pair_flat.reset_launches()
    pp = hydro_flat.p2p_gravity_pass(state_from_reference(s, CPU), 1.0,
                                     0.0375, 0.039, 0.176)
    sums, maxes = pair_flat.pair_apply(g_port, pp)
    assert len(sums) == 4 and maxes == []
    assert pair_flat.LAUNCHES == {}
    launch = pair_flat.prepare(g_port, pp)
    with pytest.raises(ValueError, match="must be a contiguous"):
        pair_flat.pair_apply_kernel(launch, pp.body)


def test_output_conventions_dead_and_skipped_tiles(layout):
    """Dead tiles (past a column's live count) read 0 in every output;
    live tiles whose range words were zeroed read 0 sums, -inf maxes."""
    _, g_port, s = layout
    st = state_from_reference(s, CPU)
    st.update(rho=torch.ones_like(st["h"]), u=torch.ones_like(st["h"]),
              soundspeed=torch.ones_like(st["h"]),
              alpha_visc=torch.ones_like(st["h"]))
    pp = hydro_flat.gradient_pass(st, SPHENIXParams(),
                                  hydro_flat.sphenix.CosmoFactors.no_cosmo())
    act = torch.zeros_like(st["mask"], dtype=torch.bool)
    act[0, 0] = True                    # only column 0, tile 0 is active
    launch = pair_flat.prepare(g_port, pp, active_i=act)
    out = pair_flat.pair_apply_plain(launch, pp.body).reshape(3, 9, -1, 128)
    tcounts = launch.tcounts.numpy()
    TPC = out.shape[2]
    for c in range(9):
        for t in range(TPC):
            blk = out[:, c, t].numpy()
            if t >= tcounts[c]:
                assert np.all(blk == 0.0)
            elif (c, t) != (0, 0):
                assert np.all(blk[0] == 0.0) and np.all(blk[1:] == -np.inf)
    assert np.all(np.isfinite(out[1:, 0, 0].numpy()))
    assert (tcounts < TPC).any()


def test_plain_version_checks_front_packing(layout):
    """The plain version leaves out rows past the fullest column's count,
    which is exact only while every column's live slots are a prefix: a
    live slot after a hole is refused."""
    _, g_port, s = layout
    st = state_from_reference(s, CPU)
    n = int((st["mask"][0] > 0).sum())
    mask = st["mask"].clone()
    mask[0, n - 1], mask[0, n] = 0.0, 1.0       # a hole, then a live slot
    pp = hydro_flat.density_pass({**st, "mask": mask}, SPHENIXParams())
    with pytest.raises(ValueError, match="front-packed"):
        pair_flat.pair_apply(g_port, pp)


def test_p2p_passes_need_the_mesh_split_scale(layout):
    """The P2P pairs always carry the mesh's erfc truncation, so a pass
    without a split scale r_s is refused."""
    _, _, s = layout
    st = state_from_reference(s, CPU)
    with pytest.raises(ValueError, match="r_s > 0"):
        hydro_flat.p2p_gravity_pass(st, 1.0, 0.0375, 0.0, 0.176)


def _fake_nvcc(path, version):
    path.write_text(f"#!/bin/sh\necho 'Cuda compilation tools, {version}'\n")
    path.chmod(0o755)
    return str(path)


def check_library_key(lib, tmp_path, monkeypatch):
    """A library's built name changes with each of its sources, with
    NVCC_FLAGS and with the compiler's version."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name in lib.sources:
        (src / name).write_bytes((cuda_build.CSRC / name).read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", src)
    nv1 = _fake_nvcc(tmp_path / "nvcc1", "release 12.8")
    nv2 = _fake_nvcc(tmp_path / "nvcc2", "release 12.9")
    base = lib.path(nv1)
    assert base.parent == cuda_build.BUILD
    assert base.name.startswith(f"lib{lib.name}-") and base.suffix == ".so"
    assert lib.path(nv1) == base
    assert lib.path(nv2) != base
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ["--use_fast_math"])
    assert lib.path(nv1) != base
    monkeypatch.undo()
    monkeypatch.setattr(cuda_build, "CSRC", src)
    seen = {base}
    for name in lib.sources:
        (src / name).write_bytes((src / name).read_bytes() + b"\n")
        key = lib.path(nv1)
        assert key not in seen
        seen.add(key)


def test_library_key_follows_sources_flags_and_compiler(tmp_path,
                                                        monkeypatch):
    """The built library's name changes with either source file, with
    NVCC_FLAGS and with the compiler's version, so a stale binary is never
    loaded."""
    assert pair_flat.LIBRARY.sources == ("pair_flat.cu", "pair_bodies.cuh",
                                         "probe_bodies.cuh", "walk.cuh")
    check_library_key(pair_flat.LIBRARY, tmp_path, monkeypatch)


def test_timebin_loop_matches_reference_exactly(layout):
    """The limiter's timebin scan (K1's timebin body): min bin over active
    neighbours whose own kernel reaches i, exact against the reference
    kernel in the Pallas interpreter, with bins 0 (empty) and the
    NBIN_SENTINEL where no active neighbour reaches."""
    from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as RP
    from swift_subtask_dev_tpu.ops import hydro_pallas
    g_ref, g_port, s = layout
    rng = np.random.default_rng(17)
    live = s["mask"] > 0
    tb = np.where(live, rng.integers(0, 45, live.shape), 0).astype(np.int32)
    act = (live & (rng.uniform(size=live.shape) < 0.05)).astype(np.float32)
    sub = {"mask": s["mask"], "off": s["off"], "h": s["h"],
           "time_bin": tb, "active": act}
    ref = np.asarray(hydro_pallas.timebin_loop(
        g_ref, {k: jnp.asarray(v) for k, v in sub.items()}, RP(),
        interpret=True, engine="flat"))
    port = hydro_flat.timebin_loop(g_port, state_from_reference(sub, CPU),
                                   SPHENIXParams())
    assert port.dtype == torch.int32 and ref.dtype == np.int32
    assert np.array_equal(ref, port.numpy())
    got = port.numpy()[live]
    assert (got == hydro_flat.NBIN_SENTINEL).any()
    assert (got < hydro_flat.NBIN_SENTINEL).sum() > 100

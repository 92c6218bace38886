"""Port vs reference: the packed 27-cell pair engine (K2) and its loops.

One state of the Sedov example (sedov_ic(n=10, E0=100): 2,000 particles,
cdim (3, 3, 3), K = 208, after init_particles() and one step of the port
on the CPU) goes through the port's density, gradient and force loops with
``engine="packed"`` (the plain version) and through the reference's
``hydro_pallas`` loops with ``engine="packed", interpret=True``: sums
within 5e-5 of max, maxes within 1e-6 relative, min_ngb_time_bin exact,
on every live slot, and with a seeded ~10% active subset (``active_i``)
on its slots, which the port evaluates alone and the reference in full.
The raw outputs of ``pair_apply`` equal the reference kernel's on every
live slot (-inf where a slot accepted no pair) and read 0 on every empty
slot, which the reference kernel evaluates with its pad fills when its
8-slot block starts below the cell's count.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu import engine as ref_engine
from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.models.sph.sphenix import CosmoFactors as RefCF
from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as RefP
from swift_subtask_dev_tpu.ops import hydro_pallas
from swift_subtask_dev_tpu.ops import stencil as ref_stencil
from swift_subtask_dev_tpu_torch import engine as port_engine
from swift_subtask_dev_tpu_torch.examples import sedov
from swift_subtask_dev_tpu_torch.interop import state_from_reference
from swift_subtask_dev_tpu_torch.models.sph.sphenix import CosmoFactors
from swift_subtask_dev_tpu_torch.ops import (cuda_build, hydro_flat,
                                             pair_packed, stencil, walk27)

from test_torch_pair_flat import check_library_key

CPU = torch.device("cpu")
LOOPS = ["density_loop", "gradient_loop", "force_loop"]


@pytest.fixture(scope="module")
def blast():
    """A Sedov state with moving gas and two populated bins, as numpy."""
    eng = sedov.make_engine(10, 1.0, device=CPU, E0=100.0)
    eng.init_particles()
    eng.step()
    s = {k: v.numpy().copy() for k, v in eng.state.items()}
    g_ref = RefGrid(eng.grid.box, eng.grid.cdim, eng.grid.K)
    P_ref = RefP(h_max=eng.sph.h_max, CFL=0.1)
    return eng, s, g_ref, P_ref


def _rel_max(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


def active_subset(s, seed=7):
    """A seeded subset of about 10% of the live slots."""
    live = s["mask"] > 0
    act = (np.random.default_rng(seed).uniform(size=live.shape) < 0.1) & live
    assert 0.05 < act.sum() / live.sum() < 0.15
    return act


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("loop", LOOPS)
def test_packed_loop_matches_reference(blast, loop, active):
    eng, s, g_ref, P_ref = blast
    assert eng.grid.cdim == (3, 3, 3) and eng.grid.K == 208
    assert len(np.unique(s["time_bin"][s["mask"] > 0])) >= 2
    js = {k: jnp.asarray(v) for k, v in s.items()}
    st = state_from_reference(s, CPU)
    # the slots compared: the live ones, or the subset's (the only ones
    # the port evaluates; the engine merges no other)
    on = active_subset(s) if active else s["mask"] > 0
    act = torch.from_numpy(on) if active else None
    if loop == "density_loop":
        ref = hydro_pallas.density_loop(g_ref, js, P_ref, interpret=True,
                                        engine="packed")
        port = hydro_flat.density_loop(eng.grid, st, eng.sph, active_i=act,
                                       engine="packed")
    else:
        ref = getattr(hydro_pallas, loop)(g_ref, js, P_ref, RefCF.no_cosmo(),
                                          interpret=True, engine="packed")
        port = getattr(hydro_flat, loop)(eng.grid, st, eng.sph,
                                         CosmoFactors.no_cosmo(),
                                         active_i=act, engine="packed")
    assert ref.keys() == port.keys()
    for k in ref:
        a, b = np.asarray(ref[k])[on], port[k].numpy()[on]
        if k == "min_ngb_time_bin":
            assert a.dtype == b.dtype and np.array_equal(a, b)
        elif k in ("v_sig", "alpha_visc_max_ngb"):
            assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
            f = np.isfinite(a)
            assert np.max(np.abs(a[f] - b[f])
                          / np.maximum(np.abs(a[f]), 1e-30)) <= 1e-6, k
        else:
            assert _rel_max(a, b) < 5e-5, (loop, k)


def test_raw_outputs_skipped_blocks_and_no_pair_maxes(blast):
    """Raw gradient-body outputs of a state where a few live particles have
    a kernel too small to reach anyone: their maxes read -inf and their
    sums 0; every empty slot reads 0, in 8-blocks past a cell's count (the
    reference kernel's skipped blocks) and inside live ones (which it
    evaluates with its pad fills); on every live slot the output equals
    the reference kernel's (sums 5e-5 of max, maxes 1e-6 relative)."""
    eng, s, g_ref, P_ref = blast
    s = dict(s)
    live = s["mask"] > 0
    lonely = np.zeros_like(live)
    lonely[0, :3] = True
    lonely[5, 0] = True
    assert lonely[live].sum() == 4
    s["h"] = np.where(lonely, np.float32(1e-4), s["h"])
    pp = hydro_flat.gradient_pass(state_from_reference(s, CPU), eng.sph,
                                  CosmoFactors.no_cosmo())
    sums, maxes = pair_packed.pair_apply(eng.grid, pp)
    out = np.stack([x.numpy() for x in sums + maxes])
    counts = live.sum(axis=1)
    k = np.arange(s["mask"].shape[1])
    skipped = (k // 8 * 8)[None, :] >= counts[:, None]
    assert skipped.any() and (~skipped & ~live).any()
    assert np.all(out[:, ~live] == 0.0)
    assert np.all(out[0][lonely] == 0.0)
    assert np.all(out[1:, lonely] == -np.inf)
    assert np.all(np.isfinite(out[:, live & ~lonely]))

    # the reference kernel's raw maxes, read through its gradient loop
    # with the merged-into maxima at -inf (its sums are raw * mask)
    s["v_sig"] = np.full_like(s["h"], -np.inf)
    s["alpha_visc_max_ngb"] = np.full_like(s["h"], -np.inf)
    ref = hydro_pallas.gradient_loop(
        g_ref, {k: jnp.asarray(v) for k, v in s.items()}, P_ref,
        RefCF.no_cosmo(), interpret=True, engine="packed")
    assert _rel_max(ref["laplace_u"], out[0] * s["mask"]) < 5e-5
    for q, k in ((1, "v_sig"), (2, "alpha_visc_max_ngb")):
        a, b = np.asarray(ref[k])[live], out[q][live]
        assert np.array_equal(a == -np.inf, b == -np.inf), k
        f = np.isfinite(a)
        assert np.max(np.abs(a[f] - b[f])
                      / np.maximum(np.abs(a[f]), 1e-30)) <= 1e-6, k


class _RefLoops:
    """The reference's 27-cell density loop of one engine, its Pallas
    kernel in the interpreter (no active subset: full passes)."""

    def __init__(self, engine):
        self.engine = engine

    def density_loop(self, grid, s, p):
        return hydro_pallas.density_loop(grid, s, p, interpret=True,
                                         engine=self.engine)


@pytest.mark.parametrize("engine", ["packed", "ring"])
def test_ghost_on_the_active_subset_matches_reference(blast, engine):
    """The port's ghost on a 27-cell engine, which re-runs only the
    active, unconverged particles, against the reference's, which re-runs
    full passes: the same trips, and on every active particle h within
    1e-6 relative and the density within 5e-5 of max (the sums' order
    differs).  The active particles' h is perturbed by 15% so that the
    ghost iterates."""
    eng, s, g_ref, P_ref = blast
    s = dict(s)
    act = active_subset(s)
    s["h"] = np.where(act, s["h"] * np.float32(1.15), s["h"])
    h, d, n_iter = port_engine._ghost_density(
        eng.grid, eng.sph, CosmoFactors.no_cosmo(),
        state_from_reference(s, CPU), torch.from_numpy(act), 30, engine)
    h_ref, d_ref, n_ref = ref_engine._ghost_density(
        g_ref, P_ref, RefCF.no_cosmo(),
        {k: jnp.asarray(v) for k, v in s.items()}, jnp.asarray(act), 30,
        loops=_RefLoops(engine))
    assert n_iter == int(n_ref) >= 2
    a, b = np.asarray(h_ref)[act], h.numpy()[act]
    assert np.max(np.abs(a - b) / a) <= 1e-6
    for k in ("rho", "wcount"):
        assert _rel_max(np.asarray(d_ref[k])[act], d[k].numpy()[act]) < 5e-5


def test_plain_version_checks_front_packing(blast):
    eng, s, _, _ = blast
    st = state_from_reference(s, CPU)
    live = st["mask"] > 0
    c = int(torch.nonzero(live.sum(1) < eng.grid.K)[0, 0])
    n = int(live[c].sum())
    mask = st["mask"].clone()
    mask[c, n - 1], mask[c, n] = 0.0, 1.0       # a hole, then a live slot
    st["mask"] = mask
    pp = hydro_flat.density_pass(st, eng.sph)
    with pytest.raises(ValueError, match="front-packed"):
        pair_packed.pair_apply(eng.grid, pp)


def test_dispatch_plain_on_cpu_and_kernel_refuses_cpu(blast):
    eng, s, _, _ = blast
    pair_packed.reset_launches()
    pp = hydro_flat.density_pass(state_from_reference(s, CPU), eng.sph)
    sums, maxes = pair_packed.pair_apply(eng.grid, pp)
    assert len(sums) == 8 and maxes == [] and sums[0].shape == (27, 208)
    assert pair_packed.LAUNCHES == {}
    launch = pair_packed.prepare(eng.grid, pp)
    with pytest.raises(ValueError, match="must be a contiguous"):
        pair_packed.pair_apply_kernel(launch, pp.body)
    tb = hydro_flat.timebin_pass(
        {**state_from_reference(s, CPU),
         "active": torch.ones(eng.grid.C, eng.grid.K)}, eng.sph)
    with pytest.raises(ValueError, match="no kernel for body"):
        pair_packed.pair_apply_kernel(pair_packed.prepare(eng.grid, tb),
                                      tb.body)


def test_stencil_constants_and_kernel_tables_match():
    """STENCIL_27 and NBIN_SENTINEL equal the reference's, and the CUDA
    kernel's constant tables walk the stencil in the same order."""
    assert stencil.STENCIL_27 == ref_stencil.STENCIL_27
    assert stencil.NBIN_SENTINEL == ref_stencil.NBIN_SENTINEL
    assert hydro_flat.NBIN_SENTINEL is stencil.NBIN_SENTINEL
    src = (cuda_build.CSRC / "pair_packed.cu").read_text()
    for a, name in enumerate(("ST_DX", "ST_DY", "ST_DZ")):
        body = re.search(name + r"\[27\] = \{([^}]*)\}", src).group(1)
        vals = [int(v) for v in body.replace("\n", " ").split(",")]
        assert vals == [d[a] for d in stencil.STENCIL_27], name
    nbr = walk27.nbr_cell_table((3, 4, 5), stencil.STENCIL_27)
    assert nbr.shape == (60, 27) and np.array_equal(nbr[:, 0],
                                                    np.arange(60))


def test_library_key_follows_sources_flags_and_compiler(tmp_path,
                                                        monkeypatch):
    assert pair_packed.LIBRARY.sources == ("pair_packed.cu", "walk27.cuh",
                                           "walk.cuh", "pair_bodies.cuh")
    check_library_key(pair_packed.LIBRARY, tmp_path, monkeypatch)

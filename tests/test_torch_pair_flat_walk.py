"""The flat kernel's walk (csrc/pair_flat.cu): its warp filter and the
slots it walks, through their plain versions.

The kernel keeps, per warp of 32 i slots, only the staged j rows that a
box around the slots and the body's reach bounds (``pair_flat.REACH2``)
allow, and evaluates a body only on the pairs its predicate accepts.  The
CUDA kernel runs on the card only (chip_smoke.py holds its outputs, and
its per-warp pair counts against ``pair_flat.warp_pairs``, there).  Here
``pair_flat.walk_filter``, the filter's box and reach test in torch,
checks on the CPU that the filter drops no pair a body accepts: on
columns whose tiles' z-windows wrap the box and whose last tile is partly
filled, with and without a ghost ``active_i`` subset, for every body of
the kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from swift_subtask_dev_tpu_torch.grid import CellGrid, bucket_fields
from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
from swift_subtask_dev_tpu_torch.models.sph.sphenix import (CosmoFactors,
                                                            SPHENIXParams)
from swift_subtask_dev_tpu_torch.ops import hydro_flat, pair_flat
from swift_subtask_dev_tpu_torch.probes import probe_kernel

CPU = torch.device("cpu")
# gravity of the fused and P2P passes: G, softening, split scale, cut
GRAV = dict(G=1.0, H_soft=0.05, r_s=0.05, r_cut=0.2)


@pytest.fixture(scope="module")
def state():
    """1,458 particles on 3 x 3 columns (162 each: a full tile and a
    partly filled one, whose z-windows wrap), with per-particle h and
    finite hydro fields, time bins and a 5% active set."""
    ic = uniform_box_ic(n=9, jitter=0.25, seed=11)
    rng = np.random.default_rng(4)
    n = len(ic["pos"])
    grid = CellGrid.build_columns(ic["box"], 0.3, ic["pos"])
    assert grid.cdim == (3, 3, 1)
    base = {"h": ic["h"] * rng.uniform(0.8, 1.2, n),
            "m": ic["m"], "v": rng.normal(0, 0.3, (n, 3)),
            "u": rng.uniform(0.5, 1.5, n), "rho": rng.uniform(0.8, 1.2, n),
            "pressure": rng.uniform(0.5, 1.5, n),
            "soundspeed": rng.uniform(0.5, 1.5, n),
            "f_gradh": rng.uniform(0.9, 1.1, n),
            "balsara": rng.uniform(0, 1, n),
            "alpha_visc": rng.uniform(0, 1, n),
            "alpha_diff": rng.uniform(0, 1, n),
            "time_bin": rng.integers(1, 30, n).astype(np.float32),
            "active": (rng.uniform(size=n) < 0.05).astype(np.float32)}
    out, mask, off, n_over = bucket_fields(grid, ic["pos"], base,
                                           device=CPU, zsort=True)
    assert int(n_over) == 0
    s = {"mask": mask, "off": off, **out}
    s["time_bin"] = s["time_bin"].to(torch.int32)
    counts = (mask > 0).sum(1)
    assert grid.K == 256 and bool(((counts > 128) & (counts < 256)).all())
    return grid, s


def _passes(s):
    p, cosmo = SPHENIXParams(), CosmoFactors.no_cosmo()
    return {
        "density": hydro_flat.density_pass(s, p),
        "gradient": hydro_flat.gradient_pass(s, p, cosmo),
        "force": hydro_flat.force_pass(s, p, cosmo),
        "force_gravity": hydro_flat.force_gravity_pass(s, p, cosmo,
                                                       **GRAV),
        "p2p_gravity": hydro_flat.p2p_gravity_pass(s, **GRAV),
        "timebin": hydro_flat.timebin_pass(s, p),
        "chem_smooth": hydro_flat.chem_smooth_pass(
            {**s, "Z": 0.01 * s["u"], "elem_frac": 0.1 * torch.stack(
                [s["balsara"], s["alpha_visc"], s["alpha_diff"]] * 3, -1)},
            p),
    }


def _check_walk(grid, pp, active_i=None):
    """The filter model on one launch: it drops no accepted pair, passes no
    more rows than the warp stages, and passes rows to every warp that
    evaluates pairs.  Returns the launch, the model, the pairs each warp
    evaluates (from the plain version's per-slot counts) and the plain
    version's statistics."""
    launch = pair_flat.prepare(grid, pp, active_i)
    model = pair_flat.walk_filter(launch, pp.body)
    assert model["dropped"] == 0
    staged, passed = model["staged"], model["passed"]
    assert bool((passed <= staged).all())
    plain = {}
    pair_flat.pair_apply_plain(launch, pp.body, plain)
    wp = pair_flat.warp_pairs(launch, pp.body, plain["slot_pairs"])
    assert wp.shape == passed.shape
    assert bool(((wp == 0) | (passed > 0)).all())
    # live slots are always walked: the warps evaluate at least the true
    # pairs, and the per-slot counts add up to them over live slots
    live = launch.Xi[pp.body.fields.index("mask")] > 0
    assert int(plain["slot_pairs"][live].sum()) == plain["pairs"]
    assert int(wp.sum()) >= plain["pairs"] > 0
    return launch, model, wp


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("name", ["density", "gradient", "force",
                                  "force_gravity", "p2p_gravity", "timebin",
                                  "chem_smooth"])
def test_walk_filter_keeps_every_accepted_pair(state, name, active):
    grid, s = state
    pp = _passes(s)[name]
    act = None
    if active:
        rng = np.random.default_rng(8)
        act = torch.from_numpy((rng.uniform(size=tuple(s["mask"].shape))
                                < 0.01) & (s["mask"].numpy() > 0))
    launch, model, wp = _check_walk(grid, pp, act)
    staged, passed = int(model["staged"].sum()), int(model["passed"].sum())
    if active:    # tiles with no active slot walk nothing
        tile_act = act.reshape(9, -1, 128).any(dim=2)
        assert 0 < int(tile_act.sum()) < int((launch.tcounts).sum())
        assert bool((model["staged"][~tile_act] == 0).all())
        assert bool((model["passed"][~tile_act] == 0).all())
        assert bool((wp[~tile_act] == 0).all())
    if name == "timebin":   # only active rows with a bin pass
        assert passed < staged // 10
    else:
        assert passed < staged


@pytest.mark.parametrize("name", pair_flat.PROBE_BODY_NAMES)
def test_walk_filter_keeps_every_accepted_pair_of_the_probes(name):
    """The cost probe's bodies; A00 accepts every pair, so its warps pass
    every live staged row."""
    grid, f = probe_kernel.geometry(n1=9, reach=0.3, device=CPU)
    pp = next(p for p in probe_kernel.probe_passes(f) if p.body.name == name)
    launch, model, wp = _check_walk(grid, pp)
    if name == "probe_a00":
        # the live rows of the walked spans, passed by every warp that
        # holds a live slot (the probe's empty slots are all alike: the
        # kernel evaluates one of them and copies it)
        Ncol, W = launch.ncx * launch.ncy, launch.W
        live = (f["mask"] > 0).reshape(Ncol, W)
        warps = live.reshape(Ncol, -1, pair_flat.WARPS, 32).any(-1).sum(-1)
        nbr = torch.as_tensor(pair_flat.nbr_col_table(grid)).long()
        w = launch.ranges.long()
        s0 = (w & 0xFFFF) * pair_flat.GRAN
        e0 = s0 + ((w >> 16) & 0xFFFF) * pair_flat.GRAN
        rows = torch.arange(W)
        n_live = 0
        for c in range(Ncol):
            for t in range(int(launch.tcounts[c])):
                for o in range(9):
                    for run in range(2):
                        span = (rows >= s0[c, t, o, run]) & (
                            rows < e0[c, t, o, run])
                        n_live += int(warps[c, t]) * int(
                            (live[nbr[c, o]] & span).sum())
        assert int(model["passed"].sum()) == n_live


def test_walked_slots_leave_out_the_copies_of_the_representative(state):
    """A tile's empty slots bit-identical to its first empty slot are not
    walked (the kernel copies that slot's outputs to them); an empty slot
    whose fields differ, and every live slot, is."""
    grid, s = state
    pp = _passes(s)["density"]
    launch = pair_flat.prepare(grid, pp)
    mask_f, off0_f = pp.body.fields.index("mask"), pp.body.fields.index(
        "off0")
    Ncol, W = launch.ncx * launch.ncy, launch.W
    empty = ~(launch.Xi[mask_f].reshape(Ncol, -1, 128) > 0)
    c, t = 0, int(launch.tcounts[0]) - 1        # a partly filled tile
    slots = torch.nonzero(empty[c, t]).flatten()
    assert len(slots) > 2
    odd = int(slots[2])
    xi = launch.Xi.clone()
    xi[off0_f, c * W + t * 128 + odd] += 0.5    # one empty slot differs
    launch = dataclasses.replace(launch, Xi=xi)
    walked = pair_flat.walked_slots(launch, mask_f).reshape(Ncol, -1, 128)
    live = ~empty
    assert bool(walked[live].all())
    want = live[c, t].clone()
    want[odd] = True
    assert torch.equal(walked[c, t], want)


def test_reach_bounds_cover_every_kernel_body():
    assert set(pair_flat.REACH2) == set(pair_flat.BODY_NAMES
                                        + pair_flat.PROBE_BODY_NAMES)


def test_kernel_wrapper_refuses_cpu_tensors(state):
    """The CUDA wrapper takes only tensors on the card (the CPU goes to the
    plain version, through pair_apply)."""
    grid, s = state
    pp = _passes(s)["density"]
    launch = pair_flat.prepare(grid, pp)
    with pytest.raises(ValueError, match="contiguous"):
        pair_flat.pair_apply_kernel(launch, pp.body, {})

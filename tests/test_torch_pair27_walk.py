"""The 27-cell kernels' shared walk (csrc/walk27.cuh, ops/walk27.py): the
warps of walked slots, the warp filter and the active subset, through
their plain versions.

The kernels K2 (``pair_packed``) and K3 (``pair_ring``) pack each cell's
walked i slots (live, and active when the caller passes a subset) 32 to a
warp, keep per warp only the staged j rows that a box around its slots
and the body's reach bounds (``pair_flat.REACH2``) allow, and evaluate a
body only on the pairs its predicate accepts.  The CUDA kernels run on
the card only (chip_smoke.py holds their outputs, and their per-warp pair
counts against ``walk27.warp_pairs``, there).  Here, with no reference
engine run: the warp table holds every walked slot once, in slot order;
``walk_filter``, the filter's box and reach test in torch, drops no pair
that a body accepts, on K2's geometry and on K3's with live slots past a
hole, with and without a subset; a subset's slots read what the full pass
gives them and every other slot reads 0.
"""

import numpy as np
import pytest
import torch

from swift_subtask_dev_tpu_torch.grid import CellGrid, bucket_fields
from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
from swift_subtask_dev_tpu_torch.models.sph.sphenix import (CosmoFactors,
                                                            SPHENIXParams)
from swift_subtask_dev_tpu_torch.ops import (hydro_flat, pair_packed,
                                             pair_ring, walk27)

CPU = torch.device("cpu")
ENGINES = {"packed": pair_packed, "ring": pair_ring}
BODIES = ["density", "gradient", "force"]


def _fields(s, c, n):
    """The state with cell c's live slot n - 1 moved to slot n + 2, past a
    hole of three slots."""
    out = {}
    for k, v in s.items():
        v = v.clone()
        if v.dim() >= 2 and tuple(v.shape[:2]) == tuple(s["mask"].shape):
            v[c, n + 2] = v[c, n - 1]
            v[c, n - 1] = 0
        out[k] = v
    return out


@pytest.fixture(scope="module")
def states():
    """1,458 particles on 3 x 3 x 3 cells (~54 a cell, non-z-sorted), with
    per-particle h and finite hydro fields; as bucketed (front-packed, the
    packed engine's) and with one cell's last live slot past a hole (the
    ring engine's)."""
    ic = uniform_box_ic(n=9, jitter=0.25, seed=5)
    rng = np.random.default_rng(6)
    n = len(ic["pos"])
    grid = CellGrid.build_for_positions(ic["box"], 0.3, ic["pos"])
    assert grid.cdim == (3, 3, 3)
    base = {"h": ic["h"] * rng.uniform(0.8, 1.2, n),
            "m": ic["m"], "v": rng.normal(0, 0.3, (n, 3)),
            "u": rng.uniform(0.5, 1.5, n), "rho": rng.uniform(0.8, 1.2, n),
            "pressure": rng.uniform(0.5, 1.5, n),
            "soundspeed": rng.uniform(0.5, 1.5, n),
            "f_gradh": rng.uniform(0.9, 1.1, n),
            "balsara": rng.uniform(0, 1, n),
            "alpha_visc": rng.uniform(0, 1, n),
            "alpha_diff": rng.uniform(0, 1, n),
            "time_bin": rng.integers(1, 30, n).astype(np.float32)}
    out, mask, off, n_over = bucket_fields(grid, ic["pos"], base,
                                           device=CPU, zsort=False)
    assert int(n_over) == 0
    s = {"mask": mask, "off": off, **out}
    s["time_bin"] = s["time_bin"].to(torch.int32)
    live = mask > 0
    c = 4
    holey = _fields(s, c, int(live[c].sum()))
    act = torch.from_numpy(rng.uniform(size=tuple(mask.shape)) < 0.1)
    return grid, {"packed": s, "ring": holey}, act


def _pass(s, name):
    p, cosmo = SPHENIXParams(), CosmoFactors.no_cosmo()
    if name == "density":
        return hydro_flat.density_pass(s, p)
    if name == "gradient":
        return hydro_flat.gradient_pass(s, p, cosmo)
    return hydro_flat.force_pass(s, p, cosmo)


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("name", BODIES)
@pytest.mark.parametrize("engine", ["packed", "ring"])
def test_walk_filter_keeps_every_accepted_pair(states, engine, name,
                                               active):
    """The filter model drops no accepted pair, passes fewer rows than the
    warps stage, and passes rows to every warp that evaluates pairs; the
    plain version's pairs per warp add up to its pairs."""
    grid, s, act = states
    mod = ENGINES[engine]
    pp = _pass(s[engine], name)
    launch = mod.prepare(grid, pp, act if active else None)
    model = mod.walk_filter(launch, pp.body)
    assert model["dropped"] == 0
    staged, passed = model["staged"], model["passed"]
    assert bool((passed <= staged).all())
    assert int(passed.sum()) < int(staged.sum()) // 2
    plain = {}
    mod.pair_apply_plain(launch, pp.body, plain)
    wp = walk27.warp_pairs(launch, plain["slot_pairs"])
    assert wp.shape == passed.shape and bool((wp > 0).all())
    assert int(wp.sum()) == plain["pairs"]
    walked = launch.walked.reshape(-1)
    assert bool((plain["slot_pairs"][~walked] == 0).all())
    if active:
        live = s[engine]["mask"] > 0
        assert torch.equal(launch.walked, live & act)
        assert 0 < int(launch.walked.sum()) < int(live.sum()) // 5


@pytest.mark.parametrize("engine", ["packed", "ring"])
def test_warp_table_holds_each_walked_slot_once_in_slot_order(states,
                                                              engine):
    """Every walked slot sits in exactly one warp lane; a cell's walked
    slots fill its warps 32 at a time in slot order; no warp is empty;
    blocks hold consecutive warps of one cell, at most wpb of them."""
    grid, s, act = states
    for walked in (s[engine]["mask"] > 0, (s[engine]["mask"] > 0) & act):
        wslot, blocks, wpb = walk27.warp_table(walked)
        C, K = walked.shape
        ws = wslot.reshape(-1, 32).long()
        assert bool((ws[:, 0] >= 0).all())               # no empty warp
        got = ws[ws >= 0]
        want = torch.nonzero(walked.reshape(-1)).flatten()
        assert torch.equal(got, want)                   # once, in order
        n_c = walked.sum(1)
        wcell = ws[:, 0] // K
        assert bool(((ws // K == wcell[:, None]) | (ws < 0)).all())
        assert torch.equal(torch.bincount(wcell, minlength=C),
                           (n_c + 31) // 32)
        # lanes past a cell's last slot only in its last warp
        last = torch.cat([wcell[1:] != wcell[:-1], torch.tensor([True])])
        assert bool((ws[~last] >= 0).all())
        b = blocks.long()
        assert 1 <= wpb <= walk27.MAX_WARPS
        assert bool(((b[:, 2] >= 1) & (b[:, 2] <= wpb)).all())
        assert torch.equal(torch.repeat_interleave(b[:, 0], b[:, 2]),
                           wcell)
        assert torch.equal(torch.repeat_interleave(b[:, 1], b[:, 2])
                           + torch.cat([torch.arange(int(k))
                                        for k in b[:, 2]]),
                           torch.arange(ws.shape[0]))


def test_block_width_takes_the_fewest_warp_slots():
    """wpb minimises (warps of each block + its producer) over the cells:
    one warp a cell -> 1; three -> 3; two -> 2."""
    assert walk27.choose_wpb(np.array([1, 1, 0, 1])) == 1
    assert walk27.choose_wpb(np.array([3, 3, 3, 2])) == 3
    assert walk27.choose_wpb(np.array([2, 2, 2])) == 2
    assert walk27.choose_wpb(np.array([0, 0])) == 1


def test_ring_rows_are_each_cells_live_slots_in_slot_order(states):
    """K3's j side: each cell's live slots first, in slot order, with the
    slot past the hole among them; the dead rows after them."""
    grid, s, _ = states
    live = s["ring"]["mask"] > 0
    rows = pair_ring.live_rows(live)
    for c in range(grid.C):
        want = torch.cat([torch.nonzero(live[c]).flatten(),
                          torch.nonzero(~live[c]).flatten()])
        assert torch.equal(rows[c], want)
    pp = _pass(s["ring"], "density")
    launch = pair_ring.prepare(grid, pp)
    xa = launch.Xa.reshape(grid.C, launch.KJ, -1)
    n = int(live[4].sum())
    assert torch.equal(launch.counts, live.sum(1).to(torch.int32))
    assert bool((xa[4, :n, 0] > 0).all()) and bool((xa[4, n:, 0] == 0).all())
    assert torch.equal(xa[4, n - 1], launch.Xi[:, 4 * grid.K + n + 2])


@pytest.mark.parametrize("name", BODIES)
@pytest.mark.parametrize("engine", ["packed", "ring"])
def test_subset_slots_read_the_full_pass(states, engine, name):
    """With an active subset, the active live slots read the full pass's
    outputs bit for bit and every other slot reads 0 (both from the plain
    version)."""
    grid, s, act = states
    mod = ENGINES[engine]
    pp = _pass(s[engine], name)
    full = mod.pair_apply_plain(mod.prepare(grid, pp), pp.body)
    sub = mod.pair_apply_plain(mod.prepare(grid, pp, act), pp.body)
    on = ((s[engine]["mask"] > 0) & act).reshape(-1)
    assert torch.equal(sub[:, on], full[:, on])
    assert bool((sub[:, ~on] == 0).all())
    assert bool((full[:, ~(s[engine]["mask"] > 0).reshape(-1)] == 0).all())


def test_kernel_wrappers_refuse_cpu_tensors(states):
    grid, s, _ = states
    for engine, mod in ENGINES.items():
        pp = _pass(s[engine], "density")
        launch = mod.prepare(grid, pp)
        with pytest.raises(ValueError, match="contiguous"):
            mod.pair_apply_kernel(launch, pp.body, {})

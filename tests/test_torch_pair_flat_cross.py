"""Port vs reference: K1's cross-species mode and the multi-species P2P loop.

Two species on one column grid, each bucketed (z-sorted) with its own
column capacity (W_i = 256 for the gas, W_j = 384 for the DM): the gas of
``uniform_box_ic(n=8, jitter=0.25, seed=7)`` and 1,024 DM particles drawn
uniformly (seed 2), P2P gravity with mesh_N = 32 and the softenings
H_gas = 0.06, H_dm = 0.09.  The reference's flat kernel runs in the
Pallas interpreter.

* the cross-species range words bit for bit (``_block_ranges`` with the
  j species' mask, z and h);
* the cross-mode plain version against ``pallas_flat.pair_apply(...,
  fields_j=...)``, raw outputs on every slot, within 1e-5 of max;
* ``walk_filter`` on a cross launch, both directions: no accepted pair
  dropped;
* ``hydro_flat.p2p_gravity_loop`` against ``hydro_pallas.p2p_gravity_loop``
  for each receiver from both species, with the two softenings: 1e-5 of
  max.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.grid import bucket_fields as ref_bucket
from swift_subtask_dev_tpu.ops import hydro_pallas, pallas_flat
from swift_subtask_dev_tpu.ops import p2p_gravity as ref_pg
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.grid.cellgrid import global_positions
from swift_subtask_dev_tpu_torch.ics import uniform_box_ic
from swift_subtask_dev_tpu_torch.interop import state_from_reference
from swift_subtask_dev_tpu_torch.ops import hydro_flat, pair_flat

CPU = torch.device("cpu")
G, MESH_N = 1.0, 32
R_S = 1.25 / MESH_N
R_CUT = 4.5 * R_S
H_GAS, H_DM = 0.06, 0.09
W_GAS, W_DM = 256, 384


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


@pytest.fixture(scope="module")
def species():
    """(reference grid, port grid, {name: numpy tiles}) with W_i != W_j."""
    ic = uniform_box_ic(n=8, jitter=0.25, seed=7)
    n = len(ic["pos"])
    pos_dm = np.random.default_rng(2).uniform(0, 1, (n, 3))
    g0 = RefGrid.build_columns(ic["box"], R_CUT * 1.15,
                               np.concatenate([ic["pos"], pos_dm]))
    assert g0.K <= W_GAS
    tiles = {}
    for name, pos, m, W in (("gas", ic["pos"], ic["m"], W_GAS),
                            ("dm", pos_dm, np.full(n, 2.0 / n, np.float32),
                             W_DM)):
        g = RefGrid(g0.box, g0.cdim, W)
        out, mask, off, n_over = ref_bucket(
            g, jnp.asarray(pos), {"m": jnp.asarray(m)}, zsort=True)
        assert int(n_over) == 0
        tiles[name] = {"mask": np.asarray(mask), "off": np.asarray(off),
                       "m": np.asarray(out["m"])}
    return (RefGrid(g0.box, g0.cdim, W_GAS), CellGrid(g0.box, g0.cdim, W_GAS),
            tiles)


def _ref_grav_fields(s):
    f = {"mask": jnp.asarray(s["mask"])}
    for k in range(3):
        f[f"off{k}"] = jnp.asarray(s["off"][..., k])
    f["h"] = jnp.full_like(f["mask"], jnp.float32(R_CUT))
    f["m"] = jnp.asarray(s["m"])
    return f


def _ref_pair_fn(H_pair):
    H_inv, r_s_inv, r_cut2 = 1.0 / H_pair, 1.0 / R_S, R_CUT ** 2

    def pair_fn(sf, nf, dx, r2, sc):
        ok = r2 < r_cut2
        F, P = ref_pg.force_pot_factors(r2, H_inv, r_s_inv, True)
        gm = G * nf("m")
        gmF = gm * F
        return ok, [-gmF * dx[0], -gmF * dx[1], -gmF * dx[2], -gm * P], []
    return pair_fn


def _port(t, name):
    return state_from_reference(t[name], CPU)


def _cross_launch(g_port, t, i, j, H):
    pp = hydro_flat.p2p_gravity_pass(_port(t, i), G, H, R_S, R_CUT,
                                     s_j=_port(t, j))
    return pair_flat.prepare(g_port, pp), pp


def test_cross_launch_layout(species):
    """The j side is the other species' AoS with its own capacity; the i
    side's tiles, range words and outputs keep W_i."""
    _, g_port, t = species
    launch, pp = _cross_launch(g_port, t, "gas", "dm", H_DM)
    Ncol = g_port.C
    assert launch.cross and (launch.W, launch.Wj) == (W_GAS, W_DM)
    assert tuple(launch.Xi.shape) == (6, Ncol * W_GAS)
    assert tuple(launch.Xa.shape) == (Ncol * W_DM, 6)
    assert tuple(launch.ranges.shape) == (Ncol, W_GAS // 128, 9, 2)
    assert torch.equal(launch.Xa[:, 0].reshape(Ncol, W_DM),
                       torch.from_numpy(t["dm"]["mask"].copy()))
    assert pair_flat.launch_name(pp.body, launch) == "p2p_gravity_cross"
    same = pair_flat.prepare(
        g_port, hydro_flat.p2p_gravity_pass(_port(t, "gas"), G, H_GAS, R_S,
                                            R_CUT))
    assert not same.cross and same.Wj == same.W == W_GAS
    assert pair_flat.launch_name(pp.body, same) == "p2p_gravity"


def test_cross_block_range_words_bit_identical(species):
    g_ref, g_port, t = species
    i, j = t["gas"], t["dm"]
    hi = np.full_like(i["mask"], R_CUT)
    hj = np.full_like(j["mask"], R_CUT)
    ref = pallas_flat._block_ranges(
        g_ref, jnp.asarray(i["mask"]), jnp.asarray(i["off"][..., 2]),
        jnp.asarray(hi), 1.0, False, jnp.asarray(j["mask"]),
        jnp.asarray(j["off"][..., 2]), jnp.asarray(hj),
        jb=pair_flat.GRAN)
    port = pair_flat._block_ranges(
        g_port, torch.from_numpy(i["mask"].copy()),
        torch.from_numpy(i["off"][..., 2].copy()), torch.from_numpy(hi),
        1.0, False, jb=pair_flat.GRAN,
        maskf_j=torch.from_numpy(j["mask"].copy()),
        zf_j=torch.from_numpy(j["off"][..., 2].copy()),
        hf_j=torch.from_numpy(hj))
    assert np.array_equal(np.asarray(ref), port.numpy())
    # the words count the j species' blocks: some reach past W_i / GRAN
    end = (port & 0xFFFF) + ((port >> 16) & 0xFFFF)
    assert int(end.max()) * pair_flat.GRAN > W_GAS


def test_cross_plain_matches_reference_kernel(species):
    """Raw outputs of a cross launch (gas from DM) on every slot."""
    g_ref, g_port, t = species
    fi, fj = _ref_grav_fields(t["gas"]), _ref_grav_fields(t["dm"])
    order = list(fi)
    raw, _ = pallas_flat.pair_apply(
        g_ref, fi, order, _ref_pair_fn(max(H_GAS, H_DM)), n_sum=4, n_max=0,
        shifts_scale=g_ref.edge, interpret=True, range_scale=1.0,
        fields_j=fj, field_order_j=order)
    launch, pp = _cross_launch(g_port, t, "gas", "dm", max(H_GAS, H_DM))
    stats = {}
    out = pair_flat.pair_apply_plain(launch, pp.body, stats)
    assert stats["pairs"] > 0
    for q, ref in enumerate(np.asarray(r) for r in raw):
        port = out[q].reshape(ref.shape).numpy()
        assert _rel_max(ref, port) <= 1e-5, q


@pytest.mark.parametrize("i,j", [("gas", "dm"), ("dm", "gas")])
def test_walk_filter_drops_no_cross_pair(species, i, j):
    _, g_port, t = species
    launch, pp = _cross_launch(g_port, t, i, j, max(H_GAS, H_DM))
    f = pair_flat.walk_filter(launch, pp.body)
    assert f["dropped"] == 0
    assert 0 < int(f["passed"].sum()) < int(f["staged"].sum())
    # every pair the plain version accepts lies in a walked warp
    stats = {}
    pair_flat.pair_apply_plain(launch, pp.body, stats)
    wp = pair_flat.warp_pairs(launch, pp.body, stats["slot_pairs"])
    assert int(wp.sum()) >= stats["pairs"] > 0


def test_p2p_gravity_loop_matches_reference(species):
    """Each receiver from both species (its own through the one-species
    launch, the other through the cross launch), H = max(H_i, H_j)."""
    g_ref, g_port, t = species
    ref_sp = [{k: jnp.asarray(v) for k, v in t[n].items()}
              for n in ("gas", "dm")]
    sp = [_port(t, "gas"), _port(t, "dm")]
    for k in range(2):
        ref_acc, ref_pot = (np.asarray(x) for x in
                            hydro_pallas.p2p_gravity_loop(
                                g_ref, ref_sp[k], ref_sp, G,
                                (H_GAS, H_DM)[k], R_S, R_CUT,
                                interpret=True, H_soft_j=[H_GAS, H_DM]))
        acc, pot = hydro_flat.p2p_gravity_loop(
            g_port, sp[k], sp, G, (H_GAS, H_DM)[k], R_S, R_CUT,
            H_soft_j=[H_GAS, H_DM])
        assert acc.shape == ref_acc.shape and pot.shape == ref_pot.shape
        assert _rel_max(ref_acc, acc.numpy()) <= 1e-5, k
        assert _rel_max(ref_pot, pot.numpy()) <= 1e-5, k
        assert np.abs(ref_acc).max() > 0


def test_cross_capacity_and_prefix_checks(species):
    """A j capacity off the granule, and a live j row past its column's
    count, are refused."""
    _, g_port, t = species
    dm = _port(t, "dm")
    bad = {k: v[:, :W_DM - 8] for k, v in dm.items() if k != "drift_accum"}
    with pytest.raises(ValueError, match="multiple of"):
        pair_flat.prepare(g_port, hydro_flat.p2p_gravity_pass(
            _port(t, "gas"), G, H_DM, R_S, R_CUT, s_j=bad))
    hole = {**dm, "mask": dm["mask"].clone()}
    hole["mask"][0, 0] = 0.0          # column 0's first live row emptied
    launch, pp = _cross_launch(g_port, {**t, "dm": {
        k: v.numpy() for k, v in hole.items()}}, "gas", "dm", H_DM)
    with pytest.raises(ValueError, match="front-packed"):
        pair_flat.pair_apply_plain(launch, pp.body)


def test_range_words_reach_particles_drifted_across_z():
    """Between rebuckets the drift does not wrap z: a column's top rows
    may sit above the box.  When a whole 16-row block does, the port's
    range words still name it for an i tile at the bottom of the box, so
    its pairs (periodic images just below z = 0) are evaluated; the
    reference's words, clamped to the box, miss them.  The layout:
    uniform_box_ic(n=14) on 4 x 4 columns (~343 a column, W = 512)."""
    ic = uniform_box_ic(n=14, jitter=0.1, seed=3)
    g_ref = RefGrid.build_columns(ic["box"], R_CUT * 1.15, ic["pos"])
    g_port = CellGrid(g_ref.box, g_ref.cdim, g_ref.K)
    out, mask, off, _ = ref_bucket(g_ref, jnp.asarray(ic["pos"]),
                                   {"m": jnp.asarray(ic["m"])}, zsort=True)
    gas = {"mask": np.array(mask), "off": np.array(off),
           "m": np.array(out["m"])}
    n = int((gas["mask"][0] > 0).sum())
    top = 16 * ((n - 1) // 16)               # the last live block of column 0
    assert n > 2 * 128 and top >= 16
    z = gas["off"][0, top:n, 2]
    gas["off"][0, top:n, 2] = np.float32(1.0) + (z - z.min()) * 0.01 + 1e-3
    # the lowest particle, next (in x, y) to the moved ones
    gas["off"][0, 0, :2] = gas["off"][0, top, :2] + np.float32(0.01)
    st = state_from_reference(gas, CPU)
    pp = hydro_flat.p2p_gravity_pass(st, G, H_GAS, R_S, R_CUT)
    launch = pair_flat.prepare(g_port, pp)
    blk = top // pair_flat.GRAN

    def names_block(words):        # column 0, tile 0, its own column
        return any((w & 0xFFFF) <= blk < (w & 0xFFFF) + ((w >> 16) & 0xFFFF)
                   for w in np.asarray(words)[0, 0, 0].tolist())

    assert names_block(launch.ranges.numpy())
    h = np.full_like(gas["mask"], R_CUT)
    ref = pallas_flat._block_ranges(
        g_ref, jnp.asarray(gas["mask"]), jnp.asarray(gas["off"][..., 2]),
        jnp.asarray(h), 1.0, False, jb=pair_flat.GRAN)
    assert not names_block(ref)
    # slot (0, 0) accepts every live particle within r_cut over periodic
    # images, the moved ones included (a float64 count)
    stats = {}
    pair_flat.pair_apply_plain(launch, pp.body, stats)
    pos = global_positions(g_port, st["off"])
    d = pos[gas["mask"] > 0] - pos[0, 0]
    d -= np.round(d)                       # unit box
    r2 = np.sum(d * d, axis=1)
    want = int(np.sum((r2 > 0) & (r2 < R_CUT ** 2)))
    assert int(stats["slot_pairs"][0]) == want
    moved = pos[0, top:n] - pos[0, 0]
    moved -= np.round(moved)
    assert np.sum(moved * moved, axis=1).min() < R_CUT ** 2

"""Port vs reference: the ring-buffer 27-cell pair engine (K3) and its loops.

One state of the Sedov example (sedov_ic(n=10, E0=100): 2,000 particles,
cdim (3, 3, 3), K = 208, after init_particles() and one step of the port
on the CPU) goes through the port's density, gradient and force loops with
``engine="ring"`` (the plain version) and through the reference's
``hydro_pallas`` loops with ``engine="ring", interpret=True``: sums
within 5e-5 of max (the 27 offsets are summed in another order), maxes
within 1e-6 relative, min_ngb_time_bin exact (the outputs the loops do
not multiply by the mask, on the live slots), and with a seeded ~10%
active subset (``active_i``) every output on its slots, which the port
evaluates alone and the reference in full.  The raw outputs of
``pair_apply`` equal the reference kernel's on every live slot (-inf
where a slot accepted no pair) and read 0 on every empty slot, which the
reference kernel evaluates with its pad fills and its loops discard.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.models.sph.sphenix import CosmoFactors as RefCF
from swift_subtask_dev_tpu.models.sph import sphenix as ref_sphenix
from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as RefP
from swift_subtask_dev_tpu.ops import hydro_pallas, pallas_pairs
from swift_subtask_dev_tpu_torch.examples import sedov
from swift_subtask_dev_tpu_torch.interop import state_from_reference
from swift_subtask_dev_tpu_torch.models.sph.sphenix import CosmoFactors
from swift_subtask_dev_tpu_torch.ops import hydro_flat, pair_ring, walk27

from test_torch_pair_flat import check_library_key
from test_torch_pair_packed import active_subset

CPU = torch.device("cpu")
LOOPS = ["density_loop", "gradient_loop", "force_loop"]


@pytest.fixture(scope="module")
def blast():
    """A Sedov state with moving gas and two populated bins, as numpy (made
    by the packed engine, the cheaper plain version on the CPU)."""
    eng = sedov.make_engine(10, 1.0, "pallas", device=CPU, E0=100.0)
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


def _maxes_match(a, b, what):
    assert np.array_equal(np.isfinite(a), np.isfinite(b)), what
    assert np.array_equal(a == -np.inf, b == -np.inf), what
    f = np.isfinite(a)
    assert np.max(np.abs(a[f] - b[f])
                  / np.maximum(np.abs(a[f]), 1e-30)) <= 1e-6, what


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("loop", LOOPS)
def test_ring_loop_matches_reference(blast, loop, active):
    eng, s, g_ref, P_ref = blast
    assert eng.grid.cdim == (3, 3, 3) and eng.grid.K == 208
    assert len(np.unique(s["time_bin"][s["mask"] > 0])) >= 2
    js = {k: jnp.asarray(v) for k, v in s.items()}
    st = state_from_reference(s, CPU)
    live = s["mask"] > 0
    # with a subset, only its slots (the only ones the port evaluates;
    # the engine merges no other)
    on = active_subset(s) if active else live
    act = torch.from_numpy(on) if active else None
    if loop == "density_loop":
        ref = hydro_pallas.density_loop(g_ref, js, P_ref, interpret=True,
                                        engine="ring")
        port = hydro_flat.density_loop(eng.grid, st, eng.sph, active_i=act,
                                       engine="ring")
    else:
        ref = getattr(hydro_pallas, loop)(g_ref, js, P_ref, RefCF.no_cosmo(),
                                          interpret=True, engine="ring")
        port = getattr(hydro_flat, loop)(eng.grid, st, eng.sph,
                                         CosmoFactors.no_cosmo(),
                                         active_i=act, engine="ring")
    assert ref.keys() == port.keys()
    for k in ref:
        a, b = np.asarray(ref[k]), port[k].numpy()
        if active or k in ("min_ngb_time_bin", "v_sig",
                           "alpha_visc_max_ngb"):
            # not multiplied by the mask: the empty slots hold what each
            # kernel leaves there (the engine merges live particles only)
            a, b = a[on], b[on]
        if k == "min_ngb_time_bin":
            assert a.dtype == b.dtype and np.array_equal(a, b)
        elif k in ("v_sig", "alpha_visc_max_ngb"):
            _maxes_match(a, b, (loop, k))
        else:
            assert _rel_max(a, b) < 5e-5, (loop, k)


def _holey(s, eng):
    """The state with one cell not front-packed: its last live particle
    moved one slot up, past a hole (the ring engine, unlike the packed
    one, relies on no live count)."""
    live = s["mask"] > 0
    c = int(np.nonzero(live.sum(1) < eng.grid.K)[0][0])
    n = int(live[c].sum())
    out = {}
    for k, v in s.items():
        v = v.copy()
        if v.ndim >= 2 and v.shape[:2] == live.shape:
            v[c, n] = v[c, n - 1]
            v[c, n - 1] = 0
        out[k] = v
    assert out["mask"][c, n] > 0 and out["mask"][c, n - 1] == 0
    return out


def test_raw_outputs_on_live_slots_and_zero_on_empty(blast):
    """Raw density-body sums against the reference kernel's
    (``pallas_pairs.pair_apply`` in the interpreter, with the reference's
    own density terms) on every live slot, and 0 on every empty slot, on
    a state with a hole before a live slot."""
    eng, s, g_ref, P_ref = blast
    s = _holey(s, eng)
    pp = hydro_flat.density_pass(state_from_reference(s, CPU), eng.sph)
    sums, maxes = pair_ring.pair_apply(eng.grid, pp)
    out = np.stack([x.numpy() for x in sums])
    assert maxes == [] and out.shape == (8, eng.grid.C, eng.grid.K)
    live = s["mask"] > 0
    assert np.all(out[:, ~live] == 0.0) and np.all(out[0][live] > 0)

    gamma2 = float(P_ref.kernel.gamma2)

    def pair_fn(sf, nf, dx, r2, sc):
        h_i = sf("h")
        dv = tuple(sf(f"v{k}") - nf(f"v{k}") for k in range(3))
        t = ref_sphenix.density_terms(P_ref, dx, r2, sf("hinv"), nf("m"),
                                      dv)
        return r2 < gamma2 * h_i * h_i, [
            t["rho"], t["rho_dh"], t["wcount"], t["wcount_dh"], t["div_v"],
            t["rot_v0"], t["rot_v1"], t["rot_v2"]], []

    ref_sums, _ = pallas_pairs.pair_apply(
        g_ref, {k: jnp.asarray(v.numpy()) for k, v in pp.fields.items()},
        list(pp.body.fields), pair_fn, n_sum=8, n_max=0,
        shifts_scale=g_ref.edge, pad_fills={"h": 1.0}, interpret=True)
    for q in range(8):
        a = np.asarray(ref_sums[q])
        assert (a[~live] != 0).any() or q >= 4   # the reference fills them
        assert _rel_max(a[live], out[q][live]) < 5e-5, q


def test_raw_maxes_minus_inf_where_no_pair(blast):
    """Raw gradient-body maxes read -inf in live slots that accepted no
    pair (particles whose kernel reaches no one) and match the reference
    kernel's on every live slot (its gradient loop with the merged-into
    maxima at -inf passes them through raw)."""
    eng, s, g_ref, P_ref = blast
    s = _holey(s, eng)
    live = s["mask"] > 0
    lonely = np.zeros_like(live)
    lonely[0, :3] = True
    lonely[5, 0] = True
    assert lonely[live].sum() == 4
    s["h"] = np.where(lonely, np.float32(1e-4), s["h"])
    pp = hydro_flat.gradient_pass(state_from_reference(s, CPU), eng.sph,
                                  CosmoFactors.no_cosmo())
    sums, maxes = pair_ring.pair_apply(eng.grid, pp)
    out = np.stack([x.numpy() for x in sums + maxes])
    assert np.all(out[0][lonely] == 0.0)
    assert np.all(out[1:, lonely] == -np.inf)
    assert np.all(np.isfinite(out[:, live & ~lonely]))
    assert np.all(out[:, ~live] == 0.0)

    s["v_sig"] = np.full_like(s["h"], -np.inf)
    s["alpha_visc_max_ngb"] = np.full_like(s["h"], -np.inf)
    ref = hydro_pallas.gradient_loop(
        g_ref, {k: jnp.asarray(v) for k, v in s.items()}, P_ref,
        RefCF.no_cosmo(), interpret=True, engine="ring")
    assert _rel_max(ref["laplace_u"], out[0] * s["mask"]) < 5e-5
    for q, k in ((1, "v_sig"), (2, "alpha_visc_max_ngb")):
        _maxes_match(np.asarray(ref[k])[live], out[q][live], k)


def test_offsets_and_neighbours_match_the_padded_grid():
    """OFFSETS is the reference's order (self at 13), and the wrapped
    neighbour ids are the reference's halo-padded linear neighbours."""
    assert pair_ring.OFFSETS == pallas_pairs.OFFSETS
    assert pair_ring.OFFSETS[13] == (0, 0, 0)
    for cdim in ((3, 4, 5), (4, 3, 3)):
        g = RefGrid((1.0, 1.0, 1.0), cdim, 8)
        (nxp, nyp, nzp), _, _, _, deltas = pallas_pairs._geometry(g, 8)
        ids = np.arange(g.C)
        ix, iy, iz = ids // (cdim[1] * cdim[2]), (ids // cdim[2]) % cdim[1], \
            ids % cdim[2]
        padded = ((ix + 1) * nyp + iy + 1) * nzp + iz + 1
        q = padded[:, None] + np.asarray(deltas)[None, :]
        px, py, pz = q // (nyp * nzp), (q // nzp) % nyp, q % nzp
        ref = (((px - 1) % cdim[0]) * cdim[1] + (py - 1) % cdim[1]) \
            * cdim[2] + (pz - 1) % cdim[2]
        assert np.array_equal(
            walk27.nbr_cell_table(cdim, pair_ring.OFFSETS), ref)


def test_dispatch_plain_on_cpu_and_no_fallback(blast):
    """CPU tensors take the plain version and count no launch; the kernel
    wrapper refuses CPU tensors, and on a machine without nvcc building
    the kernel raises (no silent fallback to the plain version)."""
    eng, s, _, _ = blast
    pair_ring.reset_launches()
    pp = hydro_flat.density_pass(state_from_reference(s, CPU), eng.sph)
    sums, maxes = pair_ring.pair_apply(eng.grid, pp)
    assert len(sums) == 8 and maxes == [] and sums[0].shape == (27, 208)
    assert pair_ring.LAUNCHES == {}
    launch = pair_ring.prepare(eng.grid, pp)
    with pytest.raises(ValueError, match="must be a contiguous"):
        pair_ring.pair_apply_kernel(launch, pp.body)
    tb = hydro_flat.timebin_pass(
        {**state_from_reference(s, CPU),
         "active": torch.ones(eng.grid.C, eng.grid.K)}, eng.sph)
    with pytest.raises(ValueError, match="no kernel for body"):
        pair_ring.pair_apply_kernel(pair_ring.prepare(eng.grid, tb),
                                    tb.body)


def test_library_key_follows_sources_flags_and_compiler(tmp_path,
                                                        monkeypatch):
    assert pair_ring.LIBRARY.sources == ("pair_ring.cu", "walk27.cuh",
                                         "walk.cuh", "pair_bodies.cuh")
    check_library_key(pair_ring.LIBRARY, tmp_path, monkeypatch)

"""Port vs reference: the EAGLE volume's cross-species loops.

On the column grid of the small EAGLE volume (2 x 8^3 sites, 10 stars in
25 Mpc, ``tests/test_cli_eagle.py``'s size), after the port's
``init_particles()`` (so h and rho are the converged ones), with the
stars given a birth time, energy to inject and ejecta, and with a few gas
particles and stars moved one box height up (drifted above the box, as
between rebuckets: the stencil's z-images must still find their pairs):

* ``star_ngb_mass_loop``, ``feedback_apply_loop`` (heating events and
  energy bit for bit), ``star_kernel_weight_loop``,
  ``enrichment_apply_loop``, ``species_wcount_loop`` and
  ``species_h_iterate`` against ``ops/stencil.py`` and
  ``ops/species_ghost.py``;
* chemistry smoothing, the stencil-form plain version and the flat pair
  engine's chemistry body (on the CPU, its plain version), against
  ``stencil.chemistry_smooth_loop``;
* the moved particles' results equal those of the unmoved state.

Sums within 1e-5 of max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift_subtask_dev_tpu.models.sph.sphenix import SPHENIXParams as RefP
from swift_subtask_dev_tpu.ops import species_ghost as ref_sg
from swift_subtask_dev_tpu.ops import stencil as ref_st
from swift_subtask_dev_tpu_torch.engine_multi import zsort_slots
from swift_subtask_dev_tpu_torch.examples import eagle_volume as ev
from swift_subtask_dev_tpu_torch.ops import hydro_flat
from swift_subtask_dev_tpu_torch.ops import species_ghost as port_sg
from swift_subtask_dev_tpu_torch.ops import stencil as port_st

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """torch on two threads in these tests: under several test workers
    per machine its default of one thread per core oversubscribes the
    cores (the reference's XLA runs its own pool beside it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
TI_LO, TI_HI = 123456789, 1


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = b.double().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _jnp(s):
    return {k: jnp.asarray(v.numpy()) for k, v in s.items()
            if isinstance(v, torch.Tensor) and v.dim() >= 2}


def _lift(s, sel, boxz):
    """Move the particles ``sel`` one box height up (their periodic
    positions unchanged)."""
    off = s["off"].clone()
    off[..., 2] = torch.where(sel, off[..., 2] + boxz, off[..., 2])
    return {**s, "off": off}


@pytest.fixture(scope="module")
def volume():
    eng, _, _ = ev.make_engine(n=8, device=CPU)
    eng.init_particles()
    gas, stars = dict(eng.state["gas"]), dict(eng.state["stars"])
    grid, P = eng.grid, eng.sph
    live_s = stars["mask"] > 0
    rng = np.random.default_rng(31)
    C, K_s = stars["mask"].shape
    # most live stars fire; all have ejecta and velocities
    fire = live_s & torch.as_tensor(rng.uniform(0, 1, (C, K_s)) < 0.6)
    stars["fb_energy"] = torch.where(fire, 1.0, 0.0)
    stars["ej_m"] = torch.where(live_s, 0.01 * stars["m"], 0.0)
    stars["ej_mZ"] = 0.1 * stars["ej_m"]
    stars["ej_elem"] = stars["ej_m"][..., None] * torch.as_tensor(
        rng.dirichlet(np.ones(9), (C, K_s)).astype(np.float32))
    stars["v_full"] = torch.as_tensor(
        rng.normal(0, 30, (C, K_s, 3)).astype(np.float32))
    # gas with varied metals
    gas["Z"] = torch.as_tensor(
        rng.uniform(0, 0.02, gas["m"].shape).astype(np.float32))
    gas["elem_frac"] = torch.as_tensor(
        rng.dirichlet(np.ones(9), gas["m"].shape).astype(np.float32))
    boxz = float(grid.box[2])
    lift_g = (gas["mask"] > 0) & (gas["off"][..., 2] < 2.0) & torch.as_tensor(
        rng.uniform(0, 1, gas["mask"].shape) < 0.5)
    lift_s = live_s & (stars["off"][..., 2] < 6.0)
    assert int(lift_g.sum()) > 5 and int(lift_s.sum()) >= 1
    return {"grid": grid, "P": P, "refP": RefP(eta_neighbours=P.eta_neighbours,
                                               CFL=P.CFL),
            "gas": gas, "stars": stars,
            "gas_up": _lift(gas, lift_g, boxz),
            "stars_up": _lift(stars, lift_s, boxz)}


def test_star_ngb_mass_and_kernel_weight_loops(volume):
    g, P, rP = volume["grid"], volume["P"], volume["refP"]
    for up in (False, True):
        gas = volume["gas_up" if up else "gas"]
        st = volume["stars_up" if up else "stars"]
        for name in ("star_ngb_mass_loop", "star_kernel_weight_loop"):
            ref = getattr(ref_st, name)(g, _jnp(st), _jnp(gas), rP)
            got = getattr(port_st, name)(g, st, gas, P)
            assert float(np.asarray(ref).max()) > 0
            assert _rel(ref, got) <= 1e-5, (name, up)
            if up:
                base = getattr(port_st, name)(g, volume["stars"],
                                              volume["gas"], P)
                assert _rel(base, got) <= 1e-5, (name, "images")


def test_feedback_apply_loop_bit_for_bit(volume):
    """Heating events and energy of every gas slot equal the reference's:
    the pair-hash draws are bit for bit and each event adds delta_u."""
    g, P, rP = volume["grid"], volume["P"], volume["refP"]
    du_heat = 7.5e3
    for up in (False, True):
        gas = volume["gas_up" if up else "gas"]
        st = dict(volume["stars_up" if up else "stars"])
        st["fb_ngb_mass"] = port_st.star_ngb_mass_loop(g, st, gas, P)
        # heating probabilities around 0.3 for the firing stars
        st["fb_energy"] = torch.where(st["fb_energy"] > 0, 0.3 * du_heat
                                      * st["fb_ngb_mass"], 0.0)
        du_r, nev_r = ref_st.feedback_apply_loop(
            g, _jnp(gas), _jnp(st), rP, jnp.int32(TI_LO), jnp.int32(TI_HI),
            du_heat)
        du_p, nev_p = port_st.feedback_apply_loop(g, gas, st, P, TI_LO,
                                                  TI_HI, du_heat)
        nev_r = np.asarray(nev_r)
        assert nev_r.sum() > 5
        assert np.array_equal(nev_r, nev_p.numpy())
        assert np.array_equal(np.asarray(du_r), du_p.numpy())
        hot = nev_p > 0
        assert torch.equal(du_p[hot], nev_p[hot].float()
                           * float(np.float32(du_heat)))


def test_enrichment_apply_loop(volume):
    g, P, rP = volume["grid"], volume["P"], volume["refP"]
    for up in (False, True):
        gas = volume["gas_up" if up else "gas"]
        st = dict(volume["stars_up" if up else "stars"])
        st["ej_norm"] = port_st.star_kernel_weight_loop(g, st, gas, P)
        ref = ref_st.enrichment_apply_loop(g, _jnp(gas), _jnp(st), rP)
        got = port_st.enrichment_apply_loop(g, gas, st, P)
        for k in ("dm", "dmZ", "delem", "dp"):
            assert float(np.abs(np.asarray(ref[k])).max()) > 0, k
            assert _rel(ref[k], got[k]) <= 1e-5, (k, up)
        # every star's ejecta is shared out in full
        gave = float(st["ej_m"][st["ej_norm"] > 0].double().sum())
        assert abs(float(got["dm"].double().sum()) - gave) <= 1e-5 * gave


def test_species_ghost(volume):
    """The raw neighbour counts, and the h iteration of every star from
    its load-time guess, on the moved state."""
    g, P, rP = volume["grid"], volume["P"], volume["refP"]
    gas, st = volume["gas_up"], volume["stars_up"]
    ws_r, wd_r = ref_sg.species_wcount_loop(g, _jnp(st), _jnp(gas), rP)
    ws_p, wd_p = port_sg.species_wcount_loop(g, st, gas, P)
    assert _rel(ws_r, ws_p) <= 1e-5 and _rel(wd_r, wd_p) <= 1e-5
    guess = {**st, "h": torch.where(st["mask"] > 0, 0.6 * st["h"], 0.0)}
    act = st["mask"] > 0
    h_r, _, n_r = ref_sg.species_h_iterate(g, _jnp(guess), _jnp(gas), rP,
                                           jnp.asarray(act.numpy()),
                                           max_iter=8)
    h_p, _, n_p = port_sg.species_h_iterate(g, guess, gas, P, act,
                                            max_iter=8)
    assert int(n_r) == n_p > 0
    assert _rel(h_r, h_p) <= 1e-5


def test_chemistry_smoothing_plain_versions(volume):
    """The stencil-form plain version on the moved state, and the flat
    engine's chemistry body (its plain version here) on the z-sorted
    one, against the reference."""
    g, P, rP = volume["grid"], volume["P"], volume["refP"]
    gas_up = volume["gas_up"]
    Z_r, e_r = ref_st.chemistry_smooth_loop(g, _jnp(gas_up), rP)
    Z_p, e_p = port_st.chemistry_smooth_loop(g, gas_up, P)
    assert _rel(Z_r, Z_p) <= 1e-5 and _rel(e_r, e_p) <= 1e-5
    gas = zsort_slots(gas_up)
    Z_k, e_k = hydro_flat.chemistry_smooth_loop(g, gas, P)
    Z_r, e_r = ref_st.chemistry_smooth_loop(g, _jnp(gas), rP)
    assert _rel(Z_r, Z_k) <= 1e-5 and _rel(e_r, e_k) <= 1e-5
    base, _ = port_st.chemistry_smooth_loop(g, volume["gas"], P)
    assert _rel(base, Z_p) <= 1e-5

"""Multi-species engine: gas, dark matter, stars and black holes in one
step.

Port of the gas, DM, star and black-hole branches of the reference's
``engine_multi.py`` (the SmallCosmoVolume configuration, and the EAGLE
volume: ``swift-tpu run.yml --eagle [--black-holes]``).  Each species is
its own padded tile state on the shared column grid, and one step

    drift(all species) -> rebucket(each on its own trigger) -> SPH loops
    (gas) -> chemistry smoothing (gas) -> the stars' and BHs'
    smoothing-length ghost -> short-range gravity (every species from
    every species: K1's one-species and cross-species P2P launches) ->
    black holes (density, reposition, accretion, swallow, AGN heating,
    BH-BH mergers) -> EAGLE thermal feedback -> enrichment -> cooling
    (gas) -> gas KDK, limiter and feedback sync (SNII and AGN heating) ->
    star formation -> KDK of DM, stars and BHs

with the PM mesh over the union of the species on its own split
timestep.  The host owns the timeline, as in ``engine.Engine``.  The
cross-species star loops are ``ops.stencil``'s, the BH loops
``ops.black_holes``' (on the same walk), chemistry smoothing runs on the
flat pair kernel's chemistry body (``hydro_flat.chemistry_smooth_loop``)
and the stars' and BHs' ghost is ``ops.species_ghost``.

Reference hazards that are not copied (ROADMAP.md, queue 3): the flat
pair kernel's range words assume z-sorted columns, so the stars and BHs
are z-sorted when they are loaded and after a step that formed stars,
moved a BH or merged two (the reference leaves them unsorted); star
formation and swallows leave holes in the gas columns, which the
kernel's live-tile counts assume absent, so the gas columns are
compacted after a step that converted gas and right after a swallow,
before the limiter's wake scan (the reference keeps the holes until the
next rebucket); a gas particle swallowed in a step does not also form a
star in it (the reference's star formation takes the step's activity
from before the swallow); and the BH collect loops count each swallowed
particle or merged BH once (``ops.black_holes``).  None changes a
particle's physics otherwise: slots are compared per particle id.

Refused at construction (ROADMAP.md, queue 1 item 9): sinks, neutrinos,
radiative transfer, tracers and external potentials, every
star-formation, feedback and enrichment model but EAGLE's, every BH
model but EAGLE's and the Default (passive) one (the spin-jet model
among them), and every backend but "flat".
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .engine import (Engine, EngineConfig, StepTables, NBINS, F32,
                     I32, _bin_counts, _dm_kdk, _dm_tiles, _f32, _gas_kdk,
                     _gas_loops, _pad_slots, _rebucket_phase, _tb_index,
                     _where_active, apply_wake, bin_from_dt,
                     refuse_unported_mode)
from .grid.cellgrid import CellGrid, bucket_fields
from .models.sph import sphenix
from .models.sph.sphenix import CosmoFactors, SPHENIXParams
from .ops import black_holes as bh_ops
from .ops import hydro_flat, species_ghost, stencil
from .subgrid.black_holes import DefaultBlackHoles, EagleBlackHoles
from .subgrid.chemistry import N_ELEMENTS
from .subgrid.enrichment import EagleEnrichment
from .subgrid.feedback import EagleThermalFeedback
from .subgrid.star_formation import EagleStarFormation
from .utils import timeline as tl

# the species the port runs, in the gravity and mesh lists' order
SPECIES = ("gas", "dm", "stars", "bh")
_REFUSED = ("nu_model", "sink_model", "external_potential", "rt_fn",
            "tracers")
# free star slots a cell keeps after a re-grid (space_extra_sparts)
STAR_EXTRA_SLOTS = 8


def _species_active(sp: Dict, T: StepTables):
    mask_b = sp["mask"] > 0
    tb = _tb_index(sp["time_bin"])
    return mask_b, tb, mask_b & T.active[tb]


def _eps_of(eps_soft, name: str) -> float:
    """Per-species timestep softening: ``eps_soft`` is a float, or a
    (baryon, dm) pair (Gravity:comoving_baryon_softening /
    comoving_DM_softening; timestep.h:141 uses the particle's own):
    stars and black holes take the baryon value."""
    if isinstance(eps_soft, tuple):
        return float(eps_soft[1] if name == "dm" else eps_soft[0])
    return float(eps_soft)


def _norm(a):
    return torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]
                      + a[..., 2] * a[..., 2])


def _apply_gravity(gravity_fn, pool: Dict, acts: Dict):
    """Short-range gravity over the species list: each species from every
    species; active particles take the new a_grav and pot."""
    names = [n for n in SPECIES if n in pool]
    outs = gravity_fn([pool[n] for n in names])
    for n, (acc, pot) in zip(names, outs):
        sp, act = pool[n], acts[n]
        pool[n] = {**sp, "a_grav": _where_active(act, acc, sp["a_grav"]),
                   "pot": torch.where(act, pot, sp["pot"])}
    return pool


def _reorder(sp: Dict, order: torch.Tensor) -> Dict:
    """Every (C, K, ...) tile of a species in the slot order ``order``
    ((C, K) int64, a permutation within each cell)."""
    C, K = order.shape
    out = {}
    for k, v in sp.items():
        if v.dim() >= 2 and tuple(v.shape[:2]) == (C, K):
            idx = order.reshape((C, K) + (1,) * (v.dim() - 2)).expand(
                v.shape)
            out[k] = torch.gather(v, 1, idx)
        else:
            out[k] = v
    return out


def zsort_slots(sp: Dict) -> Dict:
    """A species' live slots first in each cell, in ascending z (the flat
    kernel's column order)."""
    key = torch.where(sp["mask"] > 0, sp["off"][..., 2], float("inf"))
    return _reorder(sp, torch.argsort(key, dim=1, stable=True))


def _live_first(sp: Dict) -> torch.Tensor:
    """The slot order with a species' live slots first in each cell, in
    their order."""
    return torch.argsort((sp["mask"] <= 0).to(torch.int8), dim=1,
                         stable=True)


def compact_slots(sp: Dict) -> Dict:
    """A species' live slots first in each cell, in their order."""
    return _reorder(sp, _live_first(sp))


def _convert_gas_to_stars(grid: CellGrid, gas: Dict, stars: Dict, conv,
                          T: StepTables):
    """Move converted gas particles into free star slots of their cell
    (cell_convert_part.c:cell_convert_part_to_spart): the id and the whole
    gas mass move to the star, stamped with the step's birth time; a
    conversion beyond the cell's free slots is lost (counted).  Returns
    (gas, stars, n_converted, n_lost)."""
    C = grid.C
    K_s = stars["mask"].shape[1]
    dev = conv.device
    n_star = torch.sum(stars["mask"] > 0, dim=1)
    rank = torch.cumsum(conv.to(torch.int64), dim=1) - 1
    dest_slot = n_star[:, None] + rank
    ok = conv & (dest_slot < K_s)
    n_lost = torch.sum(conv & ~ok)
    cid = torch.arange(C, dtype=torch.int64, device=dev)[:, None]
    flat_dest = torch.where(ok, cid * K_s + dest_slot, C * K_s).reshape(-1)

    def scat(star_arr, gas_val):
        tail = tuple(star_arr.shape[2:])
        out = torch.cat([star_arr.reshape((C * K_s,) + tail),
                         torch.zeros((1,) + tail, dtype=star_arr.dtype,
                                     device=dev)], 0)
        out[flat_dest] = gas_val.reshape((-1,) + tail).to(star_arr.dtype)
        return out[:-1].reshape(star_arr.shape)

    new = {"mask": ok.to(F32), "off": gas["off"],
           "a_grav_mesh": gas["a_grav_mesh"], "v_full": gas["v_full"],
           "m": gas["m"], "pid": gas["pid"], "h": gas["h"],
           "time_bin": gas["time_bin"],
           "birth_time": torch.full_like(gas["m"], T.birth_time),
           "birth_density": gas["rho"],
           "fb_done": torch.zeros_like(gas["m"]), "m_init": gas["m"]}
    if "Z" in gas:
        new["Z"] = gas["Z"]
    if "elem_frac" in gas:
        new["elem_frac"] = gas["elem_frac"]
    stars = {**stars, **{k: scat(stars[k], v) for k, v in new.items()
                         if k in stars}}
    # newborn stars carry the gas's drift since its last rebucket
    stars["drift_accum"] = torch.maximum(stars["drift_accum"],
                                         gas["drift_accum"])
    gas = {**gas, "mask": torch.where(ok, 0.0, gas["mask"])}
    return gas, stars, torch.sum(ok), n_lost


def _feedback(grid, p, feedback, gas, stars, T, act_s):
    """EAGLE thermal feedback (stars -> gas).  Returns (gas, stars,
    heated)."""
    energy, fire = feedback.firing_energy(stars, T.birth_time, act_s)
    # only firing stars can heat: their neighbour masses are all it needs
    ngb_mass = stencil.star_ngb_mass_loop(grid, stars, gas, p, sel=fire)
    du_add, nev = stencil.feedback_apply_loop(
        grid, gas, {**stars, "fb_energy": energy, "fb_ngb_mass": ngb_mass},
        p, T.ti_lo, T.ti_hi, feedback.delta_u)
    # direct injection into the drifted and the full energy
    # (hydro_set_physical_internal_energy + _drifted, feedback_iact.h)
    gas = {**gas, "u_full": gas["u_full"] + du_add,
           "u": gas["u"] + du_add}
    stars = {**stars, "fb_done": torch.where(fire, 1.0, stars["fb_done"])}
    return gas, stars, nev > 0


def _enrich(grid, p, enrichment, gas, stars, T, stars_act):
    """Stellar enrichment: AGB + SNII mass return and SNIa metals of the
    stars dying this step (feedback/EAGLE/enrichment.h evolve_*), shared
    kernel-weighted over the gas.  Returns (gas, stars, m_enriched)."""
    _, tb_s, act_s = stars_act
    dt_s = T.dt_alpha[tb_s]
    age2 = T.birth_time - stars["birth_time"]
    age1 = torch.clamp_min(age2 - dt_s, 0.0)
    live = act_s & (stars["birth_time"] > 0) & (age2 > 0)
    dm_ej, dmZ_ej, delem_ej = enrichment.ejecta(
        stars["m_init"], stars["Z"], stars["elem_frac"], age1, age2)
    # never eject more than the star has (evolve_* cap), nor without gas
    # neighbours to receive it; the weights only matter to live stars
    norm = stencil.star_kernel_weight_loop(grid, stars, gas, p, sel=live)
    can = live & (norm > 0)
    cap = torch.minimum(dm_ej, 0.9 * stars["m"])
    scale = torch.where(dm_ej > 0, cap / torch.clamp_min(dm_ej, 1e-30), 0.0)
    dm_ej = torch.where(can, cap, 0.0)
    dmZ_ej = torch.where(can, dmZ_ej * scale, 0.0)
    delem_ej = torch.where(can[..., None], delem_ej * scale[..., None], 0.0)
    rec = stencil.enrichment_apply_loop(
        grid, gas, {**stars, "ej_m": dm_ej, "ej_mZ": dmZ_ej,
                    "ej_elem": delem_ej, "ej_norm": norm}, p)
    m_old = gas["m"]
    m_new = m_old + rec["dm"]
    m_inv = 1.0 / torch.clamp_min(m_new, 1e-30)
    got = rec["dm"] > 0
    v_new = (m_old[..., None] * gas["v_full"] + rec["dp"]) * m_inv[..., None]
    gas = {**gas, "m": m_new,
           "v_full": torch.where(got[..., None], v_new, gas["v_full"]),
           "Z": (gas["Z"] * m_old + rec["dmZ"]) * m_inv,
           "elem_frac": (gas["elem_frac"] * m_old[..., None]
                         + rec["delem"]) * m_inv[..., None]}
    stars = {**stars, "m": stars["m"] - dm_ej}
    return gas, stars, torch.sum(rec["dm"])


def _bh_density(grid, p, gas, bh, act_b):
    """The passive (Default) black holes' density pass: the gas density
    and neighbour mass of the active BHs (black_holes/Default)."""
    dens = bh_ops.bh_gas_density_loop(grid, bh, gas, p)
    h_bh = torch.where(bh["mask"] > 0, bh["h"], 1.0)
    return {**bh,
            "rho_gas": torch.where(act_b, dens["rho"] / h_bh ** 3,
                                   bh["rho_gas"]),
            "ngb_mass": torch.where(act_b, dens["ngb_mass"],
                                    bh["ngb_mass"])}


def _black_holes(grid, p, cfg, cosmo, bh_model: EagleBlackHoles, gas, bh,
                 T, bh_act):
    """The EAGLE black holes (runner_black_holes.c: bh_density, bh_swallow,
    do_gas_swallow, bh_feedback; black_holes/EAGLE): density, the
    reposition to the potential minimum, accretion, the swallow (mark,
    collect, apply), AGN heating from the reservoir and BH-BH mergers.
    Only active BHs move, swallow, fire or absorb a merger.  Returns
    (gas, bh, swallowed (C, K_gas) bool, heated (C, K_gas) bool,
    n_agn, n_merged, moved): ``moved`` says whether a BH jumped or
    merged (the columns need re-sorting)."""
    act_b = bh_act[2]
    dens = bh_ops.bh_gas_density_loop(grid, bh, gas, p)
    dt_bh = T.dt_alpha[_tb_index(bh["time_bin"])] * act_b
    moved = False
    # reposition among slow-enough gas neighbours (black_holes.h:193-230,
    # black_holes_iact.h:290)
    if bh_model.reposition_ratio > 0.0 and cfg.eps_soft > 0.0:
        rho = torch.clamp_min(dens["rho"], 1e-30)
        cs = dens["cs_w"] / rho * _f32(cosmo.a_factor_sound_speed)
        found, delta = bh_ops.bh_reposition_loop(
            grid, {**bh, "cs_gas": cs}, gas, p,
            max_dist=bh_model.reposition_ratio * cfg.eps_soft,
            v2_max_fac=bh_model.repos_vel_ratio,
            v2_min_thresh=bh_model.repos_vel_min)
        move = found & act_b
        jump = torch.where(move, _norm(delta), 0.0)
        # jumps count against the rebucket's drift budget
        bh = {**bh, "off": torch.where(move[..., None], bh["off"] + delta,
                                       bh["off"]),
              "drift_accum": bh["drift_accum"] + torch.amax(jump)}
        moved = bool(move.any())

    bh = bh_model.accrete(bh, dens, cosmo, dt_bh)
    bh = {**bh, "swallow_prob": torch.where(act_b, bh["swallow_prob"], 0.0)}

    # swallow: mark, collect, apply (mass and momentum move)
    bid = bh_ops.bh_swallow_target_loop(grid, gas, bh, p, T.ti_lo, T.ti_hi)
    gains = bh_ops.bh_swallow_collect_loop(grid, bh, gas, bid)
    bh = _absorb(bh, gains)
    swallowed = bid >= 0
    gas = {**gas, "mask": torch.where(swallowed, 0.0, gas["mask"])}

    # AGN heating: the reservoir released through the stochastic kernel
    fb_energy, resv = bh_model.agn_fire(bh)
    fb_energy = torch.where(act_b, fb_energy, 0.0)
    bh = {**bh, "energy_reservoir": torch.where(act_b, resv,
                                                bh["energy_reservoir"])}
    du_add, nev = stencil.feedback_apply_loop(
        grid, gas, {**bh, "fb_energy": fb_energy,
                    "fb_ngb_mass": bh["ngb_mass"]},
        p, T.ti_lo, T.ti_hi, bh_model.delta_u)
    gas = {**gas, "u_full": gas["u_full"] + du_add, "u": gas["u"] + du_add}
    n_agn = torch.sum(fb_energy > 0)

    # BH-BH mergers: the lighter onto the heavier when bound and close
    # (black_holes_iact.h runner_iact_nonsym_bh_bh_swallow)
    n_merged = torch.zeros((), dtype=torch.int64, device=n_agn.device)
    if bh_model.merging_ratio > 0.0 and cfg.eps_soft > 0.0:
        vic = bh_ops.bh_merger_mark_loop(
            grid, bh, p, max_dist=bh_model.merging_ratio * cfg.eps_soft,
            G=bh_model.G, threshold=bh_model.merger_threshold)
        vic = torch.where(act_b, vic, -1)           # active victims only
        not_vic = vic < 0
        mg = bh_ops.bh_merger_collect_loop(grid, bh, vic, not_vic)
        consumed = bh_ops.bh_merger_consumed_loop(grid, bh, vic, not_vic)
        bh = _absorb(bh, mg)
        bh = {**bh, "m_subgrid": bh["m_subgrid"] + mg["dms"],
              "energy_reservoir": bh["energy_reservoir"] + mg["dresv"],
              "mask": torch.where(consumed, 0.0, bh["mask"])}
        n_merged = torch.sum(consumed)
        moved = moved or bool(n_merged > 0)
    return gas, bh, swallowed, nev > 0, n_agn, n_merged, moved


def _absorb(bh, gains):
    """A BH's dynamical mass and momentum after it takes in ``gains``
    (dm, dp0-2); its velocity is kept where it took nothing."""
    m_new = bh["m"] + gains["dm"]
    dp = torch.stack([gains["dp0"], gains["dp1"], gains["dp2"]], -1)
    v_new = (bh["m"][..., None] * bh["v_full"] + dp) \
        / torch.clamp_min(m_new, 1e-30)[..., None]
    keep = (gains["dm"] <= 0)[..., None]
    return {**bh, "m": m_new,
            "v_full": torch.where(keep, bh["v_full"], v_new)}


def multi_step(grid: CellGrid, p: SPHENIXParams, cfg: EngineConfig,
               gravity_fn: Optional[Callable], eps_soft,
               cosmo: CosmoFactors, state: Dict[str, Dict], T: StepTables,
               cooling_fn: Optional[Callable] = None, sf=None,
               feedback: Optional[EagleThermalFeedback] = None,
               enrichment: Optional[EagleEnrichment] = None, bh_model=None):
    """One engine step over the {'gas', 'dm', 'stars', 'bh'} species.
    ``sf`` is the (EagleStarFormation, entropy floor or None) pair;
    ``bh_model`` an EagleBlackHoles or DefaultBlackHoles.  Returns
    (new_state, diagnostics)."""
    gas, dm, stars, bh = (state.get(n) for n in SPECIES)
    dev = next(iter(state.values()))["mask"].device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    zf = torch.zeros((), device=dev)
    n_overflow, n_active, too_small_n, n_woken = zero, zero, zero, zero
    n_converted, n_lost, n_heated = zero, zero, zero
    n_swallowed, n_agn, n_bh_merged = zero, zero, zero
    m_enriched = zf
    n_ghost_iter = 0
    h_max_active = zf
    acts = {}
    Z_smooth = None
    heated = bh_heated = None
    bh_moved = False

    # --- drift + rebucket + SPH loops (gas) ---------------------------------
    if gas is not None:
        s = gas
        mask_b, tb, active = _species_active(s, T)
        a_tot = s["a_hydro"] + s["a_grav"] + s["a_grav_mesh"]
        s = {**s,
             "off": s["off"] + s["v_full"] * T.dt_drift
             * s["mask"][..., None],
             "v": s["v"] + a_tot * T.dt_drift}
        s = sphenix.predict_extra(p, s, cosmo, T.dt_drift, T.dt_therm_drift)
        reach = torch.clamp_min(
            torch.amax(torch.where(mask_b, s["h"], 0.0))
            * _f32(p.kernel.gamma), _f32(cfg.p2p_reach))
        s, nov = _rebucket_phase(grid, cfg, s, T, reach)
        n_overflow = n_overflow + nov
        mask_b, tb, active = _species_active(s, T)
        s, n_ghost_iter = _gas_loops(grid, p, cfg, cosmo, s, active,
                                     T.dt_alpha)
        # smoothed chemistry (chemistry/EAGLE/chemistry_iact.h): cooling
        # and star formation take the kernel-smoothed metallicity
        if "Z" in s and "elem_frac" in s and (cooling_fn is not None
                                              or sf is not None):
            Z_smooth, _ = hydro_flat.chemistry_smooth_loop(grid, s, p)
        gas = s
        acts["gas"] = (mask_b, tb, active)
        n_active = n_active + torch.sum(active)
        h_max_active = torch.amax(torch.where(active, s["h"], 0.0))

    # --- drift + rebucket (DM; its reach is the P2P r_cut) -------------------
    if dm is not None:
        d = {**dm, "off": dm["off"] + dm["v_full"] * T.dt_drift
             * dm["mask"][..., None]}
        d, nov = _rebucket_phase(grid, cfg, d, T, _f32(cfg.p2p_reach))
        n_overflow = n_overflow + nov
        dm = d
        acts["dm"] = _species_active(d, T)
        n_active = n_active + torch.sum(acts["dm"][2])

    # --- drift + rebucket (stars) --------------------------------------------
    if stars is not None:
        d = {**stars, "off": stars["off"] + stars["v_full"] * T.dt_drift
             * stars["mask"][..., None]}
        # feedback pairs reach out to gamma h_star: the rebucket trigger
        # protects that range too
        reach_s = _f32(cfg.p2p_reach)
        if feedback is not None:
            reach_s = torch.clamp_min(
                torch.amax(torch.where(d["mask"] > 0, d["h"], 0.0))
                * _f32(p.kernel.gamma), reach_s)
        d, nov = _rebucket_phase(grid, cfg, d, T, reach_s)
        n_overflow = n_overflow + nov
        stars = d
        acts["stars"] = _species_active(d, T)
        n_active = n_active + torch.sum(acts["stars"][2])

    # --- drift + rebucket (black holes) --------------------------------------
    if bh is not None:
        d = {**bh, "off": bh["off"] + bh["v_full"] * T.dt_drift
             * bh["mask"][..., None]}
        # the BH-gas loops reach out to gamma h_bh
        reach_b = _f32(cfg.p2p_reach)
        if bh_model is not None:
            reach_b = torch.clamp_min(
                torch.amax(torch.where(d["mask"] > 0, d["h"], 0.0))
                * _f32(p.kernel.gamma), reach_b)
        d, nov = _rebucket_phase(grid, cfg, d, T, reach_b)
        n_overflow = n_overflow + nov
        bh = d
        acts["bh"] = _species_active(d, T)
        n_active = n_active + torch.sum(acts["bh"][2])

    # --- the stars' ghost (runner_ghost.c:72) before any consumer ------------
    if (cfg.species_ghost_iterations > 0 and gas is not None
            and stars is not None
            and (feedback is not None or enrichment is not None)):
        act_s = acts["stars"][2]
        h_s, _, _ = species_ghost.species_h_iterate(
            grid, stars, gas, p, act_s,
            max_iter=cfg.species_ghost_iterations)
        stars = {**stars, "h": h_s}
        h_max_active = torch.maximum(
            h_max_active, torch.amax(torch.where(act_s, h_s, 0.0)))
    # the BHs' ghost (runner_ghost.c:577): Bondi densities and the
    # reposition and merger radii use the converged ball
    if (cfg.species_ghost_iterations > 0 and gas is not None
            and bh is not None and bh_model is not None):
        act_b = acts["bh"][2]
        h_b, _, _ = species_ghost.species_h_iterate(
            grid, bh, gas, p, act_b, max_iter=cfg.species_ghost_iterations,
            packed=True)
        bh = {**bh, "h": h_b}
        h_max_active = torch.maximum(
            h_max_active, torch.amax(torch.where(act_b, h_b, 0.0)))

    # --- joint gravity (every species sources, every species receives) ------
    if gravity_fn is not None:
        pool = {n: sp for n, sp in zip(SPECIES, (gas, dm, stars, bh))
                if sp is not None}
        pool = _apply_gravity(gravity_fn, pool,
                              {n: a[2] for n, a in acts.items()})
        gas, dm, stars, bh = (pool.get(n) for n in SPECIES)

    # --- black holes (after gravity: the reposition reads the potential) ---
    if bh_model is not None and bh is not None and gas is not None:
        if bh_model.kind == "default":
            bh = _bh_density(grid, p, gas, bh, acts["bh"][2])
        else:
            (gas, bh, swallowed, bh_heated, n_agn, n_bh_merged,
             bh_moved) = _black_holes(grid, p, cfg, cosmo, bh_model, gas,
                                      bh, T, acts["bh"])
            n_swallowed = torch.sum(swallowed)
            if bool(n_swallowed > 0):
                # the swallowed slots are holes that the flat kernel's
                # live-tile counts assume absent, and its wake scan runs
                # later in this step: front-pack the gas now, with the
                # step's per-slot tensors
                order = _live_first(gas)
                gas = _reorder(gas, order)
                acts["gas"] = tuple(torch.gather(x, 1, order)
                                    for x in acts["gas"])
                bh_heated = torch.gather(bh_heated, 1, order)
                if Z_smooth is not None:
                    Z_smooth = torch.gather(Z_smooth, 1, order)

    # --- stellar feedback and enrichment (stars -> gas) ----------------------
    if feedback is not None and stars is not None and gas is not None:
        gas, stars, heated = _feedback(grid, p, feedback, gas, stars, T,
                                       acts["stars"][2])
        n_heated = torch.sum(heated)
    if (enrichment is not None and stars is not None and gas is not None
            and "Z" in gas and "elem_frac" in gas):
        gas, stars, m_enriched = _enrich(grid, p, enrichment, gas, stars, T,
                                         acts["stars"])

    # --- per-species cooling + KDK --------------------------------------------
    bin_counts = torch.zeros(NBINS + 1, dtype=torch.int64, device=dev)
    if gas is not None:
        mask_b, tb, active = acts["gas"]
        if cooling_fn is not None:
            gas_ch = gas if Z_smooth is None else {**gas, "Z": Z_smooth}
            upd = cooling_fn(gas_ch, cosmo, T.dt_therm_full[tb])
            gas = {**gas, **{k: torch.where(active, v, gas[k])
                             for k, v in upd.items()}}
        gas, too_small, woken = _gas_kdk(grid, p, cfg, cosmo, gas, T,
                                         active, mask_b, tb)
        too_small_n = too_small_n + torch.sum(too_small)
        n_woken = n_woken + woken

        # feedback sync: heated inactive particles join the current step
        # (runner_do_sync, runner_time_integration.c:1478); AGN heating
        # syncs through the same machinery
        if bh_heated is not None:
            heated = bh_heated if heated is None else heated | bh_heated
        if heated is not None:
            sync = heated & mask_b & ~active & (gas["time_bin"] > 0)
            new_bin_w = torch.clamp_max(_tb_index(gas["time_bin"]).to(I32),
                                        T.max_active_bin)
            gas = apply_wake(p, cosmo, gas, T, sync, new_bin_w)
            n_woken = n_woken + torch.sum(sync)

        # star formation (runner_do_star_formation, runner_others.c)
        if sf is not None and stars is not None:
            sf_model, sf_floor = sf
            dt_star = T.dt_alpha[tb]
            gas_ch = gas if Z_smooth is None else {**gas, "Z": Z_smooth}
            # a particle swallowed this step is no longer gas: the
            # reference's ``active`` still holds it (ROADMAP.md, queue 3)
            conv, sfr = sf_model.conversion_mask(
                gas_ch, cosmo, dt_star, T.ti_lo, T.ti_hi, sf_floor,
                active & (gas["mask"] > 0))
            # sticky per-particle SFR (star_formation_struct.h)
            if "sfr" in gas:
                gas = {**gas, "sfr": torch.where(active, sfr, gas["sfr"])
                       * gas["mask"]}
            gas, stars, n_converted, n_lost = _convert_gas_to_stars(
                grid, gas, stars, conv, T)
            n_overflow = n_overflow + n_lost
        bin_counts = bin_counts + _bin_counts(gas["mask"] > 0,
                                              gas["time_bin"])
    kicked = {}
    for name, sp in (("dm", dm), ("stars", stars), ("bh", bh)):
        if sp is None:
            continue
        _, tb, active = acts[name]
        sp, too_small = _dm_kdk(cfg, _eps_of(eps_soft, name), sp, T,
                                active, tb)
        too_small_n = too_small_n + torch.sum(too_small)
        # the stars' bins include this step's newborns; the BHs' include
        # those merged this step, as the reference's do
        counted = acts[name][0] if name == "bh" else sp["mask"] > 0
        bin_counts = bin_counts + _bin_counts(counted, sp["time_bin"])
        kicked[name] = sp
    dm, stars, bh = (kicked.get(n) for n in ("dm", "stars", "bh"))

    # the flat kernel's columns: the gas front-packed, the stars and BHs
    # z-sorted (after the KDK: the step's activity masks are by slot)
    if sf is not None and bool(n_converted > 0):
        gas = compact_slots(gas)
        stars = zsort_slots(stars)
    if bh_moved:
        bh = zsort_slots(bh)
    out = {n: sp for n, sp in zip(SPECIES, (gas, dm, stars, bh))
           if sp is not None}
    diag = {
        "bin_counts": bin_counts,
        "n_overflow": n_overflow,
        "n_dt_too_small": too_small_n,
        "n_ghost_iter": n_ghost_iter,
        "n_active": n_active,
        "n_woken": n_woken,
        "h_max_active": h_max_active,
        "n_heated": n_heated,
        "n_converted": n_converted,
        "n_lost": n_lost,
        "m_enriched": m_enriched,
        "n_swallowed": n_swallowed,
        "n_agn": n_agn,
        "n_bh_merged": n_bh_merged,
        # fullest live cell over every species (occupancy re-grid trigger)
        "k_max_live": torch.amax(torch.stack([
            torch.amax(torch.sum(sp["mask"] > 0, dim=1))
            for sp in out.values()])),
    }
    return out, diag


def multi_init(grid: CellGrid, p: SPHENIXParams, cfg: EngineConfig,
               gravity_fn: Optional[Callable], eps_soft,
               cosmo: CosmoFactors, state: Dict[str, Dict], T: StepTables):
    """engine_init_particles for every species: density/ghost, the stars'
    and BHs' ghost, forces, initial bins and the first half-kick
    (engine.c:1893)."""
    gas, dm, stars, bh = (state.get(n) for n in SPECIES)
    dev = next(iter(state.values()))["mask"].device
    n_ghost_iter = 0
    if gas is not None:
        gas, n_ghost_iter = _gas_loops(grid, p, cfg, cosmo, gas,
                                       gas["mask"] > 0, T.dt_alpha * 0.0)
    # the stars' and BHs' h start converged (the load-time h is a guess)
    if cfg.species_ghost_iterations > 0 and gas is not None:
        if stars is not None:
            h_s, _, _ = species_ghost.species_h_iterate(
                grid, stars, gas, p, stars["mask"] > 0,
                max_iter=cfg.species_ghost_iterations)
            stars = {**stars, "h": h_s}
        if bh is not None:
            h_b, _, _ = species_ghost.species_h_iterate(
                grid, bh, gas, p, bh["mask"] > 0,
                max_iter=cfg.species_ghost_iterations, packed=True)
            bh = {**bh, "h": h_b}
    if gravity_fn is not None:
        pool = {n: sp for n, sp in zip(SPECIES, (gas, dm, stars, bh))
                if sp is not None}
        pool = _apply_gravity(gravity_fn, pool,
                              {n: sp["mask"] > 0 for n, sp in pool.items()})
        gas, dm, stars, bh = (pool.get(n) for n in SPECIES)

    bin_counts = torch.zeros(NBINS + 1, dtype=torch.int64, device=dev)
    too_small_n = torch.zeros((), dtype=torch.int64, device=dev)
    if gas is not None:
        mask_b = gas["mask"] > 0
        s = gas
        new_dt = torch.clamp_max(
            torch.minimum(sphenix.compute_timestep(p, s, cosmo),
                          sphenix.timestep_h_change_limit(p, s)),
            _f32(cfg.dt_max))
        if cfg.with_self_gravity:
            c = float(np.float32(2.0 * cfg.eta_grav)
                      * np.float32(_eps_of(eps_soft, "gas")))
            a_norm = _norm(s["a_hydro"] + s["a_grav"] + s["a_grav_mesh"])
            new_dt = torch.minimum(
                new_dt, torch.sqrt(c / torch.clamp_min(a_norm, 1e-30)))
        too_small_n = too_small_n + torch.sum(mask_b
                                              & (new_dt < cfg.dt_min))
        new_bin = torch.clamp(bin_from_dt(new_dt, T.time_base_inv), 1, NBINS)
        new_bin = torch.clamp_max(new_bin, T.max_bin)
        s = {**s, "time_bin": torch.where(mask_b, new_bin, 0)}
        dt_k1 = T.dt_kick1[_tb_index(s["time_bin"])]
        a_tot = s["a_hydro"] + s["a_grav"]
        s["v_full"] = s["v_full"] + a_tot * dt_k1[..., None] \
            * s["mask"][..., None]
        # the reference's init kicks u with the velocity factor, dt_kick1
        ke = sphenix.kick_extra(p, s, cosmo, dt_k1 * s["mask"])
        gas = {**s, "u_full": ke["u_full"], "u_dt": ke["u_dt"]}
        bin_counts = bin_counts + _bin_counts(mask_b, gas["time_bin"])
    kicked = {}
    for name, sp in (("dm", dm), ("stars", stars), ("bh", bh)):
        if sp is None:
            continue
        mask_b = sp["mask"] > 0
        new_dt = torch.sqrt(
            _f32(2.0 * cfg.eta_grav * _eps_of(eps_soft, name))
            / torch.clamp_min(_norm(sp["a_grav"] + sp["a_grav_mesh"]),
                              1e-30))
        new_dt = torch.clamp_max(new_dt, _f32(cfg.dt_max))
        too_small_n = too_small_n + torch.sum(mask_b
                                              & (new_dt < cfg.dt_min))
        new_bin = torch.clamp(bin_from_dt(new_dt, T.time_base_inv), 1, NBINS)
        new_bin = torch.clamp_max(new_bin, T.max_bin)
        d = {**sp, "time_bin": torch.where(mask_b, new_bin, 0)}
        dt_k1 = T.dt_kick1[_tb_index(d["time_bin"])]
        d["v_full"] = d["v_full"] + d["a_grav"] * dt_k1[..., None] \
            * d["mask"][..., None]
        bin_counts = bin_counts + _bin_counts(mask_b, d["time_bin"])
        kicked[name] = d
    dm, stars, bh = (kicked.get(n) for n in ("dm", "stars", "bh"))

    out = {n: sp for n, sp in zip(SPECIES, (gas, dm, stars, bh))
           if sp is not None}
    diag = {
        "bin_counts": bin_counts,
        "n_overflow": torch.zeros((), dtype=I32, device=dev),
        "n_dt_too_small": too_small_n,
        "n_ghost_iter": n_ghost_iter,
        "n_active": sum(torch.sum(sp["mask"] > 0) for sp in out.values()),
        "n_woken": 0,
        "h_max_active": (torch.amax(torch.where(gas["mask"] > 0, gas["h"],
                                                0.0))
                         if gas is not None
                         else torch.zeros((), device=dev)),
    }
    return out, diag


def _mesh_update_multi(mesh_fn, state: Dict[str, Dict], dt_close: float,
                       dt_open: float):
    """Split PM-mesh kick at a mesh-step boundary for every species
    (kick.h:255): close the old half-kick with the old field, solve the
    mesh over the union of the species, open the next half-kick with the
    new field.  Returns (state, max |a_mesh| over the species)."""
    names = [n for n in SPECIES if n in state]
    closed = {}
    for n in names:
        s = state[n]
        mb = s["mask"][..., None]
        closed[n] = {**s, "v_full": s["v_full"]
                     + s["a_grav_mesh"] * (dt_close * mb)}
    outs = mesh_fn([closed[n] for n in names])
    amax = torch.zeros((), device=next(iter(state.values()))["mask"].device)
    new = {}
    for n, (acc, pot) in zip(names, outs):
        s = closed[n]
        mb = s["mask"][..., None]
        amax = torch.maximum(amax, torch.amax(_norm(acc)))
        new[n] = {**s, "v_full": s["v_full"] + acc * (dt_open * mb),
                  "a_grav_mesh": acc * mb, "pot_mesh": pot * s["mask"]}
    return new, amax


def _mesh_open_multi(state: Dict[str, Dict], dt: float):
    new = {}
    for n, s in state.items():
        mb = s["mask"][..., None]
        new[n] = {**s, "v_full": s["v_full"] + s["a_grav_mesh"] * (dt * mb)}
    return new


def _refuse_model(name: str, obj, *classes):
    if obj is not None and not isinstance(obj, classes):
        runs = " and ".join(c.__name__ for c in classes)
        raise NotImplementedError(
            f"MultiEngine: {name} {type(obj).__name__} not ported; the port "
            f"runs {runs} only (ROADMAP.md, queue 1 item 9)")


class MultiEngine(Engine):
    """Gas + DM + stars + black holes engine (the SmallCosmoVolume and
    EAGLE volume configurations) on the flat column grid.  ``gravity_fn``
    and ``mesh_fn`` take the species list in ``SPECIES`` order
    (``GravitySolver.short_range_accelerations`` and
    ``mesh_accelerations``); ``eps_soft`` is a float or the (baryon, dm)
    pair of the timestep softenings.  ``star_formation``,
    ``entropy_floor``, ``feedback`` and ``enrichment`` are the EAGLE
    models of ``subgrid``; ``bh_model`` is ``subgrid.black_holes``'
    EagleBlackHoles or DefaultBlackHoles."""

    def __init__(self, grid: CellGrid, sph: SPHENIXParams,
                 cfg: EngineConfig, time_begin: float, time_end: float, *,
                 device="cuda", gravity_fn: Optional[Callable] = None,
                 eps_soft=1e-3, cosmology=None,
                 cooling_fn: Optional[Callable] = None,
                 mesh_fn: Optional[Callable] = None,
                 mesh_dt_scale: float = 0.0,
                 star_formation: Optional[EagleStarFormation] = None,
                 entropy_floor=None,
                 feedback: Optional[EagleThermalFeedback] = None,
                 enrichment: Optional[EagleEnrichment] = None,
                 bh_model=None, **refused):
        unknown = sorted(set(refused) - set(_REFUSED))
        if unknown:
            raise TypeError(f"MultiEngine: unexpected arguments {unknown}")
        bad = [k for k in _REFUSED if refused.get(k) is not None]
        if bad:
            raise NotImplementedError(
                f"MultiEngine: {', '.join(bad)} not ported; the port runs "
                "gas, dark matter, stars and black holes with the EAGLE "
                "cooling, star-formation, feedback, enrichment and black-hole "
                "models (ROADMAP.md, queue 1 item 9)")
        _refuse_model("star_formation", star_formation, EagleStarFormation)
        _refuse_model("feedback", feedback, EagleThermalFeedback)
        _refuse_model("enrichment", enrichment, EagleEnrichment)
        _refuse_model("bh_model", bh_model, EagleBlackHoles,
                      DefaultBlackHoles)
        if cfg.backend != "flat":
            raise NotImplementedError(
                f"MultiEngine: backend {cfg.backend!r} not ported; the "
                "port's multi-species engine runs on 'flat' only (ROADMAP.md,"
                " queue 1 item 9)")
        refuse_unported_mode(sph, "MultiEngine")
        super().__init__(grid, sph, cfg, time_begin, time_end,
                         device=device, gravity_fn=gravity_fn,
                         mesh_fn=mesh_fn, mesh_dt_scale=mesh_dt_scale,
                         cosmology=cosmology, cooling_fn=cooling_fn)
        self.eps_soft = (tuple(float(e) for e in eps_soft)
                         if isinstance(eps_soft, (tuple, list))
                         else float(eps_soft))
        self.sf = ((star_formation, entropy_floor)
                   if star_formation is not None else None)
        self.feedback = feedback
        self.enrichment = enrichment
        self.bh_model = bh_model
        self.state = {}
        self.n_particles = 0

    # --- loading ---------------------------------------------------------------
    def load_gas(self, pos, m, v, u, h, pid=None, Z=None, elem_frac=None):
        """Bucket the gas (z-sorted columns), with its chemistry carriers
        when given and the sticky SFR when star formation is on."""
        gas = Engine(self.grid, self.sph, self.cfg, 0.0, 1.0,
                     device=self.device)
        gas.load_particles(pos, m, v, u, h, pid=pid, Z=Z,
                           elem_frac=elem_frac)
        self.state["gas"] = gas.state
        if self.sf is not None:
            self.state["gas"]["sfr"] = torch.zeros_like(gas.state["m"])
        self.n_particles += len(pos)

    def load_dm(self, pos, m, v, pid=None):
        """Bucket the DM particles (z-sorted columns)."""
        self.state["dm"] = _dm_tiles(self.grid, pos, m, v, pid,
                                     self.device, zsort=True)
        self.n_particles += len(pos)

    def _star_state(self, mask, off, out, C: int, K_s: int):
        dev = self.device

        def z(*tail):
            return torch.zeros((C, K_s) + tail, dtype=F32, device=dev)

        ef = z(N_ELEMENTS)
        ef[..., 0], ef[..., 1] = 0.752, 0.248
        return {"mask": mask, "off": off, **out,
                "a_grav": z(3), "pot": z(), "a_grav_mesh": z(3),
                "pot_mesh": z(),
                "time_bin": torch.zeros((C, K_s), dtype=I32, device=dev),
                "birth_time": z(), "birth_density": z(), "fb_done": z(),
                "Z": z(), "elem_frac": ef,
                "drift_accum": torch.zeros((), dtype=F32, device=dev)}

    def alloc_stars(self, extra_per_cell: int = STAR_EXTRA_SLOTS):
        """Empty star slots for star formation, ``extra_per_cell`` a cell
        (space_extra_sparts, space.h:53)."""
        C, K_s = self.grid.C, int(extra_per_cell)
        out = {"pid": torch.full((C, K_s), -1, dtype=I32, device=self.device),
               "m": torch.zeros((C, K_s), dtype=F32, device=self.device),
               "v_full": torch.zeros((C, K_s, 3), dtype=F32,
                                     device=self.device),
               "h": torch.zeros((C, K_s), dtype=F32, device=self.device)}
        out["m_init"] = out["m"].clone()
        self.state["stars"] = self._star_state(
            torch.zeros((C, K_s), dtype=F32, device=self.device),
            torch.zeros((C, K_s, 3), dtype=F32, device=self.device),
            out, C, K_s)

    def load_stars(self, pos, m, v, h=None, pid=None,
                   extra_per_cell: int = STAR_EXTRA_SLOTS):
        """Bucket existing star particles (z-sorted columns, the grid's
        capacity) plus ``extra_per_cell`` free slots for star formation.
        They carry no birth time: they do not fire or enrich."""
        n = len(pos)
        if pid is None:
            pid = np.arange(n, dtype=np.int32)
        if h is None:
            h = np.full(n, min(self.grid.edge) / 4, np.float32)
        fields = {"pid": np.asarray(pid, np.int32),
                  "m": np.asarray(m, np.float32),
                  "v_full": np.asarray(v, np.float32),
                  "h": np.asarray(h, np.float32)}
        out, mask, off, n_over = bucket_fields(
            self.grid, np.asarray(pos), fields, device=self.device,
            zsort=True)
        if int(n_over) != 0:
            raise RuntimeError(f"{int(n_over)} star particles overflow K")
        extra = int(extra_per_cell)
        out = {k: _pad_slots(v, extra, -1 if k == "pid" else 0)
               for k, v in out.items()}
        mask, off = _pad_slots(mask, extra), _pad_slots(off, extra)
        out["m_init"] = out["m"].clone()
        self.state["stars"] = self._star_state(mask, off, out, self.grid.C,
                                               mask.shape[1])
        self.n_particles += n

    def load_bh(self, pos, m, v, h=None, pid=None, m_subgrid=None):
        """Bucket black holes (z-sorted columns; EAGLE bpart: dynamical mass
        m, subgrid mass m_subgrid (default m), AGN energy reservoir;
        black_holes_part.h)."""
        n = len(pos)
        if pid is None:
            pid = np.arange(n, dtype=np.int32)
        if h is None:
            h = np.full(n, min(self.grid.edge) / 4, np.float32)
        if m_subgrid is None:
            m_subgrid = m
        fields = {"pid": np.asarray(pid, np.int32),
                  "m": np.asarray(m, np.float32),
                  "m_subgrid": np.asarray(m_subgrid, np.float32),
                  "v_full": np.asarray(v, np.float32),
                  "h": np.asarray(h, np.float32)}
        out, mask, off, n_over = bucket_fields(
            self.grid, np.asarray(pos), fields, device=self.device,
            zsort=True)
        if int(n_over) != 0:
            raise RuntimeError(f"{int(n_over)} BH particles overflow K")
        shape = mask.shape

        def z(*tail):
            return torch.zeros(shape + tail, dtype=F32, device=self.device)
        self.state["bh"] = {
            "mask": mask, "off": off, **out, "a_grav": z(3),
            "a_grav_mesh": z(3), "pot": z(), "pot_mesh": z(),
            "time_bin": torch.zeros(shape, dtype=I32, device=self.device),
            "energy_reservoir": z(), "swallow_prob": z(), "mdot": z(),
            "rho_gas": z(), "ngb_mass": z(),
            "drift_accum": torch.zeros((), dtype=F32, device=self.device)}
        self.n_particles += n

    # --- split PM-mesh timestep over every species -----------------------------
    def _mesh_boundary(self):
        ti = self.timeline.ti_current
        dt_close = (0.0 if self.ti_mesh_mid is None
                    else self._kick_fac(self.ti_mesh_mid, ti))
        self.state, amax = _mesh_update_multi(self.mesh_fn, self.state,
                                              _f32(dt_close), 0.0)
        dti = self._pick_mesh_dti(float(amax))
        self.ti_mesh_end = min(ti + dti, tl.MAX_NR_TIMESTEPS)
        self.ti_mesh_mid = min(ti + dti // 2, tl.MAX_NR_TIMESTEPS)
        dt_open = self._kick_fac(ti, self.ti_mesh_mid)
        self.state = _mesh_open_multi(self.state, _f32(dt_open))
        self.n_mesh_updates += 1

    # --- stepping --------------------------------------------------------------
    def _init_particles_once(self):
        if self.mesh_fn is not None:
            self._mesh_boundary()
        T = self._tables()
        self.state, diag = multi_init(self.grid, self.sph, self.cfg,
                                      self.gravity_fn, self.eps_soft,
                                      self.cosmo, self.state, T)
        self._post_step(diag)
        return diag

    def _step_once(self):
        t = self.timeline
        ti_next = self._ti_end_min
        if self.mesh_fn is not None:
            if self.ti_mesh_end is None:
                self._mesh_boundary()
            ti_next = min(ti_next, self.ti_mesh_end)
        ti_old = t.ti_current
        dt_drift = (ti_next - ti_old) * t.time_base
        t.ti_current = ti_next
        T = self._tables(dt_drift=dt_drift, ti_drift_start=ti_old)
        self.state, diag = multi_step(self.grid, self.sph, self.cfg,
                                      self.gravity_fn, self.eps_soft,
                                      self.cosmo, self.state, T,
                                      self.cooling_fn, self.sf,
                                      self.feedback, self.enrichment,
                                      self.bh_model)
        self._post_step(diag)
        self.step_count += 1
        if self.mesh_fn is not None and t.ti_current >= self.ti_mesh_end:
            self._mesh_boundary()
        return diag

    # --- automatic re-gridding over every species ------------------------------
    def _grid_reach(self, h_reach: float = 0.0) -> float:
        reach = float(self.cfg.p2p_reach)
        for name in ("gas", "stars", "bh"):
            sp = self.state.get(name)
            if sp is None:
                continue
            mask = sp["mask"] > 0
            if bool(mask.any()):
                reach = max(reach, float(sp["h"][mask].max())
                            * self.sph.kernel.gamma * 1.05)
        return max(reach, h_reach * 1.05)

    def regrid(self, h_reach: float = 0.0):
        """space_regrid over every species: one new grid sized for the
        union of the particles, each species re-bucketed onto it (the
        stars keep their free slots when stars form), gravity rebound
        from ``solver_builder``."""
        gravity = self.gravity_fn is not None or self.mesh_fn is not None
        if gravity and self.solver_builder is None:
            raise RuntimeError(
                "auto re-grid with gravity needs engine.solver_builder "
                "(a CellGrid -> GravitySolver factory): the old "
                "gravity_fn is bound to the replaced grid")
        if gravity and self.mesh_fn is None:
            raise NotImplementedError(
                "re-binding gravity without a split PM mesh is not ported")
        reach = self._grid_reach(h_reach)
        extracted = {n: self._extract_particles(sp)
                     for n, sp in self.state.items()}
        new_grid = self._build_grid(
            np.concatenate([pos for pos, _ in extracted.values()]), reach)
        state = {n: self._rebucket_species(
            new_grid, pos, fields,
            extra_slots=(STAR_EXTRA_SLOTS if n == "stars"
                         and self.sf is not None else 0))
            for n, (pos, fields) in extracted.items()}
        if gravity:
            self._bind_solver(self.solver_builder(new_grid))
        self.state, self.grid = state, new_grid
        self.n_regrids += 1

    def _bind_solver(self, solver):
        """The split-mesh gravity of ``solver`` over the species list."""
        self.gravity_fn = solver.short_range_accelerations
        self.mesh_fn = solver.mesh_accelerations
        self.mesh_dt_scale = solver.pm.r_s

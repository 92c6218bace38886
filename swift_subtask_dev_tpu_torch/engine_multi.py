"""Multi-species engine: gas + dark matter in one step.

Port of the gas and DM branches of the reference's ``engine_multi.py``
(the SmallCosmoVolume configuration: SPHENIX gas + collisionless DM,
comoving, P3M with split mesh kicks, constant-Lambda cooling).  Each
species is its own padded tile state on the shared column grid, and one
step drifts, rebuckets and kicks them all, with gravity sourced jointly:

    drift(all species) -> rebucket(each on its own trigger) -> SPH loops
    (gas) -> short-range gravity (every species from every species: K1's
    one-species and cross-species P2P launches) -> cooling (gas) -> KDK
    per species

and the PM mesh over the union of the species on its own split timestep.
The host owns the timeline, as in ``engine.Engine``.

Refused at construction (ROADMAP.md, queue 1 item 9): stars, black
holes, sinks, neutrinos, star formation, feedback, enrichment, radiative
transfer, tracers and external potentials, and every backend but "flat".
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .engine import (Engine, EngineConfig, StepTables, NBINS,
                     I32, _apply_cooling, _bin_counts, _dm_kdk, _dm_tiles,
                     _f32, _gas_kdk, _gas_loops, _rebucket_phase,
                     _tb_index, _where_active, bin_from_dt)
from .grid.cellgrid import CellGrid
from .models.sph import sphenix
from .models.sph.sphenix import CosmoFactors, SPHENIXParams
from .utils import timeline as tl

# the species the port runs, in the gravity and mesh lists' order
SPECIES = ("gas", "dm")
_REFUSED = ("star_formation", "entropy_floor", "feedback", "bh_model",
            "nu_model", "sink_model", "enrichment", "external_potential",
            "rt_fn", "tracers")


def _species_active(sp: Dict, T: StepTables):
    mask_b = sp["mask"] > 0
    tb = _tb_index(sp["time_bin"])
    return mask_b, tb, mask_b & T.active[tb]


def _eps_of(eps_soft, name: str) -> float:
    """Per-species timestep softening: ``eps_soft`` is a float, or a
    (baryon, dm) pair (Gravity:comoving_baryon_softening /
    comoving_DM_softening; timestep.h:141 uses the particle's own)."""
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


def multi_step(grid: CellGrid, p: SPHENIXParams, cfg: EngineConfig,
               gravity_fn: Optional[Callable], eps_soft,
               cosmo: CosmoFactors, state: Dict[str, Dict], T: StepTables,
               cooling_fn: Optional[Callable] = None):
    """One engine step over the {'gas', 'dm'} species.  Returns
    (new_state, diagnostics)."""
    gas, dm = state.get("gas"), state.get("dm")
    dev = next(iter(state.values()))["mask"].device
    zero = torch.zeros((), dtype=I32, device=dev)
    n_overflow, n_active, too_small_n, n_woken = zero, zero, zero, zero
    n_ghost_iter = 0
    h_max_active = torch.zeros((), device=dev)
    acts = {}

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

    # --- joint gravity (every species sources, every species receives) ------
    if gravity_fn is not None:
        pool = {n: sp for n, sp in (("gas", gas), ("dm", dm))
                if sp is not None}
        pool = _apply_gravity(gravity_fn, pool,
                              {n: a[2] for n, a in acts.items()})
        gas, dm = pool.get("gas"), pool.get("dm")

    # --- per-species cooling + KDK --------------------------------------------
    bin_counts = torch.zeros(NBINS + 1, dtype=torch.int64, device=dev)
    if gas is not None:
        mask_b, tb, active = acts["gas"]
        gas = _apply_cooling(cooling_fn, cosmo, gas, T, active, tb)
        gas, too_small, woken = _gas_kdk(grid, p, cfg, cosmo, gas, T,
                                         active, mask_b, tb)
        too_small_n = too_small_n + torch.sum(too_small)
        n_woken = n_woken + woken
        bin_counts = bin_counts + _bin_counts(gas["mask"] > 0,
                                              gas["time_bin"])
    if dm is not None:
        mask_b, tb, active = acts["dm"]
        dm, too_small = _dm_kdk(cfg, _eps_of(eps_soft, "dm"), dm, T,
                                active, tb)
        too_small_n = too_small_n + torch.sum(too_small)
        bin_counts = bin_counts + _bin_counts(mask_b, dm["time_bin"])

    out = {n: sp for n, sp in (("gas", gas), ("dm", dm)) if sp is not None}
    diag = {
        "bin_counts": bin_counts,
        "n_overflow": n_overflow,
        "n_dt_too_small": too_small_n,
        "n_ghost_iter": n_ghost_iter,
        "n_active": n_active,
        "n_woken": n_woken,
        "h_max_active": h_max_active,
        # fullest live cell over every species (occupancy re-grid trigger)
        "k_max_live": torch.amax(torch.stack([
            torch.amax(torch.sum(sp["mask"] > 0, dim=1))
            for sp in out.values()])),
    }
    return out, diag


def multi_init(grid: CellGrid, p: SPHENIXParams, cfg: EngineConfig,
               gravity_fn: Optional[Callable], eps_soft,
               cosmo: CosmoFactors, state: Dict[str, Dict], T: StepTables):
    """engine_init_particles for every species: density/ghost + forces +
    initial bins + the first half-kick (engine.c:1893)."""
    gas, dm = state.get("gas"), state.get("dm")
    dev = next(iter(state.values()))["mask"].device
    n_ghost_iter = 0
    if gas is not None:
        gas, n_ghost_iter = _gas_loops(grid, p, cfg, cosmo, gas,
                                       gas["mask"] > 0, T.dt_alpha * 0.0)
    if gravity_fn is not None:
        pool = {n: sp for n, sp in (("gas", gas), ("dm", dm))
                if sp is not None}
        pool = _apply_gravity(gravity_fn, pool,
                              {n: sp["mask"] > 0 for n, sp in pool.items()})
        gas, dm = pool.get("gas"), pool.get("dm")

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
    if dm is not None:
        mask_b = dm["mask"] > 0
        new_dt = torch.sqrt(
            _f32(2.0 * cfg.eta_grav * _eps_of(eps_soft, "dm"))
            / torch.clamp_min(_norm(dm["a_grav"] + dm["a_grav_mesh"]),
                              1e-30))
        new_dt = torch.clamp_max(new_dt, _f32(cfg.dt_max))
        too_small_n = too_small_n + torch.sum(mask_b
                                              & (new_dt < cfg.dt_min))
        new_bin = torch.clamp(bin_from_dt(new_dt, T.time_base_inv), 1, NBINS)
        new_bin = torch.clamp_max(new_bin, T.max_bin)
        d = {**dm, "time_bin": torch.where(mask_b, new_bin, 0)}
        dt_k1 = T.dt_kick1[_tb_index(d["time_bin"])]
        d["v_full"] = d["v_full"] + d["a_grav"] * dt_k1[..., None] \
            * d["mask"][..., None]
        dm = d
        bin_counts = bin_counts + _bin_counts(mask_b, dm["time_bin"])

    out = {n: sp for n, sp in (("gas", gas), ("dm", dm)) if sp is not None}
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


class MultiEngine(Engine):
    """Gas + DM engine (the SmallCosmoVolume configuration) on the flat
    column grid.  ``gravity_fn`` and ``mesh_fn`` take the species list in
    ``SPECIES`` order (``GravitySolver.short_range_accelerations`` and
    ``mesh_accelerations``); ``eps_soft`` is a float or the (baryon, dm)
    pair of the timestep softenings."""

    def __init__(self, grid: CellGrid, sph: SPHENIXParams,
                 cfg: EngineConfig, time_begin: float, time_end: float, *,
                 device="cuda", gravity_fn: Optional[Callable] = None,
                 eps_soft=1e-3, cosmology=None,
                 cooling_fn: Optional[Callable] = None,
                 mesh_fn: Optional[Callable] = None,
                 mesh_dt_scale: float = 0.0, **refused):
        bad = sorted(k for k, v in refused.items() if v is not None)
        unknown = sorted(set(refused) - set(_REFUSED))
        if unknown:
            raise TypeError(f"MultiEngine: unexpected arguments {unknown}")
        if bad:
            raise NotImplementedError(
                f"MultiEngine: {', '.join(bad)} not ported; the port runs "
                "gas and dark matter only (ROADMAP.md, queue 1 item 9)")
        if cfg.backend != "flat":
            raise NotImplementedError(
                f"MultiEngine: backend {cfg.backend!r} not ported; the "
                "port's multi-species engine runs on 'flat' only (ROADMAP.md,"
                " queue 1 item 9)")
        super().__init__(grid, sph, cfg, time_begin, time_end,
                         device=device, gravity_fn=gravity_fn,
                         mesh_fn=mesh_fn, mesh_dt_scale=mesh_dt_scale,
                         cosmology=cosmology, cooling_fn=cooling_fn)
        self.eps_soft = (tuple(float(e) for e in eps_soft)
                         if isinstance(eps_soft, (tuple, list))
                         else float(eps_soft))
        self.state = {}
        self.n_particles = 0

    # --- loading ---------------------------------------------------------------
    def load_gas(self, pos, m, v, u, h, pid=None):
        gas = Engine(self.grid, self.sph, self.cfg, 0.0, 1.0,
                     device=self.device)
        gas.load_particles(pos, m, v, u, h, pid=pid)
        self.state["gas"] = gas.state
        self.n_particles += len(pos)

    def load_dm(self, pos, m, v, pid=None):
        """Bucket the DM particles (z-sorted columns)."""
        self.state["dm"] = _dm_tiles(self.grid, pos, m, v, pid,
                                     self.device, zsort=True)
        self.n_particles += len(pos)

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
                                      self.cooling_fn)
        self._post_step(diag)
        self.step_count += 1
        if self.mesh_fn is not None and t.ti_current >= self.ti_mesh_end:
            self._mesh_boundary()
        return diag

    # --- automatic re-gridding over every species ------------------------------
    def _grid_reach(self, h_reach: float = 0.0) -> float:
        reach = float(self.cfg.p2p_reach)
        gas = self.state.get("gas")
        if gas is not None:
            mask = gas["mask"] > 0
            if bool(mask.any()):
                reach = max(reach, float(gas["h"][mask].max())
                            * self.sph.kernel.gamma * 1.05)
        return max(reach, h_reach * 1.05)

    def regrid(self, h_reach: float = 0.0):
        """space_regrid over every species: one new grid sized for the
        union of the particles, each species re-bucketed onto it, gravity
        rebound from ``solver_builder``."""
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
        state = {n: self._rebucket_species(new_grid, pos, fields)
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

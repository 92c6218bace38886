"""The engine — one-species SPH (+ P3M) gas on a pair-engine grid.

Port of the reference's ``engine.py`` for three backends: ``"flat"`` (the
column grid and the flat pair kernel; the main path), ``"pallas"`` (the
27-cell grid and the packed pair kernel) and ``"pallas_ring"`` (the 27-cell
grid and the ring-buffer pair kernel).  The same step

    drift -> trigger-based rebucket -> density + ghost -> gradient ->
    force (fused with short-range gravity on flat) -> kick2 -> timestep
    -> kick1 -> limiter wake scan (optional: the flat timebin body on
    flat, the 27-cell ``stencil.timebin_loop`` on the other two)

with the PM mesh on its own split timestep, and the same host/device
split: the host owns the exact 64-bit integer timeline and hands the
device small per-bin tables (:class:`StepTables`).  The reference's traced
control flow becomes host control: the ghost's ``while_loop`` is a Python
loop that reads ``conv.all()`` each trip; the rebucket's ``cond`` is an
``if``; ``multi_step``'s ``scan`` is a Python loop that keeps the bin
deviation flag on the device until ``run_fixed_dt`` reads it once.

The step runs any ported SPH scheme (``models/sph`` ``SCHEME_MODULES``,
under any of the six smoothing kernels) through ``p.mod``'s hooks, where
and as the reference's engine calls them: the ghost's ``end_density`` /
``ghost_h_update``, the gradient loop only when ``HAS_GRADIENT_LOOP``,
``prepare_force`` every step, ``end_force`` (the entropy schemes convert
their raw entropy sum there), the drift's ``predict_extra`` and the
kicks' ``kick_extra``; after each of prepare_gradient, end_gradient and
prepare_force the keys the scheme names (``PREPARE_GRADIENT_KEYS``,
``GRADIENT_END_KEYS``, ``PREPARE_FORCE_KEYS``) are written back on the
active particles.  The scheme's int32 state (``EXTRA_STATE_INT_KEYS``,
Planetary's ``mat_id``) rides loading, rebucket and re-grid as int32.
The 27-cell backends run SPHENIX with the cubic spline only.

A step that hits a capacity or coverage wall raises :class:`RegridNeeded`;
``Engine.step`` restores the pre-step state, rebuilds the grid from the
live particles and retries (the step never modifies the tensors it is
given, so the saved state is intact).

Cosmological runs (``cosmology=``, ``models.cosmology.Cosmology``) keep
the integer timeline in log(a); every kick and drift of a step is an
integral of the cosmology's f64 tables, folded on the host into the
per-bin tables, and the step's ``CosmoFactors`` come from
``Cosmology.factors_at``.  ``cooling_fn`` (``subgrid.cooling``) rewrites
u_dt before kick2.  :class:`DMEngine` is the gravity-only engine
(``dm_step``); the multi-species engine is ``engine_multi.MultiEngine``.

Left out (see ROADMAP.md): particle splitting, external potentials, the
xla and gather backends.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .grid.cellgrid import (CellGrid, bucket_fields, global_positions,
                            rebucket_offsets)
from .models.sph import scheme_name
from .models.sph.kernels import kernel_name
from .models.sph.sphenix import CosmoFactors, SPHENIXParams
from .ops import hydro_flat, stencil
from .utils import timeline as tl

F32 = torch.float32
I32 = torch.int32
NBINS = tl.NUM_TIME_BINS

# the identity cosmology as python-float literals (the reference's
# _NO_COSMO_LIT): every a/H factor folds into the pair bodies' constants
NO_COSMO = CosmoFactors.no_cosmo()


def _f32(x: float) -> float:
    """A python float rounded to f32 (the reference's jnp.float32(x))."""
    return float(np.float32(x))


class StepTables(NamedTuple):
    """Per-step host-built tables indexed by time bin (0..56)."""

    active: torch.Tensor       # (57,) bool  — bin is active at ti_current
    dt_kick1: torch.Tensor     # (57,) f32   — first-half kick of a new step
    dt_kick2: torch.Tensor     # (57,) f32   — second-half kick of old step
    dt_therm1: torch.Tensor    # (57,) f32   — the thermal kicks
    dt_therm2: torch.Tensor    # (57,) f32
    dt_alpha: torch.Tensor     # (57,) f32   — full step length per bin
    dt_therm_full: torch.Tensor  # (57,) f32 — thermal integral over the
    # particle's full elapsed step [ti - dti, ti] (cooling's dt_therm)
    aligned_up: torch.Tensor   # (57,) bool  — bin b may be raised to b+1
    dt_drift: float            # f32-rounded drift of this step
    dt_therm_drift: float      # f32-rounded thermal drift
    max_bin: int               # ceiling from dt_max
    time_base_inv: float       # f32-rounded 1/time_base (bin_from_dt;
    # times H(a) in cosmological runs)
    wake_dv: torch.Tensor      # (57, 57) f32 — limiter wake kick:
    # [old_bin, new_bin] -> net dt of (undo old kick1) + (advance to the
    # new step start) + (new kick1), timestep_limit_part
    # (timestep_limiter.h:64)
    wake_du: torch.Tensor      # (57, 57) f32 — the thermal one
    max_active_bin: int = 0    # largest bin active at ti_current (the sync
    # target of feedback-heated particles, runner_do_sync)
    ti_lo: int = 0             # ti_current & 0x7FFFFFFF (RNG fold)
    ti_hi: int = 0             # (ti_current >> 31) & 0x7FFFFFFF (RNG fold)
    birth_time: float = 0.0    # f32 scale factor (cosmological) or time
    # at ti_current, stamped on newly formed stars


# pair engine of each backend (the reference's _loops table)
BACKENDS = {"flat": "flat", "pallas": "packed", "pallas_ring": "ring"}


@dataclass(frozen=True)
class EngineConfig:
    """The fields of the reference's EngineConfig the port reads (the
    rebucket is always trigger-based)."""

    dt_min: float = 1e-17
    dt_max: float = 1e-2
    backend: str = "flat"     # 'flat' (columns, pair_flat) | 'pallas'
    # (27-cell grid, pair_packed) | 'pallas_ring' (27-cell grid, pair_ring)
    with_self_gravity: bool = False
    max_ghost_iterations: int = 30
    species_ghost_iterations: int = 8  # the stars' ghost (multi engine)
    rebucket_safety: float = 0.9  # fraction of the safe margin to use
    p2p_reach: float = 0.0    # P2P gravity r_cut (coverage margin term)
    eta_grav: float = 0.025   # Gravity:eta
    eps_soft: float = 1e-3    # Gravity:eps (dt_grav = sqrt(2 eta eps/|a|))
    mesh_dt_max: float = 0.0  # ceiling of the split PM-mesh interval
    # (0 -> dt_max)
    with_timestep_limiter: bool = False  # SWIFT --limiter: cap active
    # bins at min_ngb + 2 and wake inactive particles whose neighbours got
    # fast (runner_do_limiter)
    # occupancy re-grid: rebuild tighter when the fullest cell x 1.7 is
    # below trigger * K (<= 0 disables), at most once per cooldown steps
    regrid_shrink_trigger: float = 0.5
    regrid_cooldown: int = 20


def refuse_unported_mode(p, where: str) -> None:
    """Raise unless ``p`` is SPHENIX with the cubic spline, the one SPH
    mode ``where`` (the 27-cell backends, the multi-species engine) runs;
    the others are ported on the flat backend of :class:`Engine` only."""
    scheme, kernel = scheme_name(p), kernel_name(p.kernel)
    if (scheme, kernel) != ("sphenix", "cubic-spline"):
        raise NotImplementedError(
            f"{where} runs SPHENIX with the cubic spline only: the SPH "
            f"scheme {scheme!r} with the kernel {kernel!r} is not ported "
            f"there yet (use Engine with backend='flat')")


class RegridNeeded(RuntimeError):
    """A step hit a capacity/coverage wall (cell overflow or h outgrowing
    the cell edge): the host rebuilds the grid and retries the step."""

    def __init__(self, reason: str, h_reach: float = 0.0):
        super().__init__(reason)
        self.reason = reason
        self.h_reach = h_reach


def bin_from_dt(dt: torch.Tensor, time_base_inv: float) -> torch.Tensor:
    """Largest bin with 2^(b+1)*time_base <= dt (timeline.h get_time_bin),
    via frexp for an exact floor(log2) on f32."""
    dti = torch.clamp_min(dt * time_base_inv, 2.0)
    _, e = torch.frexp(dti)  # dti = m * 2^e, m in [0.5, 1)
    return (e - 2).to(I32)


def _tb_index(time_bin: torch.Tensor) -> torch.Tensor:
    return torch.clamp(time_bin, 0, NBINS).to(torch.int64)


def _where_active(active, new, old):
    act = active[..., None] if new.dim() == 3 else active
    return torch.where(act, new, old)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _ghost_density(grid: CellGrid, p: SPHENIXParams, cosmo: CosmoFactors,
                   s: Dict, active: torch.Tensor, max_iter: int,
                   engine: str = "flat"):
    """Density loop + smoothing-length iteration (the ghost).

    Each trip re-runs only the unconverged particles (the reference's
    unconverged-subset loops, runner_ghost.c:1085): the flat engine the
    128-slot i-tiles holding one, the 27-cell engines the particles
    themselves.  Exact, because rho_i depends on h_i only, so skipped
    particles keep valid values and mixed tiles recompute in full (the
    reference's 27-cell engines recompute every slot each trip).  Returns
    (h, dens, n_iter)."""
    kroot_eps = float(np.float32(p.kernel.root) * np.float32(1.0 + 1e-5))
    extra_keys = p.mod.DENSITY_EXTRA_KEYS

    def density_pass(h, act=None):
        dens = hydro_flat.density_loop(grid, {**s, "h": h}, p,
                                       active_i=act, engine=engine)
        full = p.mod.end_density(p, {**s, "h": h, **dens}, cosmo)
        return {k: full[k] for k in
                ("rho", "rho_dh", "wcount", "wcount_dh", "div_v", "rot_v")
                + extra_keys}

    def h_update(h, d, left, right):
        has_ngb = d["wcount"] * (h * h * h) > kroot_eps
        return p.mod.ghost_h_update(p, h, d["wcount"], d["wcount_dh"],
                                    left, right, has_ngb)

    h = s["h"]
    left = torch.zeros_like(h)
    right = torch.full_like(h, p.h_max)
    # tiles with no ACTIVE particle skip even the first pass
    d = density_pass(h, act=active)
    _, _, _, conv = h_update(h, d, left, right)
    conv = conv | ~active

    C, W = h.shape
    n_iter = 0
    while n_iter < max_iter and not bool(conv.all()):
        h_new, left, right, _ = h_update(h, d, left, right)
        upd = active & ~conv
        h = torch.where(upd, h_new, h)
        d_new = density_pass(h, act=upd)
        if engine == "flat":
            tflag = torch.any(upd.reshape(C, W // 128, 128), dim=2)
            fp = tflag[:, :, None].expand(C, W // 128, 128).reshape(C, W)
        else:
            fp = upd
        d = {k: _where_active(fp, d_new[k], d[k]) for k in d}
        _, _, _, c2 = h_update(h, d, left, right)
        conv = conv | ~upd | (upd & c2)
        n_iter += 1
    return h, d, n_iter


def _gas_loops(grid: CellGrid, p: SPHENIXParams, cfg: EngineConfig,
               cosmo: CosmoFactors, s: Dict, active, dt_alpha_table,
               fuse_spec: Optional[Dict] = None):
    """density+ghost -> gradient -> force (fused with short-range gravity
    when ``fuse_spec`` is given) on the active particles.  Returns
    (state, n_ghost_iter)."""
    tb = _tb_index(s["time_bin"])
    engine = BACKENDS[cfg.backend]
    # the flat engine skips i-tiles with no active particle (zeroed range
    # words), the 27-cell ones the inactive particles; the active-masked
    # merges keep the inactive particles' old values
    h_new, dens, n_ghost_iter = _ghost_density(
        grid, p, cosmo, s, active, cfg.max_ghost_iterations, engine)
    s = {**s, "h": torch.where(active, h_new, s["h"])}
    for k, v in dens.items():
        s[k] = _where_active(active, v, s[k])
    s_fb = p.mod.no_neighbours_fallback(p, s)
    for k in ("rho", "v_sig", "wcount", "rho_dh", "wcount_dh", "div_v",
              "laplace_u", "rot_v") + p.mod.DENSITY_EXTRA_KEYS:
        s[k] = _where_active(active, s_fb[k], s[k])

    # --- prepare gradient + gradient loop (schemes that have one) -----------
    # (each hook's results written back on the active particles for the
    # keys the scheme names: the reference engine's lists)
    rg = p.mod.reset_gradient(p.mod.prepare_gradient(p, s, cosmo))
    for k in p.mod.PREPARE_GRADIENT_KEYS + ("v_sig", "alpha_visc_max_ngb"):
        s[k] = torch.where(active, rg[k], s[k])
    if p.mod.HAS_GRADIENT_LOOP:
        grad = hydro_flat.gradient_loop(grid, s, p, cosmo, active_i=active,
                                        engine=engine)
        for k, v in grad.items():
            s[k] = torch.where(active, v, s[k])
        eg = p.mod.end_gradient(s)
        for k in p.mod.GRADIENT_END_KEYS:
            s[k] = torch.where(active, eg[k], s[k])

    # --- prepare force (alpha evolution) + force loop -----------------------
    pf = p.mod.prepare_force(p, s, cosmo, dt_alpha_table[tb])
    for k in p.mod.PREPARE_FORCE_KEYS:
        s[k] = torch.where(active, pf[k], s[k])
    ra = p.mod.reset_acceleration(s)
    for k in ("a_hydro", "u_dt", "h_dt"):
        s[k] = _where_active(active, ra[k], s[k])

    if fuse_spec is not None:
        force = hydro_flat.force_gravity_loop(grid, s, p, cosmo,
                                              **fuse_spec, active_i=active)
        s["a_grav"] = _where_active(active, force.pop("a_grav"),
                                    s["a_grav"])
        s["pot"] = torch.where(active, force.pop("pot"), s["pot"])
    else:
        force = hydro_flat.force_loop(grid, s, p, cosmo, active_i=active,
                                      engine=engine)
    for k, v in force.items():
        s[k] = _where_active(active, v, s[k])
    # u_dt too: Gadget2 converts its raw entropy sum here (hydro.h:868)
    ef = p.mod.end_force(p, s)
    s["h_dt"] = torch.where(active, ef["h_dt"], s["h_dt"])
    s["u_dt"] = torch.where(active, ef["u_dt"], s["u_dt"])
    return s, n_ghost_iter


def _rebucket_phase(grid: CellGrid, cfg: EngineConfig, s: Dict,
                    T: StepTables, reach: torch.Tensor):
    """Trigger-based counting-sort rebuild (z-sorted on the flat backend):
    after cumulative drift D a true pair can only straddle >1 cell when
    2*D + reach >= min_edge, so
    rebucket before that (SWIFT's rebuild triggers, engine.c:2392-2448).
    Returns (state, n_overflow)."""
    mask_b = s["mask"] > 0
    vf = s["v_full"]
    v_norm = torch.sqrt(vf[..., 0] * vf[..., 0] + vf[..., 1] * vf[..., 1]
                        + vf[..., 2] * vf[..., 2])
    step_disp = torch.amax(torch.where(mask_b, v_norm, 0.0)) \
        * abs(T.dt_drift)
    accum = s["drift_accum"] + step_disp
    margin = _f32(0.5 * cfg.rebucket_safety) \
        * (_f32(min(grid.edge)) - reach)
    s = {**s, "drift_accum": accum}
    if not bool(accum >= margin):
        return s, torch.zeros((), dtype=I32, device=accum.device)
    carried = {k: v for k, v in s.items()
               if k not in ("mask", "off", "drift_accum")}
    new_fields, new_mask, new_off, n_overflow = rebucket_offsets(
        grid, s["mask"], s["off"], carried, zsort=cfg.backend == "flat")
    return ({"mask": new_mask, "off": new_off,
             "drift_accum": torch.zeros_like(accum), **new_fields},
            n_overflow)


def _gas_kdk(grid: CellGrid, p: SPHENIXParams, cfg: EngineConfig,
             cosmo: CosmoFactors, s: Dict, T: StepTables, active, mask_b,
             tb):
    """kick2 -> timestep -> kick1 -> limiter for the gas (kick.h
    kick_part, runner_do_timestep, runner_do_limiter).  Returns (state,
    too_small, n_woken)."""
    # --- kick2: second half of the step that just ended ----------------------
    a_tot = s["a_hydro"] + s["a_grav"]
    v_full = s["v_full"] + a_tot * T.dt_kick2[tb][..., None]
    s = {**s, "v_full": _where_active(active, v_full, s["v_full"])}
    ke = p.mod.kick_extra(p, s, cosmo, T.dt_therm2[tb])
    for k in ("u_full", "u_dt"):
        s[k] = torch.where(active, ke[k], s[k])

    # reset predicted values at the kick point (runner_time_integration:463)
    rp = p.mod.reset_predicted_values(p, s)
    for k in ("v", "u", "pressure", "soundspeed", "v_sig"):
        s[k] = _where_active(active, rp[k], s[k])

    # --- timestep: pick the new bin (runner_do_timestep, timestep.h) --------
    new_dt = torch.minimum(p.mod.compute_timestep(p, s, cosmo),
                           p.mod.timestep_h_change_limit(p, s))
    if cfg.with_self_gravity:
        a = s["a_hydro"] + s["a_grav"] + s["a_grav_mesh"]
        a_norm = torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]
                            + a[..., 2] * a[..., 2])
        c = float(np.float32(2.0 * cfg.eta_grav) * np.float32(cfg.eps_soft))
        new_dt = torch.minimum(
            new_dt, torch.sqrt(c / torch.clamp_min(a_norm, 1e-30)))
    new_dt = torch.clamp_max(new_dt, _f32(cfg.dt_max))

    too_small = active & (new_dt < cfg.dt_min)
    want_bin = torch.clamp_max(bin_from_dt(new_dt, T.time_base_inv),
                               T.max_bin)
    if cfg.with_timestep_limiter:
        # neighbour cap from the force-loop min reduction
        # (make_integer_timestep, timestep.h:58)
        want_bin = torch.minimum(want_bin, s["min_ngb_time_bin"] + 2)
    want_bin = torch.clamp(want_bin, 1, NBINS)
    cur_bin = tb.to(I32)
    up_ok = T.aligned_up[tb]
    new_bin = torch.where(
        (want_bin > cur_bin) & (cur_bin > 0),
        torch.where(up_ok, torch.minimum(want_bin, cur_bin + 1), cur_bin),
        want_bin)
    s["time_bin"] = torch.where(active, new_bin, s["time_bin"])

    # --- kick1: first half of the new step ----------------------------------
    tb1 = _tb_index(s["time_bin"])
    a_tot = s["a_hydro"] + s["a_grav"]
    v_full = s["v_full"] + a_tot * T.dt_kick1[tb1][..., None]
    s["v_full"] = _where_active(active, v_full, s["v_full"])
    ke1 = p.mod.kick_extra(p, s, cosmo, T.dt_therm1[tb1])
    for k in ("u_full", "u_dt"):
        s[k] = torch.where(active, ke1[k], s[k])

    # --- timestep limiter: wake inactive particles near fast ones -----------
    # (runner_do_limiter + timestep_limit_part: the woken particle's long
    # half-kick is undone and replaced by the short-step kicks via the
    # host-built wake tables)
    n_woken = torch.zeros((), dtype=torch.int64, device=tb.device)
    if cfg.with_timestep_limiter:
        sub = {"mask": s["mask"], "off": s["off"], "h": s["h"],
               "time_bin": s["time_bin"], "active": active.to(F32)}
        if cfg.backend == "flat":
            mnb = hydro_flat.timebin_loop(grid, sub, p)
        else:
            mnb = stencil.timebin_loop(grid, sub, p)
        wake = (mask_b & ~active & (s["time_bin"] > 0)
                & (s["time_bin"] > mnb + 2))
        tb_now = _tb_index(s["time_bin"]).to(I32)
        new_bin_w = torch.minimum(torch.clamp_min(mnb + 2, 1), tb_now)
        s = apply_wake(p, cosmo, s, T, wake, new_bin_w)
        n_woken = torch.sum(wake)
    return s, too_small, n_woken


def apply_wake(p: SPHENIXParams, cosmo: CosmoFactors, s: Dict,
               T: StepTables, wake, new_bin_w):
    """Re-bin an inactive particle mid-flight: undo its long half-kick and
    replace it by the short-step kicks via the host wake tables
    (timestep_limit_part, timestep_limiter.h:64)."""
    tb_now = _tb_index(s["time_bin"])
    iw = _tb_index(new_bin_w)
    dv = T.wake_dv[tb_now, iw]
    du = T.wake_du[tb_now, iw]
    a_tot = s["a_hydro"] + s["a_grav"]
    v_w = s["v_full"] + a_tot * dv[..., None]
    s = {**s, "v_full": torch.where(wake[..., None], v_w, s["v_full"])}
    ke_w = p.mod.kick_extra(p, s, cosmo, du)
    for k in ("u_full", "u_dt"):
        s[k] = torch.where(wake, ke_w[k], s[k])
    s["time_bin"] = torch.where(wake, new_bin_w, s["time_bin"])
    return s


def _apply_cooling(cooling_fn, cosmo, s, T, active, tb):
    """Cooling rewrites u_dt before kick2 integrates it (runner_do_cooling,
    cooling_cool_part), over each particle's full elapsed step."""
    if cooling_fn is None:
        return s
    upd = cooling_fn(s, cosmo, T.dt_therm_full[tb])
    return {**s, **{k: torch.where(active, v, s[k])
                    for k, v in upd.items()}}


def _bin_counts(mask_b, time_bin):
    bins = torch.where(mask_b, torch.clamp(time_bin, 0, NBINS), NBINS + 5)
    return torch.bincount(bins.reshape(-1).to(torch.int64),
                          minlength=NBINS + 6)[:NBINS + 1]


def hydro_step(grid: CellGrid, p: SPHENIXParams, cfg: EngineConfig,
               gravity_fn: Optional[Callable], cosmo: CosmoFactors,
               s: Dict, T: StepTables,
               cooling_fn: Optional[Callable] = None):
    """One full engine step (drift -> loops -> cooling -> KDK) for the
    gas.  Returns (new_state, diagnostics)."""
    mask_b = s["mask"] > 0
    active = mask_b & T.active[_tb_index(s["time_bin"])]

    # --- drift all (drift.h:144 drift_part) --------------------------------
    a_tot = s["a_hydro"] + s["a_grav"] + s["a_grav_mesh"]
    s = {**s,
         "off": s["off"] + s["v_full"] * T.dt_drift * s["mask"][..., None],
         "v": s["v"] + a_tot * T.dt_drift}
    s = p.mod.predict_extra(p, s, cosmo, T.dt_drift, T.dt_therm_drift)

    # --- rebucket (space_rebuild analog) ------------------------------------
    reach = torch.clamp_min(
        torch.amax(torch.where(mask_b, s["h"], 0.0))
        * _f32(p.kernel.gamma), _f32(cfg.p2p_reach))
    s, n_overflow = _rebucket_phase(grid, cfg, s, T, reach)
    mask_b = s["mask"] > 0
    tb = _tb_index(s["time_bin"])
    active = mask_b & T.active[tb]

    # --- density/ghost/gradient/force loops (active only); a gravity_fn
    # that advertises its P2P literals runs INSIDE the force pass ----------
    fuse_spec = getattr(gravity_fn, "fuse_spec", None)
    s, n_ghost_iter = _gas_loops(grid, p, cfg, cosmo, s, active,
                                 T.dt_alpha, fuse_spec=fuse_spec)
    if gravity_fn is not None and fuse_spec is None:
        a_grav, pot = gravity_fn(s)
        s["a_grav"] = _where_active(active, a_grav, s["a_grav"])
        s["pot"] = torch.where(active, pot, s["pot"])
    s = _apply_cooling(cooling_fn, cosmo, s, T, active, tb)

    s, too_small, n_woken = _gas_kdk(grid, p, cfg, cosmo, s, T, active,
                                     mask_b, tb)

    diag = {
        "bin_counts": _bin_counts(mask_b, s["time_bin"]),
        "n_overflow": n_overflow,
        "n_dt_too_small": torch.sum(too_small),
        "n_ghost_iter": n_ghost_iter,
        "n_active": torch.sum(active),
        "n_woken": n_woken,
        "h_max_active": torch.amax(torch.where(active, s["h"], 0.0)),
        # fullest live cell: the occupancy re-grid trigger's input
        "k_max_live": torch.amax(torch.sum(mask_b, dim=1)),
    }
    return s, diag


def multi_step(grid, p, cfg, gravity_fn, k, cosmo, s, T, cooling_fn=None):
    """k engine steps at the fixed global timestep.

    Valid only while every particle stays in the same (maximal) bin; a
    device-side flag records any bin deviation or overflow so the host can
    reject the run without a read per step."""
    bad = torch.zeros((), dtype=torch.bool, device=s["mask"].device)
    for _ in range(k):
        s, diag = hydro_step(grid, p, cfg, gravity_fn, cosmo, s, T,
                             cooling_fn)
        bins = torch.where(s["mask"] > 0, s["time_bin"], T.max_bin)
        bad = (bad | torch.any(bins != T.max_bin)
               | (diag["n_overflow"] > 0))
    return s, {"bin_deviation": bad}


def _init_pass(grid, p, cfg, gravity_fn, cosmo, s, T):
    """engine_init_particles: density/ghost + force + first bins + kick1."""
    mask_b = s["mask"] > 0
    active = mask_b  # everyone is active at t=0
    engine = BACKENDS[cfg.backend]

    h_new, dens, n_iter = _ghost_density(grid, p, cosmo, s, active,
                                         cfg.max_ghost_iterations, engine)
    s = {**s, "h": torch.where(active, h_new, s["h"])}
    for k, v in dens.items():
        s[k] = _where_active(active, v, s[k])
    s = p.mod.no_neighbours_fallback(p, s)
    s = p.mod.reset_gradient(p.mod.prepare_gradient(p, s, cosmo))
    if p.mod.HAS_GRADIENT_LOOP:
        s = {**s, **hydro_flat.gradient_loop(grid, s, p, cosmo,
                                             engine=engine)}
        s = p.mod.end_gradient(s)
    s = p.mod.reset_acceleration(p.mod.prepare_force(p, s, cosmo, 0.0))
    s = {**s, **hydro_flat.force_loop(grid, s, p, cosmo, engine=engine)}
    s = p.mod.end_force(p, s)

    if gravity_fn is not None:
        a_grav, pot = gravity_fn(s)
        s = {**s, "a_grav": a_grav, "pot": pot}

    # initial timestep + bins
    new_dt = torch.clamp_max(
        torch.minimum(p.mod.compute_timestep(p, s, cosmo),
                      p.mod.timestep_h_change_limit(p, s)),
        _f32(cfg.dt_max))
    too_small = active & (new_dt < cfg.dt_min)
    new_bin = torch.clamp(bin_from_dt(new_dt, T.time_base_inv), 1, NBINS)
    new_bin = torch.clamp_max(new_bin, T.max_bin)
    s["time_bin"] = torch.where(active, new_bin, 0)

    # first half-kick
    dt_k1 = T.dt_kick1[_tb_index(s["time_bin"])]
    a_tot = s["a_hydro"] + s["a_grav"]
    s["v_full"] = s["v_full"] + a_tot * dt_k1[..., None] \
        * s["mask"][..., None]
    ke = p.mod.kick_extra(p, s, cosmo, dt_k1 * s["mask"])
    s = {**s, "u_full": ke["u_full"], "u_dt": ke["u_dt"]}

    diag = {
        "bin_counts": _bin_counts(mask_b, s["time_bin"]),
        "n_overflow": torch.zeros((), dtype=I32, device=mask_b.device),
        "n_dt_too_small": torch.sum(too_small),
        "n_ghost_iter": n_iter,
        "n_active": torch.sum(active),
        "h_max_active": torch.amax(torch.where(active, s["h"], 0.0)),
    }
    return s, diag


# ---------------------------------------------------------------------------
# Collisionless (dark-matter) step
# ---------------------------------------------------------------------------

def _dm_kdk(cfg: EngineConfig, eps_soft: float, s: Dict, T: StepTables,
            active, tb):
    """kick2 -> timestep -> kick1 for collisionless particles (kick_gpart
    kick.h:141, get_gpart_timestep timestep.h:95).  Returns (state,
    too_small)."""
    v_full = s["v_full"] + s["a_grav"] * T.dt_kick2[tb][..., None]
    s = {**s, "v_full": _where_active(active, v_full, s["v_full"])}

    # timestep: dt = sqrt(2 eta eps / |a|), the split-mesh part included
    a = s["a_grav"] + s["a_grav_mesh"]
    a_norm = torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]
                        + a[..., 2] * a[..., 2])
    new_dt = torch.sqrt(_f32(2.0 * cfg.eta_grav * eps_soft)
                        / torch.clamp_min(a_norm, 1e-30))
    new_dt = torch.clamp_max(new_dt, _f32(cfg.dt_max))
    too_small = active & (new_dt < cfg.dt_min)
    want_bin = torch.clamp(bin_from_dt(new_dt, T.time_base_inv), 1, NBINS)
    want_bin = torch.clamp_max(want_bin, T.max_bin)
    cur = tb.to(I32)
    up_ok = T.aligned_up[tb]
    new_bin = torch.where(
        (want_bin > cur) & (cur > 0),
        torch.where(up_ok, torch.minimum(want_bin, cur + 1), cur), want_bin)
    s["time_bin"] = torch.where(active, new_bin, s["time_bin"])

    # kick1 (first half of the new step)
    tb1 = _tb_index(s["time_bin"])
    v_full = s["v_full"] + s["a_grav"] * T.dt_kick1[tb1][..., None]
    s["v_full"] = _where_active(active, v_full, s["v_full"])
    return s, too_small


def dm_step(grid: CellGrid, cfg: EngineConfig, gravity_fn: Callable,
            eps_soft: float, s: Dict, T: StepTables):
    """Collisionless step: drift -> rebucket -> gravity -> KDK, SWIFT's
    gravity-only pipeline (runner_doiact_grav + kick_gpart, kick.h:141).
    Returns (new_state, diagnostics)."""
    s = {**s, "off": s["off"] + s["v_full"] * T.dt_drift
         * s["mask"][..., None]}
    # trigger-based rebucket; the reach is the P2P r_cut
    s, n_overflow = _rebucket_phase(grid, cfg, s, T, _f32(cfg.p2p_reach))
    mask_b = s["mask"] > 0
    tb = _tb_index(s["time_bin"])
    active = mask_b & T.active[tb]

    # gravity on every particle; inactive ones keep their old a_grav
    acc, pot = gravity_fn(s)
    s["a_grav"] = _where_active(active, acc, s["a_grav"])
    s["pot"] = torch.where(active, pot, s["pot"])

    s, too_small = _dm_kdk(cfg, eps_soft, s, T, active, tb)
    diag = {
        "bin_counts": _bin_counts(mask_b, s["time_bin"]),
        "n_overflow": n_overflow,
        "n_dt_too_small": torch.sum(too_small),
        "n_ghost_iter": 0,
        "n_active": torch.sum(active),
        "h_max_active": torch.zeros((), device=mask_b.device),
        "k_max_live": torch.amax(torch.sum(mask_b, dim=1)),
    }
    return s, diag


def _dm_init(grid, cfg, gravity_fn, eps_soft, s, T):
    """The collisionless engine_init_particles: gravity, first bins and
    the first half-kick."""
    acc, pot = gravity_fn(s)
    s = {**s, "a_grav": acc, "pot": pot}
    a_norm = torch.sqrt(acc[..., 0] * acc[..., 0] + acc[..., 1] * acc[..., 1]
                        + acc[..., 2] * acc[..., 2])
    new_dt = torch.sqrt(_f32(2.0 * cfg.eta_grav * eps_soft)
                        / torch.clamp_min(a_norm, 1e-30))
    new_dt = torch.clamp_max(new_dt, _f32(cfg.dt_max))
    mask_b = s["mask"] > 0
    new_bin = torch.clamp(bin_from_dt(new_dt, T.time_base_inv), 1, NBINS)
    new_bin = torch.clamp_max(new_bin, T.max_bin)
    s["time_bin"] = torch.where(mask_b, new_bin, 0)
    dt_k1 = T.dt_kick1[_tb_index(s["time_bin"])]
    s["v_full"] = s["v_full"] + acc * dt_k1[..., None] \
        * s["mask"][..., None]
    diag = {"bin_counts": _bin_counts(mask_b, s["time_bin"]),
            "n_overflow": torch.zeros((), dtype=I32, device=mask_b.device),
            "n_dt_too_small": torch.sum(mask_b & (new_dt < cfg.dt_min)),
            "n_ghost_iter": 0, "n_active": torch.sum(mask_b),
            "h_max_active": torch.zeros((), device=mask_b.device)}
    return s, diag


def _dm_tiles(grid: CellGrid, pos, m, v, pid, device, zsort: bool):
    """Bucket collisionless particles into a tiled state (load_dm)."""
    n = len(pos)
    if pid is None:
        pid = np.arange(n, dtype=np.int32)
    fields = {"pid": np.asarray(pid, np.int32),
              "m": np.asarray(m, np.float32),
              "v_full": np.asarray(v, np.float32)}
    out, mask, off, n_over = bucket_fields(grid, np.asarray(pos), fields,
                                           device=device, zsort=zsort)
    if int(n_over) != 0:
        raise RuntimeError(f"{int(n_over)} DM particles overflow K")
    C, K = grid.C, grid.K
    return {"mask": mask, "off": off, **out,
            "a_grav": torch.zeros((C, K, 3), dtype=F32, device=device),
            "a_grav_mesh": torch.zeros((C, K, 3), dtype=F32, device=device),
            "pot": torch.zeros((C, K), dtype=F32, device=device),
            "pot_mesh": torch.zeros((C, K), dtype=F32, device=device),
            "time_bin": torch.zeros((C, K), dtype=I32, device=device),
            "drift_accum": torch.zeros((), dtype=F32, device=device)}


def _pad_slots(a: torch.Tensor, extra: int, fill=0) -> torch.Tensor:
    """(C, K, ...) -> (C, K + extra, ...), the new slots ``fill``."""
    pad = torch.full((a.shape[0], extra) + tuple(a.shape[2:]), fill,
                     dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=1)


def _mesh_update(mesh_fn, s, dt_close: float, dt_open: float):
    """Separate PM-mesh kick at a mesh-step boundary (kick.h:255): close
    the old mesh half-kick with the OLD field, recompute the field, open
    the next half-kick with the NEW one.  Returns (state, max |a_mesh|)."""
    mb = s["mask"][..., None]
    v = s["v_full"] + s["a_grav_mesh"] * (dt_close * mb)
    acc_new, pot_new = mesh_fn({**s, "v_full": v})
    v = v + acc_new * (dt_open * mb)
    amax = torch.amax(torch.sqrt(torch.sum(acc_new * acc_new, -1)))
    return {**s, "v_full": v, "a_grav_mesh": acc_new * mb,
            "pot_mesh": pot_new * s["mask"]}, amax


def _mesh_open(s, dt: float):
    mb = s["mask"][..., None]
    return {**s, "v_full": s["v_full"] + s["a_grav_mesh"] * (dt * mb)}


# ---------------------------------------------------------------------------
# Host-side driver
# ---------------------------------------------------------------------------

class Engine:
    """Host orchestrator: owns the timeline, builds per-step tables, runs
    the step on ``device`` (the card unless the caller names another),
    reads end-of-step diagnostics and re-grids when a step hits a wall."""

    def __init__(self, grid: CellGrid, sph: SPHENIXParams,
                 cfg: EngineConfig, time_begin: float, time_end: float,
                 *, device="cuda", gravity_fn: Optional[Callable] = None,
                 mesh_fn: Optional[Callable] = None,
                 mesh_dt_scale: float = 0.0, cosmology=None,
                 cooling_fn: Optional[Callable] = None):
        if cfg.backend not in BACKENDS:
            raise ValueError(f"backend {cfg.backend!r} is not ported "
                             f"(have {sorted(BACKENDS)})")
        if cfg.backend != "flat":
            refuse_unported_mode(sph, f"the {cfg.backend!r} backend")
        self.device = torch.device(device)
        self.grid = grid
        self.sph = sph
        self.cfg = cfg
        self.cooling_fn = cooling_fn
        self.cosmology = cosmology  # models.cosmology.Cosmology or None
        if cosmology is not None:
            # cosmological runs: the integer timeline lives in log(a)
            self.timeline = tl.Timeline(cosmology.log_a_begin,
                                        cosmology.log_a_end)
            self.cosmo = cosmology.factors_at(0)
        else:
            self.timeline = tl.Timeline(time_begin, time_end)
            self.cosmo = NO_COSMO
        # split PM mesh: gravity_fn is the short-range part only; the mesh
        # field lives on its own longer timestep (engine.c:2406 ti_mesh)
        self.gravity_fn = gravity_fn
        self.mesh_fn = mesh_fn
        self.mesh_dt_scale = float(mesh_dt_scale)
        self.ti_mesh_end = None
        self.ti_mesh_mid = None
        self.n_mesh_updates = 0
        self.state: Dict[str, torch.Tensor] = {}
        self.step_count = 0
        self._ti_end_min = 0
        # CellGrid -> GravitySolver factory: re-grids rebind gravity
        self.solver_builder: Optional[Callable] = None
        self._last_shrink_step = 0
        self.n_regrids = 0          # every rebuilt grid
        self.n_regrid_retries = 0   # steps retried after RegridNeeded
        self.n_shrink_regrids = 0   # occupancy re-grids

    # --- setup ------------------------------------------------------------
    def load_particles(self, pos, m, v, u, h, pid=None, Z=None,
                       elem_frac=None, extra_fields=None):
        """Bucket raw particle arrays into the tiled state (z-sorted on the
        flat backend); ``Z`` (N,) and ``elem_frac`` (N, 9) are the
        chemistry carriers, when the run has them; ``extra_fields`` a dict
        of more (N,) arrays bucketed alongside (Planetary's ``mat_id``),
        int32 for the scheme's ``EXTRA_STATE_INT_KEYS``, f32 else."""
        n = len(pos)
        if pid is None:
            pid = np.arange(n, dtype=np.int32)
        fields = {
            "pid": np.asarray(pid, np.int32),
            "m": np.asarray(m, np.float32),
            "v": np.asarray(v, np.float32),
            "v_full": np.asarray(v, np.float32),
            "h": np.asarray(h, np.float32),
            "u": np.asarray(u, np.float32),
            "u_full": np.asarray(u, np.float32),
        }
        if Z is not None:
            fields["Z"] = np.asarray(Z, np.float32)
        if elem_frac is not None:
            fields["elem_frac"] = np.asarray(elem_frac, np.float32)
        int_keys = self.sph.mod.EXTRA_STATE_INT_KEYS
        for k, arr in (extra_fields or {}).items():
            fields[k] = np.asarray(
                arr, np.int32 if k in int_keys else np.float32)
        out, mask, off, n_over = bucket_fields(
            self.grid, np.asarray(pos), fields, device=self.device,
            zsort=self.cfg.backend == "flat")
        if int(n_over) != 0:
            raise RuntimeError(
                f"{int(n_over)} particles overflowed cell capacity "
                f"K={self.grid.K}; rebuild the grid with more headroom")
        C, K = self.grid.C, self.grid.K
        dev = self.device

        def z():
            return torch.zeros((C, K), dtype=F32, device=dev)

        def z3():
            return torch.zeros((C, K, 3), dtype=F32, device=dev)

        self.state = {
            "mask": mask, "off": off, **out,
            "u_dt": z(), "rho": z(), "wcount": z(), "wcount_dh": z(),
            "rho_dh": z(), "div_v": z(), "rot_v": z3(),
            "alpha_visc": torch.full((C, K), self.sph.viscosity_alpha,
                                     dtype=F32, device=dev) * mask,
            "v_sig": z(), "div_v_prev": z(),
            "alpha_diff": torch.full((C, K), self.sph.diffusion_alpha,
                                     dtype=F32, device=dev) * mask,
            "laplace_u": z(), "f_gradh": z(), "pressure": z(),
            "soundspeed": z(), "balsara": z(),
            "alpha_visc_max_ngb": z(), "a_hydro": z3(), "h_dt": z(),
            "a_grav": z3(), "a_grav_mesh": z3(), "pot": z(),
            "pot_mesh": z(),
            "time_bin": torch.zeros((C, K), dtype=I32, device=dev),
            "min_ngb_time_bin": torch.full((C, K), NBINS, dtype=I32,
                                           device=dev),
            "drift_accum": torch.zeros((), dtype=F32, device=dev),
        }
        # scheme-specific state (Pressure-Energy's smoothed pressure);
        # keys loaded from extra_fields keep their values
        for k in self.sph.mod.EXTRA_STATE_KEYS:
            self.state.setdefault(
                k, torch.zeros((C, K), dtype=I32, device=dev)
                if k in int_keys else z())

    # --- split PM-mesh timestep (kick.h:255, engine.c:2406) ----------------
    def _kick_fac(self, lo: int, hi: int) -> float:
        c = self.cosmology
        if c is None:
            return (hi - lo) * self.timeline.time_base
        return float(c.grav_kick_factor(lo, hi))

    def _pick_mesh_dti(self, amax: float) -> int:
        """Largest aligned power-of-2 interval under the mesh timestep
        dt = sqrt(2 eta r_s / |a_mesh|max) (get_mesh_timestep analog); in
        cosmological runs the interval's span is a physical time."""
        t = self.timeline
        c = self.cosmology
        ti = t.ti_current
        L = self.mesh_dt_scale if self.mesh_dt_scale > 0 else 1e-3
        dt = float(np.sqrt(2.0 * self.cfg.eta_grav * L / max(amax, 1e-30)))
        dt = min(dt, self.cfg.mesh_dt_max or self.cfg.dt_max)
        b = 1
        while b < NBINS:
            dti_n = tl.get_integer_timestep(b + 1)
            if ti % dti_n:
                break
            if c is None:
                if dti_n * t.time_base > dt:
                    break
            elif c.delta_time(ti, min(ti + dti_n,
                                      tl.MAX_NR_TIMESTEPS)) > dt:
                break
            b += 1
        return tl.get_integer_timestep(b)

    def _mesh_boundary(self):
        """Close the old mesh half-kick, recompute the PM field, size the
        next mesh step and open its first half-kick."""
        ti = self.timeline.ti_current
        dt_close = (0.0 if self.ti_mesh_mid is None
                    else self._kick_fac(self.ti_mesh_mid, ti))
        self.state, amax = _mesh_update(self.mesh_fn, self.state,
                                        _f32(dt_close), 0.0)
        dti = self._pick_mesh_dti(float(amax))
        self.ti_mesh_end = min(ti + dti, tl.MAX_NR_TIMESTEPS)
        self.ti_mesh_mid = min(ti + dti // 2, tl.MAX_NR_TIMESTEPS)
        dt_open = self._kick_fac(ti, self.ti_mesh_mid)
        self.state = _mesh_open(self.state, _f32(dt_open))
        self.n_mesh_updates += 1

    def init_particles(self):
        """First density/ghost/force pass + initial bins + first kick1
        (engine_init_particles, engine.c:1893), re-gridding on a wall."""
        return self._with_regrid_retry(self._init_particles_once)

    def _init_particles_once(self):
        if self.mesh_fn is not None:
            self._mesh_boundary()
        T = self._tables()
        self.state, diag = _init_pass(self.grid, self.sph, self.cfg,
                                      self.gravity_fn, self.cosmo,
                                      self.state, T)
        self._post_step(diag)
        return diag

    # --- stepping ---------------------------------------------------------
    def _tables(self, dt_drift: float = 0.0,
                ti_drift_start: Optional[int] = None) -> StepTables:
        """The step's per-bin tables at ti_current.  In cosmological runs
        kick2 closes [ti - dti/2, ti] and kick1 opens [ti, ti + dti/2]
        with the cosmology's integrals of 1/a (velocity) and of the
        thermal power of 1/a, the drift since ``ti_drift_start`` is the
        integral of 1/a^2, and the step takes ``factors_at(ti)``."""
        t = self.timeline
        c = self.cosmology
        ti = t.ti_current
        tabs = {k: np.zeros(NBINS + 1, np.float32)
                for k in ("k1", "k2", "t1", "t2", "full", "tf")}
        aligned_up = np.zeros(NBINS + 1, bool)
        for b in range(1, NBINS + 1):
            dti = tl.get_integer_timestep(b)
            if c is None:
                half = 0.5 * dti * t.time_base
                for k in ("k1", "k2", "t1", "t2"):
                    tabs[k][b] = half
                tabs["full"][b] = tabs["tf"][b] = dti * t.time_base
            else:
                lo2 = max(ti - dti // 2, 0)
                hi1 = min(ti + dti // 2, tl.MAX_NR_TIMESTEPS)
                lo = max(ti - dti, 0)
                tabs["k2"][b] = c.grav_kick_factor(lo2, ti)
                tabs["k1"][b] = c.grav_kick_factor(ti, hi1)
                tabs["t2"][b] = c.therm_kick_factor(lo2, ti)
                tabs["t1"][b] = c.therm_kick_factor(ti, hi1)
                tabs["full"][b] = c.delta_time(lo, ti)
                tabs["tf"][b] = c.therm_kick_factor(lo, ti)
            up = tl.get_integer_timestep(min(b + 1, NBINS))
            aligned_up[b] = (ti % up) == 0
        max_bin = 1
        if c is None:
            while (max_bin < NBINS and tl.get_integer_timestep(max_bin + 1)
                   * t.time_base <= self.cfg.dt_max):
                max_bin += 1
            tb_inv = t.time_base_inv
            dt_therm_drift = dt_drift
        else:
            # dt_max is a physical time: the largest bin whose span stays
            # under it
            while (max_bin < NBINS and c.delta_time(ti, min(
                    ti + tl.get_integer_timestep(max_bin + 1),
                    tl.MAX_NR_TIMESTEPS)) <= self.cfg.dt_max):
                max_bin += 1
            # physical dt -> Delta log(a): times H (timestep.h)
            tb_inv = float(c.H(c.a_of_ti(ti))) * t.time_base_inv
            self.cosmo = c.factors_at(ti)
            if ti_drift_start is not None:
                dt_drift = c.drift_factor(ti_drift_start, ti)
                dt_therm_drift = c.therm_kick_factor(ti_drift_start, ti)
            else:
                dt_therm_drift = dt_drift
        dev = self.device
        wake_dv, wake_du = self._wake_tables(ti)

        def on(a):
            return torch.as_tensor(a, device=dev)

        return StepTables(
            active=on(t.active_bins_mask()),
            dt_kick1=on(tabs["k1"]), dt_kick2=on(tabs["k2"]),
            dt_therm1=on(tabs["t1"]), dt_therm2=on(tabs["t2"]),
            dt_alpha=on(tabs["full"]), dt_therm_full=on(tabs["tf"]),
            aligned_up=on(aligned_up),
            dt_drift=_f32(dt_drift), dt_therm_drift=_f32(dt_therm_drift),
            max_bin=max_bin, time_base_inv=_f32(tb_inv),
            wake_dv=on(wake_dv), wake_du=on(wake_du),
            max_active_bin=t.max_active_bin(),
            ti_lo=ti & 0x7FFFFFFF, ti_hi=(ti >> 31) & 0x7FFFFFFF,
            birth_time=_f32(c.a_of_ti(ti) if c is not None
                            else t.time_of(ti)))

    def _wake_tables(self, ti: int):
        """(old_bin, new_bin) -> net wake kick (timestep_limit_part,
        timestep_limiter.h:64).

        A woken particle had received kick1 over [beg_old, beg_old +
        dti_o/2]; the limiter (i) reverses it, (ii) kicks over [beg_old,
        beg_new] (beg_new = last dti_n-aligned tick <= ti), (iii) applies
        the new step's kick1 [beg_new, beg_new + dti_n/2], merged into one
        net dt per (old, new) bin pair; without cosmology the velocity and
        thermal kicks share it, with it each takes its own integral."""
        wake_dv = np.zeros((NBINS + 1, NBINS + 1), np.float32)
        wake_du = np.zeros((NBINS + 1, NBINS + 1), np.float32)
        if not self.cfg.with_timestep_limiter or ti <= 0:
            return wake_dv, wake_du
        c = self.cosmology
        tb = self.timeline.time_base
        for bo in range(2, NBINS + 1):
            dto = tl.get_integer_timestep(bo)
            beg_o = dto * ((ti - 1) // dto)
            half_o = beg_o + dto // 2
            for bn in range(1, bo):
                dtn = tl.get_integer_timestep(bn)
                beg_n = dtn * (ti // dtn)
                half_n = beg_n + dtn // 2
                if c is None:
                    dv = du = ((beg_n - half_o) + (half_n - beg_n)) * tb
                else:
                    dv = (-c.grav_kick_factor(beg_o, half_o)
                          + c.grav_kick_factor(beg_o, beg_n)
                          + c.grav_kick_factor(beg_n, half_n))
                    du = (-c.therm_kick_factor(beg_o, half_o)
                          + c.therm_kick_factor(beg_o, beg_n)
                          + c.therm_kick_factor(beg_n, half_n))
                wake_dv[bo, bn] = dv
                wake_du[bo, bn] = du
        return wake_dv, wake_du

    def step(self):
        """One step, re-gridding and retrying it on a wall, then the
        occupancy shrink check (the reference's Engine.step without
        particle splitting)."""
        diag = self._with_regrid_retry(self._step_once)
        trig = self.cfg.regrid_shrink_trigger
        k_need = float(diag.get("k_max_live", 0.0))
        if (trig > 0 and k_need > 0 and self.grid.K > 128
                and 1.7 * k_need < trig * self.grid.K
                and self.step_count - self._last_shrink_step
                >= self.cfg.regrid_cooldown):
            self.regrid()
            self._last_shrink_step = self.step_count
            self.n_shrink_regrids += 1
        return diag

    def _step_once(self):
        """Advance to the next ti_end_min (engine_step, engine.c:2245)."""
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
        self.state, diag = hydro_step(self.grid, self.sph, self.cfg,
                                      self.gravity_fn, self.cosmo,
                                      self.state, T, self.cooling_fn)
        self._post_step(diag)
        self.step_count += 1
        if self.mesh_fn is not None and t.ti_current >= self.ti_mesh_end:
            self._mesh_boundary()
        return diag

    # --- automatic re-gridding (space_regrid, space.c) ---------------------
    def _with_regrid_retry(self, fn, max_attempts: int = 3):
        """Run a step; on a capacity/coverage wall restore the pre-step
        state and timeline, rebuild the grid from the live particles and
        retry.  A failed attempt leaves the saved tensors untouched: the
        step builds new tensors and new dicts, never writes into them."""
        for _ in range(max_attempts):
            saved = (self.state, self.timeline.ti_current, self._ti_end_min,
                     self.step_count, self.ti_mesh_end, self.ti_mesh_mid)
            try:
                return fn()
            except RegridNeeded as e:
                (self.state, self.timeline.ti_current, self._ti_end_min,
                 self.step_count, self.ti_mesh_end, self.ti_mesh_mid) \
                    = saved
                self.n_regrid_retries += 1
                self.regrid(h_reach=e.h_reach)
        raise RuntimeError(
            f"re-grid did not converge after {max_attempts} attempts")

    def _grid_reach(self, h_reach: float = 0.0) -> float:
        """Interaction range a rebuilt grid must cover."""
        reach = float(self.cfg.p2p_reach)
        if "h" in self.state:
            mask = self.state["mask"] > 0
            if bool(mask.any()):
                h_now = float(self.state["h"][mask].max())
                reach = max(reach, h_now * self.sph.kernel.gamma * 1.05)
        return max(reach, h_reach * 1.05)

    def _extract_particles(self, state):
        """Live particles of a tiled state -> (pos f64 (N, 3), fields)."""
        mask = (state["mask"] > 0).cpu().numpy()
        pos = global_positions(self.grid, state["off"])[mask]
        K = state["mask"].shape[1]
        fields = {}
        for k, v in state.items():
            if k in ("mask", "off"):
                continue
            if v.dim() >= 2 and tuple(v.shape[:2]) == (self.grid.C, K):
                fields[k] = v.cpu().numpy()[mask]
        return pos, fields

    def _rebucket_species(self, grid: CellGrid, pos, fields,
                          extra_slots: int = 0):
        """Bucket extracted particles onto a new grid, with
        ``extra_slots`` free slots a cell after its capacity."""
        out, mask, off, n_over = bucket_fields(
            grid, pos, fields, device=self.device,
            zsort=self.cfg.backend == "flat")
        if int(n_over) != 0:
            raise RuntimeError(
                f"{int(n_over)} particles overflow even the rebuilt grid")
        if extra_slots > 0:
            out = {k: _pad_slots(v, extra_slots, -1 if k == "pid" else 0)
                   for k, v in out.items()}
            mask, off = _pad_slots(mask, extra_slots), \
                _pad_slots(off, extra_slots)
        return {"mask": mask, "off": off, **out,
                "drift_accum": torch.zeros((), dtype=F32,
                                           device=self.device)}

    def _build_grid(self, pos_all, reach: float) -> CellGrid:
        if self.cfg.backend == "flat":
            return CellGrid.build_columns(self.grid.box, reach, pos_all)
        return CellGrid.build_for_positions(self.grid.box, reach, pos_all,
                                            headroom=1.6)

    def regrid(self, h_reach: float = 0.0):
        """Rebuild the grid from the live state and re-bucket everything
        (space_regrid + space_rebuild): cdim and K come from the actual
        particle distribution.  Gravity closures capture the grid, so with
        gravity they are rebuilt from ``solver_builder`` (a CellGrid ->
        GravitySolver factory); without one this raises before anything
        is replaced."""
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
        pos, fields = self._extract_particles(self.state)
        new_grid = self._build_grid(pos, reach)
        state = self._rebucket_species(new_grid, pos, fields)
        if gravity:
            self._bind_solver(self.solver_builder(new_grid))
        self.state, self.grid = state, new_grid
        self.n_regrids += 1

    def _bind_solver(self, solver):
        """The split-mesh gravity of ``solver`` (the port's only mode)."""
        self.gravity_fn = solver.gas_short_range_fn()
        self.mesh_fn = solver.gas_mesh_fn()
        self.mesh_dt_scale = solver.pm.r_s

    def _post_step(self, diag):
        counts = diag["bin_counts"].cpu().numpy()
        self._ti_end_min = self.timeline.ti_end_min_from_bins(counts)
        if int(diag["n_overflow"]) != 0:
            raise RegridNeeded(
                f"cell overflow during rebucket at step {self.step_count}: "
                f"{int(diag['n_overflow'])} particles (grid too tight)")
        if int(diag["n_dt_too_small"]) != 0:
            raise RuntimeError(
                f"{int(diag['n_dt_too_small'])} particles want dt < dt_min")
        # h grew beyond the columns' coverage -> would silently lose pairs
        h_reach = float(diag["h_max_active"]) * self.sph.kernel.gamma
        if h_reach > min(self.grid.edge) * (1 + 1e-5):
            raise RegridNeeded(
                f"smoothing length reach {h_reach:.4g} exceeds cell edge "
                f"{min(self.grid.edge):.4g}", h_reach=h_reach)

    def run_fixed_dt(self, n_steps: int, per_launch: int = 8):
        """Advance n_steps with the global fixed timestep (= dt_max) in
        batches of per_launch steps, reading the bin-deviation flags once
        at the end.  With a split PM mesh, batches stop at mesh-step
        boundaries, where the mesh field is recomputed."""
        t = self.timeline
        b = self._tables().max_bin          # everyone must be in max_bin
        dti = tl.get_integer_timestep(b)
        T = self._tables(dt_drift=dti * t.time_base)
        if self.mesh_fn is not None and self.ti_mesh_end is None:
            self._mesh_boundary()
        done = 0
        deviations = []
        while done < n_steps:
            k = min(per_launch, n_steps - done)
            if self.mesh_fn is not None:
                k = min(k, max(1, (self.ti_mesh_end - t.ti_current) // dti))
            self.state, diag = multi_step(self.grid, self.sph, self.cfg,
                                          self.gravity_fn, k, self.cosmo,
                                          self.state, T, self.cooling_fn)
            deviations.append(diag["bin_deviation"])
            t.ti_current += k * dti
            self.step_count += k
            done += k
            if (self.mesh_fn is not None
                    and t.ti_current >= self.ti_mesh_end):
                self._mesh_boundary()
        if bool(torch.stack(deviations).any()):
            raise RuntimeError(
                "fixed-dt run invalid: a particle left the maximal bin "
                "(CFL below dt_max) or a cell overflowed")
        counts = np.zeros(NBINS + 1, int)
        counts[b] = 1
        self._ti_end_min = self.timeline.ti_end_min_from_bins(counts)

    @property
    def time(self) -> float:
        return self.timeline.time_of(self.timeline.ti_current)

    def run(self, t_end: Optional[float] = None, max_steps: int = 10 ** 9,
            on_step: Optional[Callable[[Dict], None]] = None):
        """Step until ti_current reaches t_end (or max_steps); returns the
        number of steps.  ``on_step`` receives each step's diagnostics."""
        t_end = self.timeline.time_end if t_end is None else t_end
        ti_end = min(
            tl.MAX_NR_TIMESTEPS,
            int(round((t_end - self.timeline.time_begin)
                      / self.timeline.time_base)))
        steps = 0
        while self.timeline.ti_current < ti_end and steps < max_steps:
            diag = self.step()
            if on_step is not None:
                on_step(diag)
            steps += 1
        return steps


class DMEngine(Engine):
    """Gravity-only engine (EAGLE_DMO-style runs, bench.py's dmo mode):
    the same timeline and tables, collisionless KDK stepping
    (``dm_step``).  ``gravity_fn`` and ``mesh_fn`` take one species'
    state (``GravitySolver.gas_short_range_fn`` / ``gas_mesh_fn``)."""

    def __init__(self, grid: CellGrid, cfg: EngineConfig, time_begin: float,
                 time_end: float, gravity_fn: Callable, eps_soft: float, *,
                 device="cuda", cosmology=None,
                 mesh_fn: Optional[Callable] = None,
                 mesh_dt_scale: float = 0.0):
        if cfg.backend != "flat":
            raise ValueError(f"the port's DMEngine runs on the flat column "
                             f"grid only (backend {cfg.backend!r})")
        super().__init__(grid, SPHENIXParams(), cfg, time_begin, time_end,
                         device=device, gravity_fn=gravity_fn,
                         mesh_fn=mesh_fn, mesh_dt_scale=mesh_dt_scale,
                         cosmology=cosmology)
        self.eps_soft = float(eps_soft)

    def load_dm(self, pos, m, v, pid=None):
        """Bucket the particles (z-sorted columns)."""
        self.state = _dm_tiles(self.grid, pos, m, v, pid, self.device,
                               zsort=True)
        self.n_particles = len(pos)

    def _init_particles_once(self):
        if self.mesh_fn is not None:
            self._mesh_boundary()
        T = self._tables()
        self.state, diag = _dm_init(self.grid, self.cfg, self.gravity_fn,
                                    self.eps_soft, self.state, T)
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
        # ti_drift_start: cosmological runs drift by the integral of 1/a^2
        T = self._tables(dt_drift=dt_drift, ti_drift_start=ti_old)
        self.state, diag = dm_step(self.grid, self.cfg, self.gravity_fn,
                                   self.eps_soft, self.state, T)
        self._post_step(diag)
        self.step_count += 1
        if self.mesh_fn is not None and t.ti_current >= self.ti_mesh_end:
            self._mesh_boundary()
        return diag

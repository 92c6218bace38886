"""Black-hole interaction loops (EAGLE AGN) over the 27-cell stencil.

Port of the reference's ``ops/black_holes.py`` (SWIFT's
src/black_holes/EAGLE/black_holes_iact.h) on the live-slot walk of
``ops.stencil`` (``_stencil_walk``):

* ``bh_gas_density_loop``: the kernel-smoothed gas density, neighbour
  mass, gas velocity and sound speed at each BH (the Bondi rate's input);
* ``bh_swallow_target_loop``: each gas particle picks at most one BH that
  swallows it (the pair-hash draw; the largest BH pid whose draw hit);
* ``bh_swallow_collect_loop``: each BH sums the mass and momentum of the
  gas that picked it (runner_do_gas_swallow);
* ``bh_reposition_loop``: the displacement to the gas neighbour at the
  lowest potential;
* ``bh_merger_mark_loop``, ``bh_merger_collect_loop`` and
  ``bh_merger_consumed_loop``: BH-BH mergers, the lighter onto the
  heavier, chains deferred.

Each loop walks the 27 offsets as one j axis (``packed``: one BH
against a column's gas is a small tile, and 27 times fewer operations
keep the host's launch rate out of the way), as the reference's packed
stencil does.  The three selections (swallow target, reposition, merger
mark) keep the reference's tie order: the earlier offset, then the
first j slot (argmin) or the largest pid.  The two collect loops count
a pair on its nearest periodic image only (``_nearest``): on the column
grid (``ncz = 1``) the stencil's dz = -1, 0, 1 cells are one column, so
the reference, whose collect test has no distance, counts each
swallowed gas particle and each merged BH three times (ROADMAP.md,
queue 3).  The spin-jet
model's angular momentum and spin sums are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .stencil import (_live, _pair_hash_uniform, _sanitize, _selected,
                      _stencil_pairs, _stencil_walk)

F32 = torch.float32
I32 = torch.int32
# the swallow draw's salt (black_holes_iact.h swallow marking)
SWALLOW_SALT = 0x27d4eb2f
# "no candidate" potential of the reposition search
BIG = float(np.float32(3.4e38))


def _nearest(grid, dx):
    """(n, Ki, Kj) bool: the separation is the pair's nearest periodic
    image (every |dx_a| below half the box)."""
    ok = None
    for a in range(3):
        t = torch.abs(dx[a]) < float(np.float32(0.5 * grid.box[a]))
        ok = t if ok is None else ok & t
    return ok


def bh_gas_density_loop(grid, bh_s: Dict, gas_s: Dict, p) -> Dict:
    """Per-BH gas sums (runner_iact_nonsym_bh_gas_density) over the gas
    within gamma h_bh: rho (sum m W, without the h^-3 factor, which the
    caller applies), ngb_mass (sum m), mom{0,1,2} (sum m W v), cs_w (sum
    m W cs) and wcount (sum W).  Needs bh_s: mask/off/h; gas_s:
    mask/off/m/v/soundspeed.  Returns a dict of (C, K_bh)."""
    gamma2 = float(np.float32(p.kernel.gamma2))
    h = _sanitize(bh_s["mask"], bh_s["h"])
    # per gas: m, then v and cs (weighted by m W)
    carried = torch.cat([gas_s["v"], gas_s["soundspeed"][..., None]], -1)

    def acc(gi, gj, dx, r2):
        u2 = r2 * gi["hinv"] ** 2
        ok = gj["_valid"] & (u2 < gamma2)
        w, _ = p.kernel.deval(u2 ** 0.5)
        mw = torch.where(ok, gj["m"] * w, 0.0)
        return torch.cat([
            torch.sum(mw, -1, keepdim=True),
            torch.sum(torch.where(ok, gj["m"], 0.0), -1, keepdim=True),
            torch.bmm(mw, gj["carried"][:, 0]),
            torch.sum(torch.where(ok, w, 0.0), -1, keepdim=True)], -1)

    out = _stencil_pairs(grid, {"off": bh_s["off"], "hinv": 1.0 / h},
                         _live(bh_s), {"off": gas_s["off"], "m": gas_s["m"],
                                       "carried": carried},
                         _live(gas_s), acc, 7, packed=True)
    out = out * bh_s["mask"][..., None]
    keys = ("rho", "ngb_mass", "mom0", "mom1", "mom2", "cs_w", "wcount")
    return {k: out[..., i] for i, k in enumerate(keys)}


def bh_swallow_target_loop(grid, gas_s: Dict, bh_s: Dict, p, ti_lo: int,
                           ti_hi: int) -> torch.Tensor:
    """(C, K_gas) i32: the pid of the BH that swallows each gas particle
    this step, -1 if none.  A gas particle within gamma h_bh of a BH with
    a positive ``swallow_prob`` is hit when its pair-hash draw falls below
    the probability; of the BHs that hit, the largest pid wins
    (black_holes_iact.h:398-460).  Needs gas_s: mask/off/pid; bh_s:
    mask/off/h/pid/swallow_prob."""
    gamma2 = float(np.float32(p.kernel.gamma2))
    h = _sanitize(bh_s["mask"], bh_s["h"])

    def step(acc, gi, gj, dx, r2):
        h_j = gj["h"]
        ok = gj["_valid"] & (r2 < gamma2 * h_j * h_j)
        draw = _pair_hash_uniform(gi["pid"], gj["pid"], ti_lo, ti_hi,
                                  SWALLOW_SALT)
        hit = ok & (draw < gj["prob"])
        cand = torch.where(hit, gj["pid"], -1)
        return (torch.maximum(acc[0], torch.amax(cand, -1)),)

    # only BHs with a positive probability can swallow (the pair test)
    return _stencil_walk(
        grid, {"off": gas_s["off"], "pid": gas_s["pid"]}, _live(gas_s),
        {"off": bh_s["off"], "h": h, "pid": bh_s["pid"],
         "prob": bh_s["swallow_prob"]},
        _selected(bh_s, bh_s["swallow_prob"] > 0), step,
        ((-1, I32, ()),), packed=True)[0]


def bh_swallow_collect_loop(grid, bh_s: Dict, gas_s: Dict,
                            swallow_bid: torch.Tensor) -> Dict:
    """Per-BH sums over the gas that picked it (runner_do_gas_swallow):
    dm (swallowed mass) and dp{0,1,2} (swallowed momentum, from v_full),
    each gas particle on its nearest image.  Returns a dict of
    (C, K_bh)."""

    def acc(gi, gj, dx, r2):
        ok = gj["_valid"] & (gj["bid"] == gi["pid"]) & _nearest(grid, dx)
        mj = torch.where(ok, gj["m"], 0.0)
        return torch.cat([torch.sum(mj, -1, keepdim=True),
                          torch.bmm(mj, gj["v"][:, 0])], -1)

    out = _stencil_pairs(
        grid, {"off": bh_s["off"], "pid": bh_s["pid"]}, _live(bh_s),
        {"off": gas_s["off"], "m": gas_s["m"], "v": gas_s["v_full"],
         "bid": swallow_bid},
        _selected(gas_s, swallow_bid >= 0), acc, 4, packed=True)
    out = out * bh_s["mask"][..., None]
    return {k: out[..., i] for i, k in enumerate(("dm", "dp0", "dp1",
                                                   "dp2"))}


def bh_reposition_loop(grid, bh_s: Dict, gas_s: Dict, p, max_dist: float,
                       v2_max_fac: float = 0.0, v2_min_thresh: float = 0.0,
                       sel: Optional[torch.Tensor] = None):
    """The repositioning target: the gas neighbour at the lowest
    potential (black_holes_iact.h:290-375) within ``max_dist`` and the BH
    kernel; with ``v2_max_fac`` > 0 only a neighbour with v^2 <
    max(v2_max_fac^2 cs_gas^2, v2_min_thresh^2) relative to the BH.
    Needs bh_s: mask/off/h/v_full/cs_gas; gas_s: mask/off/v_full/pot.
    ``sel`` limits the BHs searched.  Returns (found (C, K_bh) bool,
    delta (C, K_bh, 3)): the displacement to the target, 0 where none."""
    gamma2 = float(np.float32(p.kernel.gamma2))
    md2 = float(np.float32(max_dist * max_dist))
    fac2 = float(np.float32(v2_max_fac * v2_max_fac))
    vmin2 = float(np.float32(v2_min_thresh * v2_min_thresh))
    h = _sanitize(bh_s["mask"], bh_s["h"])

    def step(acc, gi, gj, dx, r2):
        best_pot, best_d = acc
        ok = (gj["_valid"] & (r2 > 0) & (r2 < md2)
              & (r2 * gi["hinv"] ** 2 < gamma2))
        if v2_max_fac > 0.0:
            dv = [gi["v"][..., a] - gj["v"][..., a] for a in range(3)]
            v2 = dv[0] ** 2 + dv[1] ** 2 + dv[2] ** 2
            v2_max = torch.clamp_min(fac2 * gi["cs"] * gi["cs"], vmin2)
            ok = ok & (v2 < v2_max)
        pot = torch.where(ok, gj["pot"], BIG)
        idx = torch.argmin(pot, -1, keepdim=True)     # the first minimum
        blk_pot = torch.gather(pot, -1, idx)[..., 0]
        blk_d = torch.stack([torch.gather(
            torch.broadcast_to(-dx[a], pot.shape), -1, idx)[..., 0]
            for a in range(3)], -1)
        upd = blk_pot < best_pot
        return (torch.where(upd, blk_pot, best_pot),
                torch.where(upd[..., None], blk_d, best_d))

    best_pot, best_d = _stencil_walk(
        grid, {"off": bh_s["off"], "hinv": 1.0 / h, "v": bh_s["v_full"],
               "cs": bh_s["cs_gas"]}, _selected(bh_s, sel),
        {"off": gas_s["off"], "v": gas_s["v_full"], "pot": gas_s["pot"]},
        _live(gas_s), step, ((BIG, F32, ()), (0.0, F32, (3,))),
        packed=True)
    found = best_pot < BIG
    return found, torch.where(found[..., None], best_d, 0.0)


def bh_merger_mark_loop(grid, bh_s: Dict, p, max_dist: float, G: float,
                        threshold: str = "escape_velocity") -> torch.Tensor:
    """(C, K_bh) i32: the pid of the BH that swallows each BH this step,
    -1 if none (runner_iact_nonsym_bh_bh_swallow): a BH merges onto the
    heaviest (by subgrid mass, then pid) heavier neighbour within
    min(max_dist, gamma h of the heavier) that binds it:

    * ``escape_velocity``: v^2 < 2 G M_heavy / r;
    * ``circular_velocity``: v^2 < G M_heavy / (gamma h_heavy);
    * ``dynamical_escape_velocity``: v^2 < 2 G (m_i + m_j) / r;

    any other name is ``escape_velocity``.  Needs
    mask/off/pid/m/m_subgrid/h/v_full."""
    gamma = float(np.float32(p.kernel.gamma))
    md2 = float(np.float32(max_dist * max_dist))
    Gf = float(np.float32(G))
    G2 = float(np.float32(2.0) * np.float32(G))
    h = _sanitize(bh_s["mask"], bh_s["h"])
    f = {"off": bh_s["off"], "pid": bh_s["pid"], "ms": bh_s["m_subgrid"],
         "m": bh_s["m"], "h": h, "v": bh_s["v_full"]}

    def step(acc, gi, gj, dx, r2):
        best_m, best_id = acc
        ms_i, ms_j = gi["ms"], gj["ms"]
        id_i, id_j = gi["pid"], gj["pid"]
        heavier = (ms_j > ms_i) | ((ms_j == ms_i) & (id_j > id_i))
        M = torch.maximum(ms_i, ms_j)
        h_big = torch.where(ms_j > ms_i, gj["h"], gi["h"])
        r = torch.sqrt(torch.clamp_min(r2, 1e-30))
        dv = [gi["v"][..., a] - gj["v"][..., a] for a in range(3)]
        v2 = dv[0] ** 2 + dv[1] ** 2 + dv[2] ** 2
        if threshold == "circular_velocity":
            v2_thr = Gf * M / (gamma * h_big)
        elif threshold == "dynamical_escape_velocity":
            v2_thr = G2 * (gi["m"] + gj["m"]) / r
        else:
            v2_thr = G2 * M / r
        near = (r2 < md2) & (r2 < (gamma * h_big) ** 2)
        ok = gj["_valid"] & (r2 > 0) & near & heavier & (v2 < v2_thr)
        cand_m = torch.where(ok, ms_j, float("-inf"))
        pm = torch.amax(cand_m, -1)
        pid_at = torch.amax(torch.where(ok & (cand_m == pm[..., None]),
                                        id_j, -1), -1)
        upd = (pm > best_m) | ((pm == best_m) & (pid_at > best_id))
        return (torch.where(upd, pm, best_m),
                torch.where(upd, pid_at, best_id))

    return _stencil_walk(grid, f, _live(bh_s), f, _live(bh_s), step,
                         ((float("-inf"), F32, ()), (-1, I32, ())),
                         packed=True)[1]


def bh_merger_collect_loop(grid, bh_s: Dict, victim_bid: torch.Tensor,
                           not_victim: torch.Tensor) -> Dict:
    """Per-BH sums over the BHs that picked it as their swallower
    (black_holes_swallow_bpart), each on its nearest image: dm
    (dynamical mass), dms (subgrid mass), dp{0,1,2} (momentum), dresv
    (reservoir) and n.  A swallower that is itself a victim gains
    nothing: the chain defers.  Returns a dict of (C, K_bh)."""
    carried = torch.cat([bh_s["m_subgrid"][..., None],
                         bh_s["energy_reservoir"][..., None]], -1)

    def acc(gi, gj, dx, r2):
        ok = gj["_valid"] & (gj["bid"] == gi["pid"]) & _nearest(grid, dx)
        w = ok.to(F32)
        mj = torch.where(ok, gj["m"], 0.0)
        return torch.cat([torch.sum(mj, -1, keepdim=True),
                          torch.bmm(mj, gj["v"][:, 0]),
                          torch.bmm(w, gj["carried"][:, 0]),
                          torch.sum(w, -1, keepdim=True)], -1)

    out = _stencil_pairs(
        grid, {"off": bh_s["off"], "pid": bh_s["pid"]},
        _selected(bh_s, not_victim),
        {"off": bh_s["off"], "m": bh_s["m"], "v": bh_s["v_full"],
         "carried": carried, "bid": victim_bid},
        _selected(bh_s, victim_bid >= 0), acc, 7, packed=True)
    out = out * bh_s["mask"][..., None]
    return {"dm": out[..., 0], "dp0": out[..., 1], "dp1": out[..., 2],
            "dp2": out[..., 3], "dms": out[..., 4], "dresv": out[..., 5],
            "n": out[..., 6]}


def bh_merger_consumed_loop(grid, bh_s: Dict, victim_bid: torch.Tensor,
                            not_victim: torch.Tensor) -> torch.Tensor:
    """(C, K_bh) bool: the victim's swallower is not itself a victim, so
    the merger completes this step (chain deferral)."""

    def step(acc, gi, gj, dx, r2):
        hit = gj["_valid"] & (gi["vic"] == gj["pid"])
        return (acc[0] | torch.any(hit, -1),)

    return _stencil_walk(
        grid, {"off": bh_s["off"], "vic": victim_bid},
        _selected(bh_s, victim_bid >= 0),
        {"off": bh_s["off"], "pid": bh_s["pid"]},
        _selected(bh_s, not_victim), step, ((False, torch.bool, ()),),
        packed=True)[0]

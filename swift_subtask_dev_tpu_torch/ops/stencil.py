"""The 27-cell neighbour stencil: its constants, the limiter's scan, the
star loops and chemistry smoothing.

Port of the reference's ``ops/stencil.py`` (the XLA roll-stencil): its
constants, the view and roll helpers, ``timebin_loop`` (the wake scan of
the timestep limiter on the 27-cell grid: the ``pallas`` and
``pallas_ring`` backends), the cross-species loops of the EAGLE feedback
pipeline (``star_ngb_mass_loop``, ``feedback_apply_loop`` with its
pair-hash draws, ``star_kernel_weight_loop``, ``enrichment_apply_loop``)
and ``chemistry_smooth_loop``.  On the column grid (``ncz = 1``) the
stencil's dz = -1, 0, 1 cells are one column's periodic z-images, so the
pair sets stay exact for particles drifted above or below the box.

The reference evaluates every (slot, slot) pair of the 27 cells and masks
the result.  Here each loop gathers the slots that can be accepted (live
ones; on the j side also only those whose own flag the pair test needs,
such as a star with energy to inject) to the front of each cell first,
and walks the 27 offsets one at a time over chunks of cells
(``_stencil_walk``: a sum, ``_stencil_pairs``, or a fold such as the
black holes' selections; ``packed`` walks the offsets as one j axis), so
that a (cells, i, j) tile of live slots is all that is ever built:
exact, because a pair outside these sets is masked out in the
reference.  The separation is the reference's:
``off_i - (off_j + f32(d * edge))``.  The stencil's density, gradient and
force loops (the ``xla`` backend) are not ported; on the flat backend
chemistry smoothing runs on the flat pair kernel
(``hydro_flat.chemistry_smooth_loop``), and ``chemistry_smooth_loop``
here is its plain version.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..subgrid.chemistry import N_ELEMENTS
from ..utils import prng

# "no neighbour" sentinel of the time-bin min reductions (> any real bin,
# small enough that sentinel + 2 cannot overflow i32)
NBIN_SENTINEL = 64

# The 27 stencil offsets, self first: the order the packed pair kernel
# walks the neighbour cells.
STENCIL_27 = [(0, 0, 0)] + [
    (dx, dy, dz)
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if not (dx == 0 and dy == 0 and dz == 0)
]

F32 = torch.float32


def _grid_view(grid, arr: torch.Tensor) -> torch.Tensor:
    """(C, K, ...) -> (ncx, ncy, ncz, K, ...)."""
    return arr.reshape(tuple(grid.cdim) + tuple(arr.shape[1:]))


def _flat_view(grid, arr: torch.Tensor) -> torch.Tensor:
    return arr.reshape((grid.C,) + tuple(arr.shape[3:]))


def _roll(arr: torch.Tensor, d) -> torch.Tensor:
    """rolled[c] = arr[c + d] (periodic)."""
    if tuple(d) == (0, 0, 0):
        return arr
    return torch.roll(arr, shifts=(-d[0], -d[1], -d[2]), dims=(0, 1, 2))


def _sanitize(mask, x, fill=1.0):
    """Empty-slot values replaced so masked pairs stay finite."""
    return torch.where(mask > 0, x, fill)


def timebin_loop(grid, s: Dict[str, torch.Tensor], p) -> torch.Tensor:
    """(C, K) i32 min time bin over *active* neighbours whose kernel
    reaches the slot (the limiter's wake scan, runner_iact_nonsym_limiter,
    timestep_limiter_iact.h:106, inverted j-centric): ``NBIN_SENTINEL``
    where there is none.

    ``s`` holds mask, off, h, time_bin (post-timestep) and active (0/1
    f32).  The reference's unrolled form: for each of the 27 stencil
    cells the periodic shift is folded into the j offsets before the
    subtraction, ``dx = off_i - (off_j + f32(d * edge))``, and
    ``mask_j > 0 & active_j > 0 & r2 > 0 & r2 < gamma^2 h_j^2 & tb_j > 0``
    accepts a pair.  Only live active slots can be accepted, so each
    cell's are gathered first and the others are never paired (exact: a
    min over the pairs the mask accepts); the offsets are walked one at a
    time, so one (C, K, Kj) tile is live at once."""
    g = lambda name: _grid_view(grid, s[name])        # noqa: E731
    mask, off = g("mask"), g("off")
    h = _sanitize(mask, g("h"))
    tb = g("time_bin").to(F32)
    cand = (mask > 0) & (g("active") > 0)
    gamma2 = float(np.float32(p.kernel.gamma2))
    big_bin = 1e9
    acc = torch.full(mask.shape, big_bin, dtype=F32, device=mask.device)
    Kj = int(cand.sum(-1).max()) if cand.numel() else 0
    if Kj:
        order = torch.argsort((~cand).to(torch.int8), dim=-1,
                              stable=True)[..., :Kj]

        def take(x):
            return torch.gather(x, -1, order)

        j_fields = {"cand": take(cand), "h": take(h), "tb": take(tb),
                    **{f"off{a}": take(off[..., a]) for a in range(3)}}
        edge = grid.edge
        for d in STENCIL_27:
            jf = {k: _roll(v, d)[..., None, :] for k, v in j_fields.items()}
            dx = [off[..., a, None]
                  - (jf[f"off{a}"] + float(np.float32(d[a] * edge[a])))
                  for a in range(3)]
            r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
            h_j, tb_j = jf["h"], jf["tb"]
            ok = (jf["cand"] & (r2 > 0) & (r2 < gamma2 * h_j * h_j)
                  & (tb_j > 0))
            acc = torch.minimum(acc, torch.amin(
                torch.where(ok, tb_j, big_bin), dim=-1))
    return _flat_view(grid, torch.clamp_max(acc, float(NBIN_SENTINEL))
                      ).to(torch.int32)


# ---------------------------------------------------------------------------
# Live-slot pair walk over the 27 stencil cells (cross-species or not)
# ---------------------------------------------------------------------------

# pair evaluations per chunk of cells (bounds the memory of a tile)
_PAIRS_PER_CHUNK = {"cpu": 1 << 21, "cuda": 1 << 24}


def _front(sel: torch.Tensor):
    """(order (C, Kc) int64, valid (C, Kc) bool): each cell's selected
    slots first, in slot order, Kc the fullest cell's count."""
    kc = int(sel.sum(1).max()) if sel.numel() else 0
    order = torch.argsort((~sel).to(torch.int8), dim=1, stable=True)[:, :kc]
    return order, torch.gather(sel, 1, order)


def _take(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        return torch.gather(x, 1, order)
    idx = order.reshape(order.shape + (1,) * (x.dim() - 2)).expand(
        order.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _stencil_table(grid, device):
    """(C, 27) int64 neighbour cell of every cell per STENCIL_27 offset,
    and (27, 3) the offsets' f32 shifts d * edge."""
    ncx, ncy, ncz = grid.cdim
    ids = np.arange(ncx * ncy * ncz)
    ix, iy, iz = ids // (ncy * ncz), (ids // ncz) % ncy, ids % ncz
    nbr = np.empty((len(ids), 27), np.int64)
    for o, (dx, dy, dz) in enumerate(STENCIL_27):
        nbr[:, o] = (((ix + dx) % ncx) * ncy + (iy + dy) % ncy) * ncz \
            + (iz + dz) % ncz
    edge = grid.edge
    shift = np.asarray([[np.float32(d[a] * edge[a]) for a in range(3)]
                        for d in STENCIL_27], np.float32)
    return (torch.as_tensor(nbr, device=device),
            torch.as_tensor(shift, device=device))


def _stencil_walk(grid, fi: Dict[str, torch.Tensor], sel_i: torch.Tensor,
                  fj: Dict[str, torch.Tensor], sel_j: torch.Tensor,
                  step: Callable, init, packed: bool = False) -> tuple:
    """Fold ``step`` over the 27 stencil offsets, in ``STENCIL_27`` order,
    for every i among ``sel_i`` against the j among ``sel_j`` ((C, K_i),
    (C, K_j) bool).  ``fi``/``fj`` hold (C, K, ...) fields, "off"
    (C, K, 3) among them.  ``init`` names the accumulators: a tuple of
    (fill, dtype, tail shape).  ``step(acc, gi, gj, dx, r2)`` gets the
    accumulators ((n, Ki, *tail) each), the i fields (n, Ki, 1 [, ...]),
    the j fields (n, 1, Kj [, ...]; "_valid" marks the selected j), the
    separation (three (n, Ki, Kj) tensors, off_i - (off_j + shift)) and
    r2, and returns the new accumulators.  Within an offset the j are in
    slot order.  ``packed`` walks the 27 offsets as one j axis, offset
    after offset (the reference's packed stencil: 27 times fewer, larger
    tensor operations, for loops with few i); a fold's ties then still go
    to the earlier offset and slot, and sums are in another order.
    Returns the accumulators, (C, K_i, *tail) each: the folds of the
    selected i slots, ``fill`` elsewhere."""
    dev = sel_i.device
    C, K_i = sel_i.shape

    def full(shape, spec):
        fill, dtype, tail = spec
        return torch.full(shape + tuple(tail), fill, dtype=dtype,
                          device=dev)

    outs = tuple(full((C, K_i), spec) for spec in init)
    oi, vi = _front(sel_i)
    oj, vj = _front(sel_j)
    Ki, Kj = oi.shape[1], oj.shape[1]
    if Ki == 0 or Kj == 0:
        return outs
    gi_all = {k: _take(v, oi) for k, v in fi.items()}
    gj_all = {k: _take(v, oj) for k, v in fj.items()}
    gj_all["_valid"] = vj
    nbr, shift = _stencil_table(grid, dev)
    groups = [list(range(27))] if packed else [[o] for o in range(27)]
    G = len(groups[0])
    nc = max(1, _PAIRS_PER_CHUNK.get(dev.type, 1 << 21) // (Ki * Kj * G))
    acc_all = tuple(full((C, Ki), spec) for spec in init)
    for c0 in range(0, C, nc):
        cells = slice(c0, min(c0 + nc, C))
        gi = {k: v[cells][:, :, None] for k, v in gi_all.items()}
        n = gi["off"].shape[0]
        acc = tuple(full((n, Ki), spec) for spec in init)
        for group in groups:
            cj = nbr[cells][:, group]                       # (n, G)
            gj = {k: v[cj].reshape((n, 1, G * Kj) + tuple(v.shape[2:]))
                  for k, v in gj_all.items()}
            off_j = (gj_all["off"][cj] + shift[group][None, :, None, :]
                     ).reshape(n, 1, G * Kj, 3)
            dx = [gi["off"][..., a] - off_j[..., a] for a in range(3)]
            r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
            acc = step(acc, gi, gj, dx, r2)
        for a_all, a in zip(acc_all, acc):
            a_all[cells] = a
    result = []
    for out, a_all, (fill, _, tail) in zip(outs, acc_all, init):
        sel = vi.reshape(vi.shape + (1,) * len(tail))
        idx = oi.reshape(oi.shape + (1,) * len(tail)).expand(a_all.shape)
        result.append(out.scatter(1, idx, torch.where(sel, a_all, fill)))
    return tuple(result)


def _stencil_pairs(grid, fi: Dict[str, torch.Tensor], sel_i: torch.Tensor,
                   fj: Dict[str, torch.Tensor], sel_j: torch.Tensor,
                   accumulate: Callable, n_out: int,
                   packed: bool = False) -> torch.Tensor:
    """Sum ``accumulate`` over every (i, j) pair of the 27-cell stencil
    (``_stencil_walk`` with one sum): ``accumulate(gi, gj, dx, r2)``
    returns an (n, Ki, n_out) f32 sum over its j.  Returns (C, K_i,
    n_out): the sums of the selected i slots, 0 elsewhere."""

    def step(acc, gi, gj, dx, r2):
        return (acc[0] + accumulate(gi, gj, dx, r2),)

    return _stencil_walk(grid, fi, sel_i, fj, sel_j, step,
                         ((0.0, F32, (n_out,)),), packed)[0]


def _masked_sum(ok, val):
    """(n, Ki, 1) sum over j of val where ok."""
    return torch.sum(torch.where(ok, val, 0.0), dim=-1, keepdim=True)


def _live(s):
    return s["mask"] > 0


def _selected(s, sel):
    return _live(s) if sel is None else _live(s) & sel


def star_ngb_mass_loop(grid, star_s: Dict, gas_s: Dict, p,
                       sel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """For every star: the summed mass of its gas neighbours within
    gamma h_star (the feedback normalisation of stars_density, EAGLE).
    Needs star_s: mask/off/h; gas_s: mask/off/m.  Returns (C, K_s);
    ``sel`` limits the stars summed (the others read 0)."""
    gamma2 = float(np.float32(p.kernel.gamma2))
    h = _sanitize(star_s["mask"], star_s["h"])

    def acc(gi, gj, dx, r2):
        ok = gj["_valid"] & (r2 * gi["hinv"] ** 2 < gamma2)
        return _masked_sum(ok, gj["m"])

    out = _stencil_pairs(grid, {"off": star_s["off"], "hinv": 1.0 / h},
                         _selected(star_s, sel), {"off": gas_s["off"],
                                                  "m": gas_s["m"]},
                         _live(gas_s), acc, 1)
    return out[..., 0] * star_s["mask"]


def _pair_hash_uniform(id_i, id_j, ti_lo: int, ti_hi: int, salt: int):
    """Deterministic per-(gas, star, step) uniform draw, the analog of
    random_unit_interval_two_IDs (random.h:211): both ids, the step's tick
    and a purpose salt mixed in uint32 arithmetic, a murmur3 fmix32
    finaliser, and the word's f32 value over 2^32 (as the reference's
    ``astype(f32)``).  The words are int64 masked to 32 bits."""
    M = prng.M32
    x = (prng.mul32(prng.as_u32(id_i), 0x9E3779B9)
         ^ prng.mul32(prng.as_u32(id_j), 0x85EBCA6B))
    x = x ^ ((int(ti_lo) & M) * 0xC2B2AE35 & M)
    x = x ^ ((int(ti_hi) + int(salt)) & M)
    x = x ^ (x >> 16)
    x = prng.mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = prng.mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x.to(F32) * float(np.float32(1.0 / 4294967296.0))


# the stochastic heating draw's salt (feedback_apply_loop)
FEEDBACK_SALT = 0x5bd1e995


def feedback_apply_loop(grid, gas_s: Dict, star_s: Dict, p, ti_lo: int,
                        ti_hi: int, du_heat: float):
    """EAGLE stochastic thermal feedback (feedback_iact.h
    runner_iact_nonsym_feedback_apply; Dalla Vecchia & Schaye 2012 eq.
    7): every gas particle within gamma h_star of a star with energy to
    inject is heated by du_heat with probability E / (du_heat ngb_mass),
    against the pair-hash draw.  star_s needs mask/off/h/pid/fb_energy/
    fb_ngb_mass.  Returns (du_add (C, K_gas), heating events (C, K_gas)
    i32)."""
    gamma2 = float(np.float32(p.kernel.gamma2))
    prob = star_s["fb_energy"] / torch.clamp_min(
        star_s["fb_ngb_mass"] * float(np.float32(du_heat)), 1e-30)
    h = _sanitize(star_s["mask"], star_s["h"])

    def acc(gi, gj, dx, r2):
        h_j = gj["h"]
        ok = gj["_valid"] & (r2 < gamma2 * h_j * h_j)
        draw = _pair_hash_uniform(gi["pid"], gj["pid"], ti_lo, ti_hi,
                                  FEEDBACK_SALT)
        heat = ok & (draw < gj["prob"])
        return torch.sum(heat.to(F32), dim=-1, keepdim=True)

    # only stars with a positive probability can heat (the pair test)
    nev = _stencil_pairs(
        grid, {"off": gas_s["off"], "pid": gas_s["pid"]}, _live(gas_s),
        {"off": star_s["off"], "h": h, "pid": star_s["pid"], "prob": prob},
        _live(star_s) & (prob > 0), acc, 1)[..., 0]
    return (nev * float(np.float32(du_heat)) * gas_s["mask"],
            nev.to(torch.int32))


def star_kernel_weight_loop(grid, star_s: Dict, gas_s: Dict, p,
                            sel: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Per star: sum of m_j W(r_ij, h_star) over its gas neighbours (the
    enrichment normalisation; without the h^-3 factor, which the shares'
    ratio cancels).  Returns (C, K_s); ``sel`` limits the stars summed
    (the others read 0)."""
    gamma2 = float(np.float32(p.kernel.gamma2))
    h = _sanitize(star_s["mask"], star_s["h"])

    def acc(gi, gj, dx, r2):
        u2 = r2 * gi["hinv"] ** 2
        ok = gj["_valid"] & (u2 < gamma2)
        w, _ = p.kernel.deval(torch.sqrt(u2))
        return _masked_sum(ok, gj["m"] * w)

    out = _stencil_pairs(grid, {"off": star_s["off"], "hinv": 1.0 / h},
                         _selected(star_s, sel), {"off": gas_s["off"],
                                                  "m": gas_s["m"]},
                         _live(gas_s), acc, 1)
    return out[..., 0] * star_s["mask"]


def enrichment_apply_loop(grid, gas_s: Dict, star_s: Dict, p):
    """Stellar ejecta shared kernel-weighted over gas neighbours
    (feedback_iact.h mass and metal transfer): gas i receives share = m_i
    W(r, h_s) / norm_s of each neighbour star's ejecta.  star_s needs
    mask/off/h/v_full, ej_m, ej_mZ, ej_elem (..., 9) and ej_norm (<= 0
    suppresses the star).  Returns {"dm", "dmZ", "delem" (C, K, 9),
    "dp" (C, K, 3)} per gas slot."""
    gamma2 = float(np.float32(p.kernel.gamma2))
    ninv = torch.where(star_s["ej_norm"] > 0,
                       1.0 / torch.clamp_min(star_s["ej_norm"], 1e-30), 0.0)
    h = _sanitize(star_s["mask"], star_s["h"])
    # per star: ej_m, ej_mZ, the element masses, then ej_m * v
    carried = torch.cat([star_s["ej_m"][..., None],
                         star_s["ej_mZ"][..., None], star_s["ej_elem"]], -1)

    def acc(gi, gj, dx, r2):
        hinv_j = 1.0 / gj["h"]
        u2 = r2 * hinv_j * hinv_j
        ok = gj["_valid"] & (u2 < gamma2)
        w, _ = p.kernel.deval(torch.sqrt(u2))
        share = torch.where(ok, gi["m"] * w * gj["ninv"], 0.0)
        ej = gj["carried"][:, 0]                       # (n, Kj, 11)
        dm_r = share * gj["carried"][..., 0]
        return torch.cat([torch.bmm(share, ej),
                          torch.bmm(dm_r, gj["v"][:, 0])], -1)

    # only stars with ejecta can give (the pair test)
    n_out = 2 + N_ELEMENTS + 3
    out = _stencil_pairs(
        grid, {"off": gas_s["off"], "m": gas_s["m"]}, _live(gas_s),
        {"off": star_s["off"], "h": h, "ninv": ninv, "carried": carried,
         "v": star_s["v_full"]},
        _live(star_s) & (star_s["ej_m"] > 0), acc, n_out)
    out = out * gas_s["mask"][..., None]
    return {"dm": out[..., 0], "dmZ": out[..., 1],
            "delem": out[..., 2:2 + N_ELEMENTS],
            "dp": out[..., 2 + N_ELEMENTS:]}


def chemistry_smooth_loop(grid, s: Dict, p):
    """Kernel-smoothed metal mass fractions over gas neighbours
    (chemistry/EAGLE/chemistry_iact.h + chemistry_end_density): for the
    total Z and each element k,

        Z_sm_i = (sum_j m_j Z_j W(r_ij, h_i) + m_i Z_i W(0)) h_i^-3 / rho_i

    over the pairs with r2 > 0 and r < gamma h_i.  Needs
    mask/off/m/h/rho/Z/elem_frac.  Returns (Z_smooth (C, K),
    elem_frac_smooth (C, K, 9)).  The plain version of the flat pair
    kernel's chemistry body (``hydro_flat.chemistry_smooth_loop``)."""
    gamma2 = float(np.float32(p.kernel.gamma2))
    h = _sanitize(s["mask"], s["h"])
    vals = torch.cat([s["Z"][..., None], s["elem_frac"]], -1)   # (C, K, 10)

    def acc(gi, gj, dx, r2):
        u2 = r2 * gi["hinv"] * gi["hinv"]
        ok = gj["_valid"] & (r2 > 0) & (u2 < gamma2)
        w, _ = p.kernel.deval(torch.sqrt(u2))
        mw = torch.where(ok, gj["m"] * w, 0.0)
        return torch.bmm(mw, gj["vals"][:, 0])

    sums = _stencil_pairs(grid, {"off": s["off"], "hinv": 1.0 / h},
                          _live(s), {"off": s["off"], "m": s["m"],
                                     "vals": vals},
                          _live(s), acc, 1 + N_ELEMENTS)
    return chemistry_smooth_finish(s, p, sums[..., 0], sums[..., 1:])


def chemistry_smooth_finish(s: Dict, p, mZ: torch.Tensor,
                            me: torch.Tensor):
    """The self term and the h^-3 / rho factor of chemistry smoothing
    (chemistry_end_density), on the neighbour sums mZ (C, K) and me
    (C, K, 9)."""
    kroot = float(np.float32(p.kernel.root))
    h_flat = torch.where(s["mask"] > 0, s["h"], 1.0)
    h_inv = 1.0 / h_flat
    h_inv_dim = h_inv * (h_inv * h_inv)
    fac = h_inv_dim / torch.clamp_min(s["rho"], 1e-30) * s["mask"]
    Z_sm = (mZ + s["m"] * s["Z"] * kroot) * fac
    ef_sm = (me + s["m"][..., None] * s["elem_frac"] * kroot) * fac[..., None]
    return Z_sm, ef_sm

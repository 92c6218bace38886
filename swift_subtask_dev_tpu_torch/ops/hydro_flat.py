"""SPH hydro, P2P gravity and limiter loops on the pair engines.

Port of the reference's ``ops/hydro_pallas.py``: density, gradient and
force on any of the three pair engines (``engine="flat"``: the
column/z-sorted ``pair_flat``; ``engine="packed"``: the 27-cell
``pair_packed``; ``engine="ring"``: the 27-cell ``pair_ring``, as the
reference's ``ENGINES`` table), and fused force + short-range gravity, P2P
gravity and the limiter's timebin scan on the flat engine.  Each loop
builds a :class:`~.pair_flat.PairPass` — the (C, K) field tiles in the
body's field order, the body's constants and its plain torch callback
(and, for P2P gravity between two species, the j species' tiles) —
and runs it through the engine's ``pair_apply`` (the CUDA kernel on the
card, the plain version on the CPU).  ``active_i`` evaluates only the
active particles: the flat engine skips i-tiles with no active particle,
the 27-cell engines every slot that is not active (the reference's
27-cell engines recompute every slot); the callers merge the results into
active particles only.

The SPH loops take any ported scheme (``p.mod``, ``models/sph``
``SCHEME_MODULES``) under any of the six smoothing kernels, as the
reference's loops trace ``p.mod``'s term functions into the kernel: the
density body reads u_j when ``DENSITY_NEEDS_U`` and adds the scheme's
``DENSITY_EXTRA_KEYS`` sums; the gradient body reads the scheme's
``GRADIENT_J_EXTRA`` fields (padded with 0) and sums its
``GRADIENT_SUM_KEYS``; every scheme's force shares one field list.  On
the flat engine each (scheme, kernel) pair is a mode of K1
(``PairBody.mode``, its own CUDA library); the 27-cell engines run
SPHENIX with the cubic spline only and refuse anything else.

Conventions kept from the reference: padded slots hold division-safe
fills (``_san``: h, m, rho, P = 1); the gravity mass is ``m * mask``; the
minimum neighbour bin is reduced as the max of the negated bin, with
``NBIN_SENTINEL`` for empty bins; max outputs are -inf where a slot
accepted no pair.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..grid.cellgrid import CellGrid
from ..models.sph import scheme_name, sphenix  # noqa: F401
from ..models.sph.kernels import CUBIC_SPLINE, kernel_name
from ..models.sph.sphenix import CosmoFactors, SPHENIXParams
from ..subgrid.chemistry import N_ELEMENTS
from . import p2p_gravity as pg
from . import pair_flat, pair_packed, pair_ring
from .pair_flat import PairBody, PairPass
from .stencil import NBIN_SENTINEL, chemistry_smooth_finish

F32 = torch.float32

_COMMON = ("mask", "off0", "off1", "off2")
DENSITY_FIELDS = _COMMON + ("v0", "v1", "v2", "h", "hinv", "m")
GRADIENT_FIELDS = _COMMON + ("v0", "v1", "v2", "h", "hinv", "m", "u",
                             "rhoinv", "cs", "av")
FORCE_FIELDS = _COMMON + ("v0", "v1", "v2", "h", "m", "u", "rho", "P", "cs",
                          "fgh", "bal", "al", "ad", "tb", "hinv", "minv",
                          "rhoinv", "pr2")
FORCE_GRAVITY_FIELDS = FORCE_FIELDS + ("gm",)
P2P_FIELDS = _COMMON + ("h", "m")
TIMEBIN_FIELDS = _COMMON + ("h", "tb", "act")
CHEM_FIELDS = _COMMON + ("h", "hinv", "m", "Z") + tuple(
    f"e{k}" for k in range(N_ELEMENTS))

ENGINES = ("flat", "packed", "ring")


def _apply(engine: str, grid: CellGrid, pp: PairPass, active_i=None):
    """Run a pass on the named engine, on the ``active_i`` subset."""
    if engine == "flat":
        return pair_flat.pair_apply(grid, pp, active_i)
    if pp.body.mode:
        raise NotImplementedError(
            f"the {engine} pair engine runs SPHENIX with the cubic spline "
            f"only: its {pp.body.name} body in the mode {pp.body.mode!r} "
            f"(SPH scheme/kernel) is not ported yet")
    if engine == "packed":
        return pair_packed.pair_apply(grid, pp, active_i)
    if engine == "ring":
        return pair_ring.pair_apply(grid, pp, active_i)
    raise ValueError(f"unknown pair engine {engine!r} (have {ENGINES})")


def _vec(fields: Dict, s: Dict, name: str):
    for k in range(3):
        fields[f"{name}{k}"] = s[name][..., k]


def _common_fields(s: Dict) -> Dict[str, torch.Tensor]:
    f = {"mask": s["mask"]}
    _vec(f, s, "off")
    return f


def _san(s, key, fill=1.0):
    return torch.where(s["mask"] > 0, s[key], fill)


def sph_mode(p) -> str:
    """K1's mode for the SPH bodies of ``p`` (``PairBody.mode``):
    ``"<SPH:scheme>/<SPH:kernel>"``, or "" for SPHENIX with the cubic
    spline (the default library)."""
    scheme, kernel = scheme_name(p), kernel_name(p.kernel)
    if (scheme, kernel) == ("sphenix", "cubic-spline"):
        return ""
    return f"{scheme}/{kernel}"


def _kernel_params(p):
    """(gamma2, gamma_inv, g3, g4): the kernel's constants the CUDA bodies
    take (the kernel's polynomial is compiled into its mode)."""
    k = p.kernel
    return (float(k.gamma2), k.gamma_inv, k.g3, k.g4)


def _cosmo_params(cosmo: CosmoFactors):
    """(a^2 H, fac_mu) as the pair terms fold them."""
    return (cosmo.a * cosmo.a * cosmo.H, cosmo.fac_mu)


def _grav_params(G, H_soft, r_s, r_cut):
    """(r_cut2, H_inv, H3_inv, r_s_inv, G).  The P2P pairs always carry
    the erfc truncation that matches the PM mesh, so r_s must be > 0."""
    if not r_s > 0:
        raise ValueError(f"P2P gravity needs the mesh split scale r_s > 0 "
                         f"(got {r_s})")
    H_inv = 1.0 / float(H_soft)
    return (float(r_cut) ** 2, H_inv, H_inv * H_inv * H_inv,
            1.0 / float(r_s), float(G))


def _force_fields(s: Dict) -> Dict[str, torch.Tensor]:
    fields = _common_fields(s)
    _vec(fields, s, "v")
    fields["h"] = _san(s, "h")
    fields["m"] = _san(s, "m")
    fields["u"] = _san(s, "u", 0.0)
    fields["rho"] = torch.clamp_min(_san(s, "rho"), 1e-30)
    fields["P"] = _san(s, "pressure")
    fields["cs"] = _san(s, "soundspeed", 0.0)
    fields["fgh"] = _san(s, "f_gradh", 0.0)
    fields["bal"] = _san(s, "balsara", 0.0)
    fields["al"] = _san(s, "alpha_visc", 0.0)
    fields["ad"] = _san(s, "alpha_diff", 0.0)
    fields["tb"] = s["time_bin"].to(F32)
    fields["hinv"] = 1.0 / fields["h"]
    fields["minv"] = 1.0 / fields["m"]
    fields["rhoinv"] = 1.0 / fields["rho"]
    fields["pr2"] = fields["P"] * fields["rhoinv"] * fields["rhoinv"]
    return fields


def _force_terms(p, cosmo, sf, nf, dx, r2):
    dv = tuple(sf(f"v{k}") - nf(f"v{k}") for k in range(3))
    return p.mod.force_terms(
        p, dx, r2, sf("hinv"), nf("hinv"), sf("m"), nf("m"),
        sf("minv"), nf("minv"), dv,
        sf("rho"), nf("rho"), sf("rhoinv"), nf("rhoinv"),
        sf("pr2"), nf("pr2"),
        sf("P"), nf("P"), sf("cs"), nf("cs"),
        sf("fgh"), nf("fgh"), sf("bal"), nf("bal"),
        sf("al"), nf("al"), sf("ad"), nf("ad"), sf("u"), nf("u"), cosmo)


def _hydro_ok(gamma2, sf, nf, r2):
    hm = torch.maximum(sf("h"), nf("h"))
    return r2 < gamma2 * (hm * hm)


# ---------------------------------------------------------------------------
# Passes: field tiles + body for each loop
# ---------------------------------------------------------------------------

def density_pass(s: Dict, p: SPHENIXParams) -> PairPass:
    """The density body; a scheme whose density reads u_j
    (``DENSITY_NEEDS_U``) adds u to the fields and its
    ``DENSITY_EXTRA_KEYS`` sums after the eight."""
    fields = _common_fields(s)
    _vec(fields, s, "v")
    fields["h"] = _san(s, "h")
    fields["hinv"] = 1.0 / fields["h"]
    fields["m"] = s["m"]
    extra_keys = p.mod.DENSITY_EXTRA_KEYS
    needs_u = p.mod.DENSITY_NEEDS_U
    if needs_u:
        fields["u"] = _san(s, "u", 0.0)
    gamma2 = float(p.kernel.gamma2)

    def fn(sf, nf, dx, r2):
        h_i = sf("h")
        ok = r2 < gamma2 * h_i * h_i
        dv = tuple(sf(f"v{k}") - nf(f"v{k}") for k in range(3))
        uj = (nf("u"),) if needs_u else ()
        t = p.mod.density_terms(p, dx, r2, sf("hinv"), nf("m"), dv, *uj)
        return ok, [t["rho"], t["rho_dh"], t["wcount"], t["wcount_dh"],
                    t["div_v"], t["rot_v0"], t["rot_v1"], t["rot_v2"]] + [
                        t[k] for k in extra_keys], []

    body = PairBody("density",
                    DENSITY_FIELDS + (("u",) if needs_u else ()),
                    8 + len(extra_keys), 0,
                    _kernel_params(p) + p.mod.density_params(p), fn,
                    sph_mode(p))
    return PairPass(body, fields, range_scale=float(p.kernel.gamma))


def gradient_pass(s: Dict, p: SPHENIXParams,
                  cosmo: CosmoFactors) -> PairPass:
    """The gradient body: the scheme's ``GRADIENT_SUM_KEYS`` sums and the
    v_sig and neighbour-alpha maxes; its ``GRADIENT_J_EXTRA`` state
    fields follow the common ones (0 in empty slots), each passed to the
    terms from both sides, as the reference's loop does."""
    if not p.mod.HAS_GRADIENT_LOOP:
        raise ValueError(f"the SPH scheme {scheme_name(p)!r} has no "
                         f"gradient loop")
    fields = _common_fields(s)
    _vec(fields, s, "v")
    fields["h"] = _san(s, "h")
    fields["hinv"] = 1.0 / fields["h"]
    fields["m"] = s["m"]
    fields["u"] = s["u"]
    fields["rhoinv"] = 1.0 / torch.clamp_min(_san(s, "rho"), 1e-30)
    fields["cs"] = _san(s, "soundspeed", 0.0)
    fields["av"] = _san(s, "alpha_visc", 0.0)
    sum_keys = p.mod.GRADIENT_SUM_KEYS
    j_extra = p.mod.GRADIENT_J_EXTRA
    for k in j_extra:
        fields[k] = _san(s, k, 0.0)
    gamma2 = float(p.kernel.gamma2)

    def fn(sf, nf, dx, r2):
        h_i = sf("h")
        ok = r2 < gamma2 * h_i * h_i
        dv = tuple(sf(f"v{k}") - nf(f"v{k}") for k in range(3))
        extra = []
        for k in j_extra:
            extra += [sf(k), nf(k)]
        t = p.mod.gradient_terms(
            p, dx, r2, sf("hinv"), nf("m"), dv, sf("u"), nf("u"),
            nf("rhoinv"), sf("cs"), nf("cs"), nf("av"), *extra, cosmo)
        return ok, [t["sum"][k] for k in sum_keys], \
            [t["max"]["v_sig"], t["max"]["alpha_visc_max_ngb"]]

    body = PairBody("gradient", GRADIENT_FIELDS + tuple(j_extra),
                    len(sum_keys), 2,
                    _kernel_params(p) + _cosmo_params(cosmo), fn,
                    sph_mode(p))
    return PairPass(body, fields, range_scale=float(p.kernel.gamma))


def force_pass(s: Dict, p: SPHENIXParams, cosmo: CosmoFactors) -> PairPass:
    fields = _force_fields(s)
    gamma2 = float(p.kernel.gamma2)
    big_bin = float(NBIN_SENTINEL)

    def fn(sf, nf, dx, r2):
        ok = _hydro_ok(gamma2, sf, nf, r2)
        t = _force_terms(p, cosmo, sf, nf, dx, r2)
        sums = [t["sum"]["a_hydro0"], t["sum"]["a_hydro1"],
                t["sum"]["a_hydro2"], t["sum"]["u_dt"], t["sum"]["h_dt"]]
        # min neighbour bin as a max of the negated bin; empty bins
        # excluded (timestep_limiter_iact.h:40)
        neg_tb = torch.where(nf("tb") > 0, -nf("tb"), -big_bin)
        return ok, sums, [t["max"]["v_sig"], neg_tb]

    body = PairBody("force", FORCE_FIELDS, 5, 2,
                    _kernel_params(p) + _cosmo_params(cosmo)
                    + p.mod.force_params(p), fn, sph_mode(p))
    return PairPass(body, fields, range_scale=float(p.kernel.gamma),
                    sym_range=True)


def force_gravity_pass(s: Dict, p: SPHENIXParams, cosmo: CosmoFactors,
                       G: float, H_soft: float, r_s: float,
                       r_cut: float) -> PairPass:
    """Fused hydro force + short-range P2P gravity: hydro sums are masked
    by r2 < gamma^2 max(h_i,h_j)^2, gravity sums by r2 < r_cut^2, and the
    pair mask is their union; the window covers max(gamma h, r_cut)."""
    fields = _force_fields(s)
    # gravity mass: zero in empty slots (the hydro "m" is pad-filled to 1)
    fields["gm"] = s["m"] * s["mask"]
    gamma2 = float(p.kernel.gamma2)
    big_bin = float(NBIN_SENTINEL)
    gparams = _grav_params(G, H_soft, r_s, r_cut)
    r_cut2, H_inv, _, r_s_inv, Gf = gparams

    def fn(sf, nf, dx, r2):
        ok_h = _hydro_ok(gamma2, sf, nf, r2)
        t = _force_terms(p, cosmo, sf, nf, dx, r2)
        wh = ok_h.to(F32)
        ok_g = r2 < r_cut2
        F, P = pg.force_pot_factors(r2, H_inv, r_s_inv, True)
        gm = (Gf * ok_g.to(F32)) * nf("gm")
        gmF = gm * F
        sums = [t["sum"]["a_hydro0"] * wh, t["sum"]["a_hydro1"] * wh,
                t["sum"]["a_hydro2"] * wh, t["sum"]["u_dt"] * wh,
                t["sum"]["h_dt"] * wh,
                -gmF * dx[0], -gmF * dx[1], -gmF * dx[2], -gm * P]
        neg_tb = torch.where(ok_h & (nf("tb") > 0), -nf("tb"), -big_bin)
        v_sig = torch.where(ok_h, t["max"]["v_sig"], float("-inf"))
        return ok_h | ok_g, sums, [v_sig, neg_tb]

    body = PairBody("force_gravity", FORCE_GRAVITY_FIELDS, 9, 2,
                    _kernel_params(p) + _cosmo_params(cosmo) + gparams
                    + p.mod.force_params(p), fn, sph_mode(p))
    return PairPass(body, fields, range_scale=float(p.kernel.gamma),
                    sym_range=True, reach_floor=float(r_cut))


def _grav_fields(s: Dict, r_cut: float) -> Dict[str, torch.Tensor]:
    fields = _common_fields(s)
    fields["h"] = torch.full_like(s["mask"], float(r_cut))
    fields["m"] = s["m"]
    return fields


def p2p_gravity_pass(s: Dict, G: float, H_soft: float, r_s: float,
                     r_cut: float, s_j: Optional[Dict] = None) -> PairPass:
    """P2P gravity on the species ``s`` from itself, or, with ``s_j``,
    from another species on the same column grid (a cross-species pass;
    ``H_soft`` is then the pair's softening, max(H_i, H_j))."""
    fields = _grav_fields(s, r_cut)
    gparams = _grav_params(G, H_soft, r_s, r_cut)
    r_cut2, H_inv, _, r_s_inv, Gf = gparams

    def fn(sf, nf, dx, r2):
        ok = r2 < r_cut2
        F, P = pg.force_pot_factors(r2, H_inv, r_s_inv, True)
        gm = Gf * nf("m")
        gmF = gm * F
        return ok, [-gmF * dx[0], -gmF * dx[1], -gmF * dx[2], -gm * P], []

    body = PairBody("p2p_gravity", P2P_FIELDS, 4, 0, gparams, fn)
    return PairPass(body, fields, range_scale=1.0,
                    fields_j=None if s_j is None
                    else _grav_fields(s_j, r_cut))


def timebin_pass(s: Dict, p: SPHENIXParams) -> PairPass:
    """Min time bin over ACTIVE neighbours whose own kernel reaches i
    (``s["active"]`` is 0/1 f32): the limiter's wake scan."""
    fields = _common_fields(s)
    fields["h"] = _san(s, "h")
    fields["tb"] = s["time_bin"].to(F32)
    fields["act"] = s["active"]
    gamma2 = float(p.kernel.gamma2)
    big_bin = float(NBIN_SENTINEL)

    def fn(sf, nf, dx, r2):
        h_j = nf("h")
        ok = (nf("act") > 0) & (r2 < gamma2 * h_j * h_j) & (nf("tb") > 0)
        neg_tb = torch.where(nf("tb") > 0, -nf("tb"), -big_bin)
        return ok, [], [neg_tb]

    # the kernel enters only through gamma2: one body for every kernel
    body = PairBody("timebin", TIMEBIN_FIELDS, 0, 1, (gamma2,), fn)
    return PairPass(body, fields, range_scale=float(p.kernel.gamma),
                    sym_range=True)


def chem_smooth_pass(s: Dict, p: SPHENIXParams) -> PairPass:
    """Chemistry smoothing's neighbour sums (chemistry_iact.h): m_j
    W(r, h_i) times Z_j and each element fraction, over the density
    body's pairs (the reference's ``u2 < gamma^2`` test)."""
    if p.kernel != CUBIC_SPLINE:
        raise NotImplementedError(
            f"the chemistry smoothing body runs the cubic spline only, not "
            f"{kernel_name(p.kernel)!r}")
    fields = _common_fields(s)
    fields["h"] = _san(s, "h")
    fields["hinv"] = 1.0 / fields["h"]
    fields["m"] = s["m"]
    fields["Z"] = s["Z"]
    for k in range(N_ELEMENTS):
        fields[f"e{k}"] = s["elem_frac"][..., k]
    gamma2 = float(p.kernel.gamma2)

    def fn(sf, nf, dx, r2):
        u2 = r2 * sf("hinv") * sf("hinv")
        w, _ = p.kernel.deval(torch.sqrt(u2))
        mw = nf("m") * w
        return u2 < gamma2, [mw * nf("Z")] + [
            mw * nf(f"e{k}") for k in range(N_ELEMENTS)], []

    body = PairBody("chem_smooth", CHEM_FIELDS, 1 + N_ELEMENTS, 0,
                    _kernel_params(p), fn)
    return PairPass(body, fields, range_scale=float(p.kernel.gamma))


# ---------------------------------------------------------------------------
# Loops (the reference's hydro_pallas contracts, both engines)
# ---------------------------------------------------------------------------

def density_loop(grid: CellGrid, s: Dict, p: SPHENIXParams,
                 active_i: torch.Tensor = None,
                 engine: str = "flat") -> Dict[str, torch.Tensor]:
    sums, _ = _apply(engine, grid, density_pass(s, p), active_i)
    m = s["mask"]
    out = {
        "rho": sums[0] * m, "rho_dh": sums[1] * m, "wcount": sums[2] * m,
        "wcount_dh": sums[3] * m, "div_v": sums[4] * m,
        "rot_v": torch.stack([sums[5] * m, sums[6] * m, sums[7] * m], -1),
    }
    for i, k in enumerate(p.mod.DENSITY_EXTRA_KEYS):
        out[k] = sums[8 + i] * m
    return out


def gradient_loop(grid: CellGrid, s: Dict, p: SPHENIXParams,
                  cosmo: CosmoFactors, active_i: torch.Tensor = None,
                  engine: str = "flat") -> Dict[str, torch.Tensor]:
    sums, maxes = _apply(engine, grid, gradient_pass(s, p, cosmo),
                         active_i)
    m = s["mask"]
    out = {k: sums[i] * m for i, k in enumerate(p.mod.GRADIENT_SUM_KEYS)}
    out["v_sig"] = torch.maximum(s["v_sig"], maxes[0])
    out["alpha_visc_max_ngb"] = torch.maximum(s["alpha_visc_max_ngb"],
                                              maxes[1])
    return out


def _force_out(s, sums, maxes):
    m = s["mask"]
    min_tb = torch.clamp_max(-maxes[1], float(NBIN_SENTINEL))
    return {
        "a_hydro": torch.stack([sums[0] * m, sums[1] * m, sums[2] * m], -1),
        "u_dt": sums[3] * m,
        "h_dt": sums[4] * m,
        "v_sig": torch.maximum(s["v_sig"], maxes[0]),
        "min_ngb_time_bin": min_tb.to(torch.int32),
    }


def force_loop(grid: CellGrid, s: Dict, p: SPHENIXParams,
               cosmo: CosmoFactors, active_i: torch.Tensor = None,
               engine: str = "flat") -> Dict[str, torch.Tensor]:
    sums, maxes = _apply(engine, grid, force_pass(s, p, cosmo), active_i)
    return _force_out(s, sums, maxes)


def force_gravity_loop(grid: CellGrid, s: Dict, p: SPHENIXParams,
                       cosmo: CosmoFactors, G: float, H_soft: float,
                       r_s: float, r_cut: float,
                       active_i: torch.Tensor = None) -> Dict:
    """force_loop's dict plus "a_grav" (C,W,3) and "pot" (C,W), from one
    fused traversal."""
    pp = force_gravity_pass(s, p, cosmo, G, H_soft, r_s, r_cut)
    sums, maxes = pair_flat.pair_apply(grid, pp, active_i)
    out = _force_out(s, sums, maxes)
    m = s["mask"]
    out["a_grav"] = torch.stack([sums[5] * m, sums[6] * m, sums[7] * m], -1)
    out["pot"] = sums[8] * m
    return out


def _pad_lanes(s: Dict) -> Dict:
    """Pad a species' tiles to the kernel's 128-lane i-tiles with empty
    slots (mask 0), as the reference's ``pad_lanes``; only the fields a
    P2P pass reads."""
    sub = {k: s[k] for k in ("mask", "off", "m")}
    W = sub["mask"].shape[1]
    pad = (-W) % pair_flat.LANES
    if pad == 0:
        return sub
    return {k: torch.cat([v, torch.zeros((v.shape[0], pad) + v.shape[2:],
                                         dtype=v.dtype, device=v.device)],
                         dim=1) for k, v in sub.items()}


def p2p_gravity_loop(grid: CellGrid, s_i: Dict, species_j: Sequence[Dict],
                     G: float, H_soft: float, r_s: float, r_cut: float,
                     H_soft_j: Optional[Sequence[float]] = None):
    """Short-range P2P gravity on the species ``s_i`` from every species
    of ``species_j`` (each with its own column capacity, on the same
    column grid): pairs beyond r_cut are left to the PM mesh.  A source
    that is ``s_i`` itself (``is``) runs K1's one-species launch, any
    other its cross-species launch; a pair softens with max(H_i, H_j)
    (``H_soft_j``: one softening per source, default ``H_soft``).  The
    reference's ``hydro_pallas.p2p_gravity_loop`` (periodic truncation,
    the port's only mode).  Returns (acc (C,W,3), pot (C,W))."""
    W_i = s_i["mask"].shape[1]
    fi = _pad_lanes(s_i)
    H_js = ([float(h) for h in H_soft_j] if H_soft_j is not None
            else [float(H_soft)] * len(species_j))
    acc0 = acc1 = acc2 = pot = 0.0
    for s_j, H_j in zip(species_j, H_js):
        same = s_j is s_i
        pp = p2p_gravity_pass(fi, G, max(float(H_soft), H_j), r_s, r_cut,
                              s_j=None if same else _pad_lanes(s_j))
        sums, _ = pair_flat.pair_apply(grid, pp)
        acc0 = acc0 + sums[0][:, :W_i]
        acc1 = acc1 + sums[1][:, :W_i]
        acc2 = acc2 + sums[2][:, :W_i]
        pot = pot + sums[3][:, :W_i]
    m = s_i["mask"]
    return (torch.stack([acc0 * m, acc1 * m, acc2 * m], -1), pot * m)


def chemistry_smooth_loop(grid: CellGrid, s: Dict, p: SPHENIXParams):
    """Kernel-smoothed metal mass fractions on the flat engine (the
    reference's XLA ``ops/stencil.py:597 chemistry_smooth_loop``, its
    plain version ``stencil.chemistry_smooth_loop``): the neighbour sums
    from the chemistry body, then the self term and h^-3 / rho.  Needs
    mask/off/m/h/rho/Z/elem_frac.  Returns (Z_smooth (C, W),
    elem_frac_smooth (C, W, 9))."""
    sums, _ = pair_flat.pair_apply(grid, chem_smooth_pass(s, p))
    return chemistry_smooth_finish(s, p, sums[0],
                                   torch.stack(sums[1:], -1))


def timebin_loop(grid: CellGrid, s: Dict, p: SPHENIXParams) -> torch.Tensor:
    """(C, W) i32 min time bin over active neighbours on the flat engine
    (``NBIN_SENTINEL`` where there is none): the wake scan of the timestep
    limiter.  ``s`` holds mask, off, h, time_bin and active (0/1 f32)."""
    _, maxes = pair_flat.pair_apply(grid, timebin_pass(s, p))
    return torch.clamp_max(-maxes[0], float(NBIN_SENTINEL)).to(torch.int32)

"""Tabulated planetary equations of state: HM80 and SESAME/ANEOS, in torch.

Port of the reference's ``models/sph/eos_tables.py`` (SWIFT's
src/equation_of_state/planetary/hm80.h:75 load_table_HM80, sesame.h:342
load_table_SESAME): the text readers parse with numpy, the interpolation
runs in torch on the particles' device.

* **HM80** (Hubbard & MacFarlane 1980): P(rho, u) on a regular grid in
  (ln rho, ln u); a bilinear interpolation of ln P with edge
  extrapolation (hm80.h:223-268).  The sound speed is sqrt(K / rho) for
  the condensed materials and the ideal-gas form with a pressure floor
  for the H/He atmosphere (hm80.h:281-301).
* **SESAME / ANEOS / custom** (sesame.h): a density axis and, per density,
  rows of u, P and c over temperature; the u search is per row
  (sesame.h:500-503), with the duplicate-knot guards and the
  below-minimum-u clamp (sesame.h:522-559).

The tables are SI; ``in_internal(...)`` converts one to the run's units
(convert_units_HM80 / convert_units_SESAME).  No table ships with the
repo.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

F32 = torch.float32


def _tokens(path: str, skip_lines: int):
    """Whitespace tokens of a text table after its header lines."""
    with open(path) as f:
        lines = f.readlines()
    return " ".join(lines[skip_lines:]).split()


def _on(tab, name: str, device) -> torch.Tensor:
    """The table's array ``name`` as an f32 tensor on ``device``, made
    once per device (the tables are frozen: the tensor is cached on the
    object, outside its fields)."""
    cache = tab.__dict__.setdefault("_tensors", {})
    key = (name, str(device))
    if key not in cache:
        cache[key] = torch.as_tensor(
            np.asarray(getattr(tab, name), np.float32), device=device)
    return cache[key]


def _f32_tensor(x):
    return torch.as_tensor(x, dtype=F32)


# ---------------------------------------------------------------------------
# HM80
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HM80Table:
    """P(rho, u) on a regular (ln rho, ln u) grid (hm80.h:43-49), in the
    caller's units (load in SI, then ``in_internal``); ``log_P`` is the
    natural-log pressure, (num_rho, num_u)."""

    log_rho_min: float
    log_rho_max: float
    num_rho: int
    log_u_min: float
    log_u_max: float
    num_u: int
    log_P: Tuple                   # nested tuple (num_rho, num_u)
    bulk_mod: float = 0.0          # set_HM80_* (hm80.h:52-70)
    P_min_for_c_min: float = 0.0
    gamma: float = 5.0 / 3.0

    @property
    def log_rho_step(self):
        return (self.log_rho_max - self.log_rho_min) / (self.num_rho - 1)

    @property
    def log_u_step(self):
        return (self.log_u_max - self.log_u_min) / (self.num_u - 1)

    def in_internal(self, rho_to_si: float, u_to_si: float,
                    P_from_si: float) -> "HM80Table":
        """convert_units_HM80 (hm80.h:148-177): the log axes and the
        log-P table shifted by the unit ratios."""
        lp = np.asarray(self.log_P, np.float64) + np.log(P_from_si)
        return replace(
            self,
            log_rho_min=self.log_rho_min - np.log(rho_to_si),
            log_rho_max=self.log_rho_max - np.log(rho_to_si),
            log_u_min=self.log_u_min - np.log(u_to_si),
            log_u_max=self.log_u_max - np.log(u_to_si),
            log_P=tuple(map(tuple, lp)),
            bulk_mod=self.bulk_mod * P_from_si,
            P_min_for_c_min=self.P_min_for_c_min * P_from_si)


def load_hm80(path: str, bulk_mod: float = 0.0,
              P_min_for_c_min: float = 0.0,
              gamma: float = 5.0 / 3.0) -> HM80Table:
    """Parse the HM80 text format (hm80.h:75-134): 5 header lines, a date
    stamp, the axis line ``log_rho_min log_rho_max num_rho log_u_min
    log_u_max num_u`` and num_rho * num_u pressures in Pa (row-major in
    rho); the temperature block after them is ignored, as the reference
    does.  Values stay in SI."""
    toks = _tokens(path, 5)
    int(toks[0])                             # the date stamp
    lr0, lr1, nr = float(toks[1]), float(toks[2]), int(toks[3])
    lu0, lu1, nu = float(toks[4]), float(toks[5]), int(toks[6])
    P = np.asarray(toks[7:7 + nr * nu], np.float64).reshape(nr, nu)
    return HM80Table(lr0, lr1, nr, lu0, lu1, nu,
                     tuple(map(tuple, np.log(P))),
                     bulk_mod=bulk_mod, P_min_for_c_min=P_min_for_c_min,
                     gamma=gamma)


def hm80_pressure(rho, u, tab: HM80Table):
    """HM80_pressure_from_internal_energy (hm80.h:223-268): bilinear in
    (ln rho, ln u) on ln P with edge extrapolation."""
    rho, u = _f32_tensor(rho), _f32_tensor(u)
    lp = _on(tab, "log_P", rho.device)
    log_rho = torch.log(torch.clamp_min(rho, 1e-38))
    log_u = torch.log(torch.clamp_min(u, 1e-38))
    inv_dr = 1.0 / tab.log_rho_step
    inv_du = 1.0 / tab.log_u_step
    ir = torch.floor((log_rho - tab.log_rho_min) * inv_dr)
    iu = torch.floor((log_u - tab.log_u_min) * inv_du)
    ir = torch.clamp(ir, 0, tab.num_rho - 2).to(torch.int64)
    iu = torch.clamp(iu, 0, tab.num_u - 2).to(torch.int64)
    fr = (log_rho - tab.log_rho_min - ir.to(F32) * tab.log_rho_step) \
        * inv_dr
    fu = (log_u - tab.log_u_min - iu.to(F32) * tab.log_u_step) * inv_du
    p00 = lp[ir, iu]
    p01 = lp[ir, iu + 1]
    p10 = lp[ir + 1, iu]
    p11 = lp[ir + 1, iu + 1]
    logP = (1 - fr) * ((1 - fu) * p00 + fu * p01) \
        + fr * ((1 - fu) * p10 + fu * p11)
    return torch.where(u <= 0.0, 0.0, torch.exp(logP))


def hm80_soundspeed(rho, u, tab: HM80Table):
    """hm80.h:281-301: sqrt(K / rho) when a bulk modulus is set (ice,
    rock), else the ideal-gas c_s from the interpolated P with the
    P_min_for_c_min floor (H/He)."""
    rho, u = _f32_tensor(rho), _f32_tensor(u)
    rho_s = torch.clamp_min(rho, 1e-38)
    if tab.bulk_mod != 0.0:
        return torch.sqrt(float(np.float32(tab.bulk_mod)) / rho_s)
    P = torch.clamp_min(hm80_pressure(rho, u, tab),
                        float(np.float32(tab.P_min_for_c_min)))
    return torch.sqrt(float(np.float32(tab.gamma)) * P / rho_s)


# ---------------------------------------------------------------------------
# SESAME
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SESAMETable:
    """A SESAME-format irregular table (sesame.h:40-55): the density axis
    ``log_rho`` (num_rho,) and per-density rows ``log_u``, ``P``, ``c``
    (num_rho, num_T); natural logs, the caller's units."""

    log_rho: Tuple            # (num_rho,)
    log_u: Tuple              # (num_rho, num_T)
    P: Tuple                  # (num_rho, num_T)
    c: Tuple                  # (num_rho, num_T)

    def in_internal(self, rho_to_si: float, u_to_si: float,
                    P_from_si: float) -> "SESAMETable":
        """convert_units_SESAME (sesame.h:305-355); the speed unit is the
        square root of the specific-energy unit."""
        c_from_si = 1.0 / np.sqrt(u_to_si)
        return SESAMETable(
            log_rho=tuple(np.asarray(self.log_rho, np.float64)
                          - np.log(rho_to_si)),
            log_u=tuple(map(tuple, np.asarray(self.log_u, np.float64)
                            - np.log(u_to_si))),
            P=tuple(map(tuple, np.asarray(self.P, np.float64)
                        * P_from_si)),
            c=tuple(map(tuple, np.asarray(self.c, np.float64)
                        * c_from_si)))


def load_sesame(path: str) -> SESAMETable:
    """Parse the SESAME text format (sesame.h:330-439): 12 header lines,
    the version date, ``num_rho num_T``, the density axis (kg/m^3), the
    temperature axis (ignored, as the reference does), then num_rho *
    num_T rows of ``u P c s`` (SI), T-major with rho fastest.  The first
    rho = 0 and T = 0 entries are dropped (sesame.h:373-376).  Values stay
    in SI."""
    toks = _tokens(path, 12)
    int(toks[0])                             # the version date
    nr, nT = int(toks[1]), int(toks[2])
    i = 3
    rho = np.asarray(toks[i:i + nr], np.float64)
    i += nr
    i += nT                                  # the temperature axis
    body = np.asarray(toks[i:i + 4 * nr * nT], np.float64) \
        .reshape(nT, nr, 4)                  # (T, rho, [u P c s])
    rho = rho[1:]
    body = body[1:, 1:, :]
    u = body[..., 0].T                       # (num_rho - 1, num_T - 1)
    P = body[..., 1].T
    c = body[..., 2].T
    u = np.where(u <= 0, 1e-20, u)           # the u_tiny guard (sesame.h:286)
    c = np.where(c <= 0, 1e-20, c)
    # u increasing along each rho row, swept from high T down
    # (sesame.h:245-260): real tables are slightly non-monotonic at low T,
    # which would break the row search's rank count
    for j in range(u.shape[1] - 2, -1, -1):
        u[:, j] = np.minimum(u[:, j], u[:, j + 1] * (1.0 - 1e-12))
    return SESAMETable(log_rho=tuple(np.log(rho)),
                       log_u=tuple(map(tuple, np.log(u))),
                       P=tuple(map(tuple, P)),
                       c=tuple(map(tuple, c)))


def _row_search(rows, v):
    """find_value_in_monot_incr_array per row (sesame.h): rows (N, nT)
    gathered per particle, v (N,); the knot interval's index, clipped to
    [0, nT - 2]."""
    nT = rows.shape[-1]
    idx = torch.sum(rows <= v[..., None], dim=-1) - 1
    return torch.clamp(idx, 0, nT - 2)


def _sesame_bilinear(rho, u, tab: SESAMETable, vals):
    """The irregular-grid bilinear interpolation shared by
    SESAME_pressure/soundspeed_from_internal_energy (sesame.h:480-600):
    ``vals`` (num_rho, num_T) interpolated at (rho, u)."""
    log_rho_ax = _on(tab, "log_rho", rho.device)
    log_u_tab = _on(tab, "log_u", rho.device)
    nr = log_rho_ax.shape[0]
    log_rho = torch.log(torch.clamp_min(rho, 1e-38))
    log_u = torch.log(torch.clamp_min(u, 1e-38))

    ir = torch.clamp(torch.sum(log_rho_ax <= log_rho[..., None], dim=-1)
                     - 1, 0, nr - 2)
    row1 = log_u_tab[ir]                     # (..., num_T)
    row2 = log_u_tab[ir + 1]
    iu1 = _row_search(row1, log_u)
    iu2 = _row_search(row2, log_u)

    dr = log_rho_ax[ir + 1] - log_rho_ax[ir]
    fr = torch.where(dr != 0, (log_rho - log_rho_ax[ir])
                     / torch.where(dr != 0, dr, 1.0), 1.0)
    u11 = log_u_tab[ir, iu1]
    u12 = log_u_tab[ir, iu1 + 1]
    u21 = log_u_tab[ir + 1, iu2]
    u22 = log_u_tab[ir + 1, iu2 + 1]
    du1 = u12 - u11
    du2 = u22 - u21
    fu1 = torch.where(du1 != 0, (log_u - u11)
                      / torch.where(du1 != 0, du1, 1.0), 1.0)
    fu2 = torch.where(du2 != 0, (log_u - u21)
                      / torch.where(du2 != 0, du2, 1.0), 1.0)

    v1 = vals[ir, iu1]
    v2 = vals[ir, iu1 + 1]
    v3 = vals[ir + 1, iu2]
    v4 = vals[ir + 1, iu2 + 1]
    # below the minimum u at this rho: the lowest table values
    # (sesame.h:554-559)
    bad = (ir > 0) & ((fu1 < 0) | (fu2 < 0) | (v1 > v2) | (v3 > v4))
    fu1 = torch.where(bad, 0.0, fu1)
    fu2 = torch.where(bad, 0.0, fu2)
    return (1 - fr) * ((1 - fu1) * v1 + fu1 * v2) \
        + fr * ((1 - fu2) * v3 + fu2 * v4)


def sesame_pressure(rho, u, tab: SESAMETable):
    """SESAME_pressure_from_internal_energy (sesame.h:480-575)."""
    rho, u = _f32_tensor(rho), _f32_tensor(u)
    out = _sesame_bilinear(rho, u, tab, _on(tab, "P", rho.device))
    return torch.where(u <= 0.0, 0.0, torch.clamp_min(out, 0.0))


def sesame_soundspeed(rho, u, tab: SESAMETable):
    """SESAME_soundspeed_from_internal_energy (the same interpolation on
    c)."""
    rho, u = _f32_tensor(rho), _f32_tensor(u)
    out = _sesame_bilinear(rho, u, tab, _on(tab, "c", rho.device))
    return torch.clamp_min(out, 1e-20)


# material id -> the HM80 family's bulk modulus and c_s pressure floor
# (set_HM80_*, hm80.h:52-70; equation_of_state.h:108-148)
HM80_DEFAULTS = {
    200: dict(bulk_mod=0.0, P_min_for_c_min=1e3),      # H/He
    201: dict(bulk_mod=2.0e9, P_min_for_c_min=0.0),    # ice
    202: dict(bulk_mod=3.49e10, P_min_for_c_min=0.0),  # rock
}

"""Multi-material planetary equations of state, in torch.

Port of the reference's ``models/sph/planetary_eos.py`` (SWIFT's
src/equation_of_state/planetary/equation_of_state.h): each particle's
material id selects its EOS family.  The reference branches per particle;
here each family present (ideal gas, Tillotson, the HM80 and SESAME
tables) is evaluated once over all particles, branch-free, and
``torch.where`` keeps each particle's own.  The Tillotson parameters are
gathered per particle from a small table.

Material ids follow the reference (equation_of_state.h:47): ``mat_id =
type * 100 + unit``, type 0 the ideal gas, 1 Tillotson, 2 HM80, 3 SESAME
(4 ANEOS and 9 custom, both in SESAME's format).  A table material needs
its table (``eos_tables.load_hm80`` / ``load_sesame``); none ships with
the repo.  The Tillotson parameters (tillotson.h:50-118) are SI, converted
to the run's units at construction as convert_units_Til does
(tillotson.h:120-140).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

# reference material ids (equation_of_state.h:77-136)
ID_IDG_DEF = 0
ID_TIL_IRON = 100
ID_TIL_GRANITE = 101
ID_TIL_WATER = 102
ID_TIL_BASALT = 103

# Tillotson parameter sets in SI, (rho_0, a, b, A, B, u_0, u_iv, u_cv,
# alpha, beta, eta_min, eta_zero, P_min): tillotson.h:50-118
_TIL_SI: Dict[int, Tuple[float, ...]] = {
    ID_TIL_IRON: (7800.0, 0.5, 1.5, 1.28e11, 1.05e11, 9.5e6, 2.4e6,
                  8.67e6, 5.0, 5.0, 0.0, 0.0, 0.0),
    ID_TIL_GRANITE: (2680.0, 0.5, 1.3, 1.8e10, 1.8e10, 1.6e7, 3.5e6,
                     1.8e7, 5.0, 5.0, 0.0, 0.0, 0.0),
    ID_TIL_WATER: (998.0, 0.7, 0.15, 2.18e9, 1.325e10, 7.0e6, 4.19e5,
                   2.69e6, 10.0, 5.0, 0.925, 0.875, 0.0),
    ID_TIL_BASALT: (2700.0, 0.5, 1.5, 2.67e10, 2.67e10, 4.87e8, 4.72e6,
                    1.82e7, 5.0, 5.0, 0.0, 0.0, 0.0),
}

_TIL_FIELDS = ("rho_0", "a", "b", "A", "B", "u_0", "u_iv", "u_cv",
               "alpha", "beta", "eta_min", "eta_zero", "P_min")


def _til_cold(rho, u, m, eta, mu, w_inv):
    """The condensed/cold Tillotson pressure with the low-density taper
    (eta_zero .. eta_min)."""
    P_c = (m["a"] + m["b"] * w_inv) * rho * u + m["A"] * mu \
        + m["B"] * mu * mu
    taper = (eta - m["eta_zero"]) / torch.clamp_min(
        m["eta_min"] - m["eta_zero"], 1e-20)
    return torch.where(eta < m["eta_zero"], 0.0,
                       torch.where(eta < m["eta_min"], P_c * taper, P_c))


def _til_regions(eta, u, m):
    """(cold, hot, hybrid weight): the Tillotson region of each state."""
    cold = (eta > 1.0) | (u < m["u_iv"])
    hot = (eta < 1.0) & (u > m["u_cv"])
    frac = (u - m["u_iv"]) / torch.clamp_min(m["u_cv"] - m["u_iv"], 1e-20)
    return cold, hot, frac


def _til_pressure(rho, u, m):
    """Tillotson P(rho, u) (Til_pressure_from_internal_energy,
    tillotson.h:182-230), the cold, expanded and hybrid regions selected
    branch-free."""
    eta = rho / m["rho_0"]
    eta_safe = torch.clamp_min(eta, 1e-10)
    eta_sq = eta * eta
    mu = eta - 1.0
    nu = 1.0 / eta_safe - 1.0
    w = u / (m["u_0"] * torch.clamp_min(eta_sq, 1e-20)) + 1.0
    w_inv = 1.0 / w

    P_c = _til_cold(rho, u, m, eta, mu, w_inv)
    exp_a = torch.exp(-m["alpha"] * nu * nu)
    exp_b = torch.exp(-m["beta"] * nu)
    P_e = m["a"] * rho * u \
        + (m["b"] * rho * u * w_inv + m["A"] * mu * exp_b) * exp_a

    cold, hot, frac = _til_regions(eta, u, m)
    P_h = frac * P_e + (1.0 - frac) * P_c
    P = torch.where(cold, P_c, torch.where(hot, P_e, P_h))
    return torch.maximum(P, m["P_min"])


def _til_soundspeed(rho, u, m):
    """Tillotson c_s(rho, u) (Til_soundspeed_from_internal_energy,
    tillotson.h:240-300), floored at sqrt(A / rho_0)."""
    rho_0_inv = 1.0 / m["rho_0"]
    rho_safe = torch.clamp_min(rho, 1e-20)
    rho_inv = 1.0 / rho_safe
    eta = rho * rho_0_inv
    eta_safe = torch.clamp_min(eta, 1e-10)
    eta_sq = eta * eta
    mu = eta - 1.0
    nu = 1.0 / eta_safe - 1.0
    w = u / (m["u_0"] * torch.clamp_min(eta_sq, 1e-20)) + 1.0
    w_inv = 1.0 / w
    w_inv_sq = w_inv * w_inv
    exp_b = torch.exp(-m["beta"] * nu)
    exp_a = torch.exp(-m["alpha"] * nu * nu)

    P_c = _til_cold(rho, u, m, eta, mu, w_inv)
    c_sq_c = P_c * rho_inv * (1.0 + m["a"] + m["b"] * w_inv) \
        + m["b"] * (w - 1.0) * w_inv_sq * (2.0 * u - P_c * rho_inv) \
        + rho_inv * (m["A"] + m["B"] * (eta_sq - 1.0))

    P_e = m["a"] * rho * u \
        + (m["b"] * rho * u * w_inv + m["A"] * mu * exp_b) * exp_a
    eta_sq_safe = torch.clamp_min(eta_sq, 1e-20)
    c_sq_e = P_e * rho_inv * (1.0 + m["a"] + m["b"] * w_inv * exp_a) \
        + (m["b"] * rho * u * w_inv_sq / eta_sq_safe
           * (rho_inv / m["u_0"] * (2.0 * u - P_e * rho_inv)
              + 2.0 * m["alpha"] * nu * w * rho_0_inv)
           + m["A"] * rho_0_inv
           * (1.0 + mu / eta_sq_safe
              * (m["beta"] + 2.0 * m["alpha"] * nu - eta)) * exp_b) * exp_a

    cold, hot, frac = _til_regions(eta, u, m)
    c_sq_h = frac * c_sq_e + (1.0 - frac) * c_sq_c
    c_sq = torch.where(cold, c_sq_c, torch.where(hot, c_sq_e, c_sq_h))
    c_sq = torch.maximum(c_sq, m["A"] * rho_0_inv)
    return torch.sqrt(c_sq)


@dataclass(frozen=True)
class PlanetaryEOS:
    """The material-id-dispatched EOS (equation_of_state.h's surface).

    ``materials``: the reference material ids of the run.
    ``rho_to_si``, ``u_to_si``, ``P_from_si``: the internal-to-SI density
    and specific-energy factors and the SI-to-internal pressure factor
    (convert_units_Til); with the defaults the internal system is SI.
    ``gamma``: the ideal-gas material's adiabatic index.
    ``hm80_tables``, ``sesame_tables``: ((mat_id, table), ...) of the
    table families (``eos_tables.load_hm80`` / ``load_sesame``), already
    in internal units (``.in_internal(rho_to_si, u_to_si, P_from_si)``).
    """

    materials: Tuple[int, ...] = (ID_IDG_DEF,)
    gamma: float = 5.0 / 3.0
    rho_to_si: float = 1.0
    u_to_si: float = 1.0
    P_from_si: float = 1.0
    hm80_tables: Tuple = ()
    sesame_tables: Tuple = ()
    # the Tillotson table in internal units, one row per known id: a pure
    # function of the fields above, so out of eq/hash
    _til_table: Dict[str, np.ndarray] = field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        tabbed = {mid for mid, _ in self.hm80_tables} \
            | {mid for mid, _ in self.sesame_tables}
        for mid in self.materials:
            t = mid // 100
            if t == 2 and mid not in tabbed:
                raise ValueError(
                    f"material id {mid}: HM80 needs its table: pass "
                    "hm80_tables=((id, eos_tables.load_hm80(path)"
                    ".in_internal(...)),)")
            if t in (3, 4, 9) and mid not in tabbed:
                raise ValueError(
                    f"material id {mid}: SESAME/ANEOS needs its table: "
                    "pass sesame_tables=((id, eos_tables.load_sesame(path)"
                    ".in_internal(...)),)")
            if t not in (0, 1, 2, 3, 4, 9):
                raise ValueError(f"unknown material id {mid}")
            if t == 1 and mid not in _TIL_SI:
                raise ValueError(f"unknown Tillotson material id {mid}")
        # convert_units_Til: rho_0 a density, A, B and P_min pressures,
        # u_0, u_iv and u_cv specific energies, the rest dimensionless
        conv = {"rho_0": 1.0 / self.rho_to_si,
                "A": self.P_from_si, "B": self.P_from_si,
                "P_min": self.P_from_si,
                "u_0": 1.0 / self.u_to_si, "u_iv": 1.0 / self.u_to_si,
                "u_cv": 1.0 / self.u_to_si}
        ids = np.array(sorted(_TIL_SI), np.int32)
        rows = {k: [] for k in _TIL_FIELDS}
        for mid in ids:
            for k, v in zip(_TIL_FIELDS, _TIL_SI[int(mid)]):
                rows[k].append(v * conv.get(k, 1.0))
        object.__setattr__(self, "_til_ids", ids)
        object.__setattr__(self, "_til_table",
                           {k: np.asarray(v, np.float32)
                            for k, v in rows.items()})

    def _has_tillotson(self) -> bool:
        return any(m // 100 == 1 for m in self.materials)

    def _til_params(self, mat_id):
        """Each particle's Tillotson parameters (row 0 for the others)."""
        row = torch.zeros(mat_id.shape, dtype=torch.int64,
                          device=mat_id.device)
        for i, mid in enumerate(self._til_ids):
            row = torch.where(mat_id == int(mid), i, row)
        return {k: v[row] for k, v in self._til_on(mat_id.device).items()}

    def _til_on(self, device):
        """The Tillotson table as tensors on ``device``, made once per
        device (the EOS is frozen: the tensors are cached on the object,
        outside its fields)."""
        cache = self.__dict__.setdefault("_til_tensors", {})
        key = str(device)
        if key not in cache:
            cache[key] = {k: torch.as_tensor(v, device=device)
                          for k, v in self._til_table.items()}
        return cache[key]

    def pressure_from_internal_energy(self, rho, u, mat_id):
        from . import eos_tables as et
        P = (self.gamma - 1.0) * rho * u
        if self._has_tillotson():
            P = torch.where((mat_id // 100) == 1,
                            _til_pressure(rho, u, self._til_params(mat_id)),
                            P)
        for mid, tab in self.hm80_tables:
            P = torch.where(mat_id == mid, et.hm80_pressure(rho, u, tab), P)
        for mid, tab in self.sesame_tables:
            P = torch.where(mat_id == mid, et.sesame_pressure(rho, u, tab),
                            P)
        return P

    def soundspeed_from_internal_energy(self, rho, u, mat_id):
        from . import eos_tables as et
        cs = torch.sqrt(self.gamma * (self.gamma - 1.0)
                        * torch.clamp_min(u, 0.0))
        if self._has_tillotson():
            cs = torch.where((mat_id // 100) == 1,
                             _til_soundspeed(rho, u,
                                             self._til_params(mat_id)), cs)
        for mid, tab in self.hm80_tables:
            cs = torch.where(mat_id == mid, et.hm80_soundspeed(rho, u, tab),
                             cs)
        for mid, tab in self.sesame_tables:
            cs = torch.where(mat_id == mid,
                             et.sesame_soundspeed(rho, u, tab), cs)
        return cs

    def soundspeed_from_pressure(self, rho, P, mat_id, u=None):
        """c_s(rho, u) where u is given (the scheme passes it everywhere,
        as the reference's Planetary hydro does, hydro.h:696); the P-only
        form holds for the ideal-gas material."""
        if u is not None:
            return self.soundspeed_from_internal_energy(rho, u, mat_id)
        return torch.sqrt(self.gamma * P / torch.clamp_min(rho, 1e-30))

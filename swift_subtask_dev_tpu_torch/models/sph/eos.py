"""Ideal-gas gamma-law equation of state (reference models/sph/eos.py)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class IdealGas:
    """gamma-law EOS; all quantities comoving unless stated otherwise."""

    gamma: float = 5.0 / 3.0

    @property
    def gamma_minus_one(self) -> float:
        return self.gamma - 1.0

    def pressure_from_internal_energy(self, rho, u):
        return self.gamma_minus_one * rho * u

    def soundspeed_from_pressure(self, rho, P):
        return torch.sqrt(self.gamma * P / rho)

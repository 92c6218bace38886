"""SPH smoothing kernel (cubic spline) in torch.

Port of the reference's ``models/sph/kernels.py`` for the kernel the main
path uses.  ``deval(u)`` with u = r/h returns (w, dw_du) such that
W(r, h) = w / h^d and dW/dr = dw_du / h^(d+1), evaluated in the
truncated-power form w(x) = sum_k c_k (a_k - x)_+^degree — the same f32
operation order as the reference, and as ``csrc/pair_bodies.cuh``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SPHKernel:
    """A truncated-power spline kernel on x = u/gamma in [0, 1]."""

    name: str
    gamma: float          # H/h: ratio of support radius to smoothing length
    constant: float       # normalisation (3D)
    degree: int
    tp_terms: tuple       # ((a_k, c_k), ...)
    w0: float             # w(x=0) / constant: the x**0 coefficient at x=0

    @property
    def gamma_inv(self) -> float:
        return 1.0 / self.gamma

    @property
    def gamma2(self) -> float:
        return self.gamma * self.gamma

    @property
    def root(self) -> float:
        """w at u=0 (W(0,h)·h^d), reference kernel_root."""
        return self.w0 * self.constant * self.gamma_inv ** 3

    @property
    def g3(self) -> float:
        return self.constant * self.gamma_inv ** 3

    @property
    def g4(self) -> float:
        return self.constant * self.gamma_inv ** 4

    def deval(self, u: torch.Tensor):
        """(w, dw_du) for u = r/h; zero beyond the support u > gamma."""
        x = u * self.gamma_inv
        deg = self.degree
        w = dw = None
        for a, c in self.tp_terms:
            t = torch.clamp_min(a - x, 0.0)
            pw = t
            for _ in range(deg - 2):
                pw = pw * t          # t^(deg-1)
            wt = c * (pw * t)
            dwt = (-deg * c) * pw
            w = wt if w is None else w + wt
            dw = dwt if dw is None else dw + dwt
        return w * self.g3, dw * self.g4


CUBIC_SPLINE = SPHKernel(
    name="Cubic spline (M4)",
    gamma=1.825742,
    constant=16.0 / math.pi,
    degree=3,
    tp_terms=((1.0, 1.0), (0.5, -4.0)),
    w0=0.5,
)

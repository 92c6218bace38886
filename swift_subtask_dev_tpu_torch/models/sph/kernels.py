"""SPH smoothing kernels in torch.

Port of the reference's ``models/sph/kernels.py``: the six kernels of its
``KERNELS`` table (cubic, quartic and quintic splines, Wendland C2, C4 and
C6; coefficients from Dehnen & Aly 2012), under the reference's names,
with its evaluation.  ``deval(u)`` with u = r/h returns (w, dw_du) such
that W(r, h) = w / h^d and dW/dr = dw_du / h^(d+1), on x = u / gamma:

* the splines in their truncated-power form w(x) = sum_k c_k (a_k -
  x)_+^degree (exactly the piecewise table);
* the Wendland kernels (one branch) by Horner over the branch's
  coefficients, w clamped to >= 0 and dw to <= 0, zero for x >= 1;
* any other table by Horner over every branch, selected by the clamped
  branch index.

Every step is the reference's f32 operation, in its order, as in
``csrc/pair_bodies.cuh``'s kernel structs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

HYDRO_DIMENSION = 3.0


@dataclass(frozen=True)
class SPHKernel:
    """A piecewise-polynomial kernel on x = u/gamma in [0, 1].

    coeffs[i] are highest-power-first polynomial coefficients for branch i,
    branch i covering x in [i/ivals, (i+1)/ivals).
    """

    name: str
    gamma: float          # H/h: ratio of support radius to smoothing length
    constant: float       # normalisation (3D)
    coeffs: tuple         # (ivals, degree+1) nested tuples
    ivals: int
    degree: int
    tp_terms: tuple = ()  # ((a_k, c_k), ...): the truncated-power form

    @property
    def gamma_inv(self) -> float:
        return 1.0 / self.gamma

    @property
    def gamma2(self) -> float:
        return self.gamma * self.gamma

    @property
    def root(self) -> float:
        """w at u=0 (W(0,h)·h^d), reference kernel_root."""
        c0 = self.coeffs[0][-1]
        return c0 * self.constant * self.gamma_inv ** 3

    @property
    def norm(self) -> float:
        """Volume normalisation 4/3 pi gamma^3 (reference kernel_norm)."""
        return (4.0 / 3.0) * math.pi * self.gamma ** 3

    @property
    def g3(self) -> float:
        return self.constant * self.gamma_inv ** 3

    @property
    def g4(self) -> float:
        return self.constant * self.gamma_inv ** 4

    def deval(self, u: torch.Tensor):
        """(w, dw_du) for u = r/h; zero beyond the support u > gamma."""
        x = u * self.gamma_inv
        if self.tp_terms:
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
        if self.ivals == 1:
            # single polynomial on [0, 1) (the Wendland family)
            wi, dwi = _horner(self.coeffs[0], x)
            inside = x < 1.0
            w = torch.where(inside, torch.clamp_min(wi, 0.0), 0.0)
            dw = torch.where(inside, torch.clamp_max(dwi, 0.0), 0.0)
            return w * self.g3, dw * self.g4
        # the clamped branch index of the reference's kernel_deval
        ind = torch.clamp((x * self.ivals).to(torch.int32), 0, self.ivals)
        w = torch.zeros_like(x)
        dw = torch.zeros_like(x)
        for i in range(self.ivals + 1):
            cs = (self.coeffs[i] if i < self.ivals
                  else (0.0,) * (self.degree + 1))
            wi, dwi = _horner(cs, x)
            sel = ind == i
            w = torch.where(sel, wi, w)
            dw = torch.where(sel, dwi, dw)
        w = torch.clamp_min(w, 0.0)
        dw = torch.clamp_max(dw, 0.0)
        return w * self.g3, dw * self.g4

    def eval(self, u):
        return self.deval(u)[0]


def _horner(cs, x):
    """(w, dw/dx) of one branch, Horner from the highest power."""
    wi = torch.full_like(x, cs[0])
    dwi = torch.zeros_like(x)
    for c in cs[1:]:
        dwi = dwi * x + wi
        wi = wi * x + c
    return wi, dwi


_M1PI = 1.0 / math.pi

CUBIC_SPLINE = SPHKernel(
    name="Cubic spline (M4)",
    gamma=1.825742,
    constant=16.0 * _M1PI,
    ivals=2,
    degree=3,
    coeffs=(
        (3.0, -3.0, 0.0, 0.5),     # 0   < x < 0.5
        (-1.0, 3.0, -3.0, 1.0),    # 0.5 < x < 1
    ),
    tp_terms=((1.0, 1.0), (0.5, -4.0)),
)

QUARTIC_SPLINE = SPHKernel(
    name="Quartic spline (M5)",
    gamma=2.018932,
    constant=15625.0 * _M1PI / 512.0,
    ivals=5,
    degree=4,
    coeffs=(
        (6.0, 0.0, -2.4, 0.0, 0.368),
        (-4.0, 8.0, -4.8, 0.32, 0.352),
        (-4.0, 8.0, -4.8, 0.32, 0.352),
        (1.0, -4.0, 6.0, -4.0, 1.0),
        (1.0, -4.0, 6.0, -4.0, 1.0),
    ),
    tp_terms=((1.0, 1.0), (0.6, -5.0), (0.2, 10.0)),
)

QUINTIC_SPLINE = SPHKernel(
    name="Quintic spline (M6)",
    gamma=2.195775,
    constant=2187.0 * _M1PI / 40.0,
    ivals=3,
    degree=5,
    coeffs=(
        (-10.0, 10.0, 0.0, -2.2222222, 0.0, 0.271604938),
        (5.0, -15.0, 16.666667, -7.77777777, 0.925925, 0.209876543),
        (-1.0, 5.0, -10.0, 10.0, -5.0, 1.0),
    ),
    tp_terms=((1.0, 1.0), (2.0 / 3.0, -6.0), (1.0 / 3.0, 15.0)),
)

WENDLAND_C2 = SPHKernel(
    name="Wendland C2",
    gamma=1.936492,
    constant=21.0 * _M1PI / 2.0,
    ivals=1,
    degree=5,
    coeffs=((4.0, -15.0, 20.0, -10.0, 0.0, 1.0),),
)

WENDLAND_C4 = SPHKernel(
    name="Wendland C4",
    gamma=2.207940,
    constant=495.0 * _M1PI / 32.0,
    ivals=1,
    degree=8,
    coeffs=((11.666667, -64.0, 140.0, -149.333333, 70.0, 0.0,
             -9.3333333, 0.0, 1.0),),
)

WENDLAND_C6 = SPHKernel(
    name="Wendland C6",
    gamma=2.449490,
    constant=1365.0 * _M1PI / 64.0,
    ivals=1,
    degree=11,
    coeffs=((32.0, -231.0, 704.0, -1155.0, 1056.0, -462.0,
             0.0, 66.0, 0.0, -11.0, 0.0, 1.0),),
)

# SPH:kernel names (the reference's KERNELS)
KERNELS = {
    "cubic-spline": CUBIC_SPLINE,
    "quartic-spline": QUARTIC_SPLINE,
    "quintic-spline": QUINTIC_SPLINE,
    "wendland-C2": WENDLAND_C2,
    "wendland-C4": WENDLAND_C4,
    "wendland-C6": WENDLAND_C6,
}


def kernel_name(kernel: SPHKernel) -> str:
    """The SPH:kernel name of one of ``KERNELS``."""
    for name, k in KERNELS.items():
        if k == kernel:
            return name
    raise ValueError(f"kernel {kernel.name!r} is not one of {list(KERNELS)}")

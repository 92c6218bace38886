"""Global conserved-quantity reductions (reference ``io/statistics.py``).

``gas_statistics`` is the reference's minimal gas reduction: total mass,
kinetic, internal and total energy and momentum over the live slots of
the tiled state, in f32 sums as the reference takes them.
"""

from __future__ import annotations

from typing import Dict

import torch


def gas_statistics(s: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    m = s["m"] * s["mask"]
    live = s["mask"] > 0
    v = torch.where(live[..., None], s["v_full"], 0.0)
    e_kin = 0.5 * torch.sum(m * torch.sum(v * v, dim=-1))
    e_int = torch.sum(m * torch.where(live, s["u_full"], 0.0))
    mom = torch.sum(m[..., None] * v, dim=(0, 1))
    return {
        "total_mass": torch.sum(m),
        "e_kin": e_kin,
        "e_int": e_int,
        "e_tot": e_kin + e_int,
        "momentum": mom,
    }

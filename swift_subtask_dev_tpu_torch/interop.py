"""State carried across from the reference engine.

The system has no weights; what crosses between the two packages is the
tiled particle state.  ``state_from_reference`` takes a reference
``Engine.state`` converted with ``np.asarray`` and returns the port's state
with the same keys, shapes and dtypes (``drift_accum`` as a 0-dim tensor;
the SPH scheme's ``EXTRA_STATE_KEYS`` among them: the Pressure-Energy
schemes' smoothed pressure, Pressure-Entropy's weighted density,
Gasoline's velocity-gradient tensor and shock state, and Planetary's
``mat_id``, int32 as its ``EXTRA_STATE_INT_KEYS`` says);
``multi_state_from_reference`` does so for each species of a reference
``MultiEngine.state``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def state_from_reference(state: Dict[str, np.ndarray],
                         device) -> Dict[str, torch.Tensor]:
    out = {k: torch.tensor(np.asarray(v), device=device)
           for k, v in state.items()}
    if "drift_accum" in out:
        out["drift_accum"] = out["drift_accum"].reshape(()).to(torch.float32)
    return out


def multi_state_from_reference(state: Dict[str, Dict[str, np.ndarray]],
                               device) -> Dict[str, Dict[str, torch.Tensor]]:
    """A reference ``MultiEngine.state`` ({species: state}) carried across
    species by species, as ``state_from_reference``: every field of each
    species, the stars' (birth_time, birth_density, fb_done, m_init, Z,
    elem_frac (C, K, 9)), the black holes' (m_subgrid, energy_reservoir,
    swallow_prob, mdot, rho_gas, ngb_mass) and the gas's chemistry
    carriers included."""
    return {name: state_from_reference(sp, device)
            for name, sp in state.items()}

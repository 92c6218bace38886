"""The ANARCHY viscosity evolution of SWIFT's Phantom scheme, in torch.

Port of ``anarchy_alpha_evolution`` from the reference's
``models/sph/phantom.py:97`` (Phantom hydro.h:752-801, shared with
AnarchyPU's prepare_force).  The Phantom scheme itself is not ported yet
(ROADMAP.md); ``models/sph/anarchy_pu.py`` uses this update.
"""

from __future__ import annotations

import torch

from .sphenix import CosmoFactors, _safe_h


def anarchy_alpha_evolution(p, s, cosmo: CosmoFactors, dt_alpha):
    """Shared ANARCHY viscosity-alpha update: source from -d(div v)/dt,
    trigger on v_sig²/4, exponential decay over the sound-crossing time.
    ``dt_alpha``: a python float or a tensor broadcast against the state."""
    kern_supp = _safe_h(s) * cosmo.a * p.kernel.gamma
    kern_supp_inv = 1.0 / kern_supp
    v_sig_phys = s["v_sig"] * cosmo.a_factor_sound_speed
    soundspeed_phys = s["soundspeed"] * cosmo.a_factor_sound_speed
    sound_crossing_inv = soundspeed_phys * kern_supp_inv

    dt_alpha = torch.as_tensor(dt_alpha, dtype=torch.float32,
                               device=s["h"].device)
    div_v_dt = torch.where(dt_alpha == 0.0, 0.0,
                           (s["div_v"] - s["div_v_prev"])
                           / torch.clamp_min(dt_alpha, 1e-30))
    S = kern_supp * kern_supp * torch.clamp_min(-div_v_dt, 0.0)
    v_sig2 = 0.25 * v_sig_phys * v_sig_phys
    alpha_loc = p.viscosity_alpha_max * S / (v_sig2 + S + 1e-30)

    alpha_decayed = alpha_loc + (s["alpha_visc"] - alpha_loc) * torch.exp(
        -dt_alpha * sound_crossing_inv * p.viscosity_length)
    alpha = torch.where(alpha_loc > s["alpha_visc"], alpha_loc,
                        alpha_decayed)
    return torch.clamp_min(alpha, p.viscosity_alpha_min)

"""Integer timeline with 56 hierarchical power-of-2 time bins.

The part of the reference's ``utils/timeline.py`` the engine uses.
Semantics follow src/timeline.h:36-160: the simulated time
span [time_begin, time_end] is divided into ``max_nr_timesteps = 2**57``
ticks; a particle in bin b has integer step ``dti(b) = 2**(b+1)``; steps are
aligned on the timeline so a particle is active exactly when ``ti_current``
is a multiple of its ``dti``.

Host/device split: all 64-bit integer arithmetic happens HERE, on the host, in
exact Python ints.  The device never sees an i64 — per-particle state stores
only the (small) ``time_bin``; each step the host hands the device a
``(num_bins,)`` boolean "bin is active now" mask plus the float kick/drift
intervals per bin, and receives back per-bin occupancy counts from which the
host computes the exact next ``ti_end_min``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NUM_TIME_BINS = 56
MAX_NR_TIMESTEPS = 1 << (NUM_TIME_BINS + 1)


def get_integer_timestep(bin_: int) -> int:
    """dti for a bin (reference timeline.h get_integer_timestep)."""
    if bin_ <= 0:
        return 0
    return 1 << (bin_ + 1)


def get_integer_time_end(ti_current: int, bin_: int) -> int:
    dti = get_integer_timestep(bin_)
    if dti == 0:
        return 0
    mod = ti_current % dti
    return ti_current if mod == 0 else ti_current - mod + dti


@dataclass
class Timeline:
    """The global integer timeline of a run (engine-owned).

    time_base = (time_end - time_begin)/max_nr_timesteps (engine.c analog).
    """

    time_begin: float
    time_end: float

    def __post_init__(self):
        self.time_base = (self.time_end - self.time_begin) / MAX_NR_TIMESTEPS
        self.time_base_inv = 1.0 / self.time_base
        self.ti_current = 0

    def time_of(self, ti: int) -> float:
        return self.time_begin + ti * self.time_base

    # --- per-step host-side bookkeeping -------------------------------------
    def active_bins_mask(self, ti: int | None = None) -> np.ndarray:
        """(NUM_TIME_BINS+1,) bool: bin b is active at ti_current.

        bin 0 is unused (dti=0); indices 1..56 are real bins.
        """
        ti = self.ti_current if ti is None else ti
        mask = np.zeros(NUM_TIME_BINS + 1, dtype=bool)
        for b in range(1, NUM_TIME_BINS + 1):
            dti = get_integer_timestep(b)
            mask[b] = (ti % dti) == 0
        return mask

    def max_active_bin(self, ti: int | None = None) -> int:
        """Largest bin active at ti (reference get_max_active_bin)."""
        ti = self.ti_current if ti is None else ti
        if ti == 0:
            return NUM_TIME_BINS
        best = 0
        for b in range(1, NUM_TIME_BINS + 1):
            if ti % (1 << (b + 1)) == 0:
                best = b
        return best

    def ti_end_min_from_bins(self, bin_counts: np.ndarray,
                             ti: int | None = None) -> int:
        """Exact next ti_end over all particles, from per-bin occupancy.

        Replaces the reference's collect-task tree + MPI_Allreduce
        (engine_collect_end_of_step.c:274-299): thanks to hierarchical
        alignment, every particle in bin b has
        ti_end = get_integer_time_end(ti+1, b), so occupancy per bin is a
        sufficient statistic.
        """
        ti = self.ti_current if ti is None else ti
        t_min = MAX_NR_TIMESTEPS
        for b in range(1, len(bin_counts)):
            if bin_counts[b] > 0:
                t_min = min(t_min, get_integer_time_end(ti + 1, b))
        return t_min

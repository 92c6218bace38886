"""Host-side utilities (numpy and plain Python): the integer timeline,
physical constants and the unit system."""

from . import constants, timeline, units
from .units import COSMO_UNITS, UnitSystem

__all__ = ["constants", "timeline", "units", "COSMO_UNITS", "UnitSystem"]

"""Host-side utilities (numpy only)."""

from . import timeline

__all__ = ["timeline"]

"""SWIFT-style parameter lookups over an in-memory mapping.

The getters of the reference's ``utils/params.py`` (``Section:param``
lookups, required and optional), over a ``{section: {name: value}}``
dict.  The reference reads YAML files with PyYAML, which the machine with
the card lacks; the port's examples write their parameter files' values
as such dicts, and the subgrid models' ``from_params`` read them here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class ParamError(KeyError):
    pass


class Params:
    """A parameter set (the reference's ``Params`` without files)."""

    def __init__(self, data: Optional[Dict[str, Dict[str, Any]]] = None):
        self._data: Dict[str, Dict[str, Any]] = data or {}

    def _get(self, section: str, name: str):
        sec = self._data.get(section)
        if sec is None or name not in sec:
            raise ParamError(f"Missing parameter '{section}:{name}'")
        return sec[name]

    def get_int(self, section: str, name: str) -> int:
        return int(self._get(section, name))

    def get_float(self, section: str, name: str) -> float:
        return float(self._get(section, name))

    def get_string(self, section: str, name: str) -> str:
        return str(self._get(section, name))

    def opt_int(self, section: str, name: str, default: int) -> int:
        try:
            return self.get_int(section, name)
        except ParamError:
            return default

    def opt_float(self, section: str, name: str, default: float) -> float:
        try:
            return self.get_float(section, name)
        except ParamError:
            return default

    def opt_string(self, section: str, name: str, default: str) -> str:
        try:
            return self.get_string(section, name)
        except ParamError:
            return default

    def has(self, section: str, name: Optional[str] = None) -> bool:
        if name is None:
            return section in self._data
        return section in self._data and name in self._data[section]

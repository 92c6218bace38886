"""SPH schemes: the reference's run-time scheme registry.

``SCHEMES`` maps the SPH:scheme names (the reference's
``models/sph/__init__.py``) to the scheme's params class, which takes the
common SPH: section keyword arguments.  Each scheme module declares its
protocol (``sphenix``'s docstring): ``NAME``, ``PARAMS`` and the rest;
its params object's ``mod`` property is the module itself.  The ported
modules are ``SCHEME_MODULES``; every other reference name raises, naming
the scheme.
"""

from . import anarchy_pu, eos, gadget2, kernels, minimal  # noqa: F401
from . import pressure_energy, sphenix

SCHEME_MODULES = {m.NAME: m for m in (sphenix, minimal, gadget2,
                                      pressure_energy, anarchy_pu)}

# the reference's other SPH:scheme names, still to port (ROADMAP.md)
UNPORTED_SCHEMES = ("pressure-energy-monaghan", "pressure-entropy",
                    "phantom", "gasoline", "none", "gizmo-mfm", "gizmo-mfv",
                    "planetary")


class _Registry(dict):
    """SPH:scheme -> params class; a reference name not ported yet
    raises."""

    def __getitem__(self, name):
        if name in UNPORTED_SCHEMES:
            raise NotImplementedError(
                f"SPH scheme {name!r} is not ported yet (ported: "
                f"{', '.join(SCHEME_MODULES)})")
        if name not in self:
            raise KeyError(f"unknown SPH scheme {name!r} (ported: "
                           f"{', '.join(SCHEME_MODULES)})")
        return dict.__getitem__(self, name)


SCHEMES = _Registry({n: m.PARAMS for n, m in SCHEME_MODULES.items()})


def scheme_name(p) -> str:
    """The SPH:scheme name of a ported params object."""
    return p.mod.NAME

"""SPH schemes: the reference's run-time scheme registry.

``SCHEMES`` maps the SPH:scheme names (the reference's
``models/sph/__init__.py``) to the scheme's params class, which takes the
common SPH: section keyword arguments.  Each scheme module declares its
protocol (``sphenix``'s docstring): ``NAME``, ``PARAMS`` and the rest;
its params object's ``mod`` property is the module itself.  The ported
modules are ``SCHEME_MODULES``: every scheme the reference runs on its
flat backend.  The two Gizmo schemes, which the reference runs on its xla
backend only, raise, naming the scheme.
"""

from . import anarchy_pu, eos, eos_tables, gadget2, gasoline  # noqa: F401
from . import kernels, minimal, none, phantom, planetary  # noqa: F401
from . import planetary_eos, pressure_energy  # noqa: F401
from . import pressure_energy_mm, pressure_entropy, sphenix

SCHEME_MODULES = {m.NAME: m for m in (
    sphenix, minimal, gadget2, pressure_energy, anarchy_pu,
    pressure_entropy, pressure_energy_mm, phantom, gasoline, none,
    planetary)}

# the reference's other SPH:scheme names, still to port (ROADMAP.md)
UNPORTED_SCHEMES = ("gizmo-mfm", "gizmo-mfv")


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


def u_is_entropy(p) -> bool:
    """Whether the scheme's u slot holds the entropic function A (its
    module then converts: ``entropy_from_internal_energy`` and
    ``internal_energy_from_entropy``)."""
    return hasattr(p.mod, "entropy_from_internal_energy")

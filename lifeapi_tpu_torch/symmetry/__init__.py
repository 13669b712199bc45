from . import groups, lattice, offsets, orbits, transforms  # noqa: F401
from .groups import StaticSymmetry  # noqa: F401
from .transforms import SymmetryTransform  # noqa: F401

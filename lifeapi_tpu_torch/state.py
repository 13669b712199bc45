"""LifeState: object wrapper giving the reference's familiar API surface
(reference LifeAPI.hpp:39-1382) over the functional packed-board core.

Counterpart of :class:`lifeapi_tpu.state.LifeState`.  Here it is a plain
class over one ``int64[..., 64]`` board tensor (``packed``), not a pytree.
All methods are pure and return new objects.  Heavy batched pipelines
should use the functional modules directly; this class is the ergonomic
entry point for users coming from the C++ LifeAPI.

The constructors build on the CUDA card unless given ``device="cpu"``
(or another device); asking for CUDA where there is none raises.  A state
made from a tensor stays on that tensor's device unless given another.
"""

from __future__ import annotations

from ._device import resolve
from .core import board as B
from .core import convolve as C
from .core import rle as R
from .core import step as S
from .core import strips as ST


def _device(device, like=()):
    """The constructors' device, by the port's one rule
    (:func:`lifeapi_tpu_torch._device.resolve`)."""
    return resolve(device, like, who="LifeState builds")


class LifeState:
    __slots__ = ("packed",)

    def __init__(self, packed=None, device=None):
        dev = _device(device, like=(packed,))
        self.packed = B.empty(device=dev) if packed is None else packed.to(dev)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def parse(rle_str, dx=0, dy=0, transform=None, device=None):
        st = LifeState(R.parse(rle_str, device=_device(device)))
        if transform is not None:
            st = st.moved(dx, dy).transformed(transform)
        elif dx or dy:
            st = st.moved(dx, dy)
        return st

    @staticmethod
    def cell(xy, device=None):
        return LifeState(B.cell_mask(*xy, device=_device(device)))

    @staticmethod
    def random(generator, batch=(), p=0.5, device=None):
        return LifeState(B.random(generator, batch, p, device=_device(device)))

    @staticmethod
    def checkerboard(device=None):
        return LifeState(B.checkerboard(device=_device(device)))

    @staticmethod
    def solid_rect(x, y, w, h, device=None):
        return LifeState(B.solid_rect(x, y, w, h, device=_device(device)))

    @staticmethod
    def solid_rect_xy(x1, y1, x2, y2, device=None):
        return LifeState(B.solid_rect_xy(x1, y1, x2, y2, device=_device(device)))

    @staticmethod
    def nzoi_around(cell, distance, device=None):
        return LifeState(B.nzoi_around(cell, distance, device=_device(device)))

    @staticmethod
    def from_cells(cells, device=None):
        return LifeState(B.from_cells(cells, device=_device(device)))

    # -- dunder algebra ----------------------------------------------------
    def __and__(self, o):
        return LifeState(self.packed & o.packed)

    def __or__(self, o):
        return LifeState(self.packed | o.packed)

    def __xor__(self, o):
        return LifeState(self.packed ^ o.packed)

    def __invert__(self):
        return LifeState(~self.packed)

    def __eq__(self, o):
        return B.equal(self.packed, o.packed)

    __hash__ = None

    def __repr__(self):
        pop = int(self.population) if self.packed.dim() == 1 else "..."
        return f"LifeState(pop={pop})"

    # -- cells -------------------------------------------------------------
    def get(self, x, y):
        return B.get_cell(self.packed, x, y)

    def set(self, x, y, val=True):
        return LifeState(B.set_cell(self.packed, x, y, val))

    def erase(self, x, y):
        return self.set(x, y, False)

    def get_safe(self, x, y):
        return self.get(B.torus_wrap(x), B.torus_wrap(y))

    # -- queries -----------------------------------------------------------
    @property
    def is_empty(self):
        return B.is_empty(self.packed)

    @property
    def population(self):
        return B.population(self.packed)

    def first_on(self):
        return B.first_on(self.packed)

    def find_set_neighbour(self, cell):
        return B.find_set_neighbour(self.packed, cell)

    def on_cells(self):
        return B.on_cells(self.packed)

    def xy_bounds(self):
        return B.xy_bounds(self.packed)

    def width_height(self):
        return B.width_height(self.packed)

    def populated_columns(self):
        return B.populated_columns(self.packed)

    def contains(self, other, dx=0, dy=0):
        from . import target as T

        if isinstance(other, T.LifeTarget):
            if dx or dy:
                return T.contains_moved(self.packed, other, dx, dy)
            return T.contains(self.packed, other)
        if dx or dy:
            return B.contains_moved(self.packed, other.packed, dx, dy)
        return B.contains(self.packed, other.packed)

    def are_disjoint(self, other, dx=0, dy=0):
        if dx or dy:
            return B.are_disjoint_moved(self.packed, other.packed, dx, dy)
        return B.are_disjoint(self.packed, other.packed)

    # -- transforms --------------------------------------------------------
    def moved(self, dx, dy):
        return LifeState(B.move(self.packed, dx, dy))

    def flip_x(self):
        return LifeState(B.flip_x(self.packed))

    def flip_y(self):
        return LifeState(B.flip_y(self.packed))

    def transposed(self, which_diagonal=True):
        return LifeState(B.transpose(self.packed, which_diagonal))

    def mirrored(self):
        return LifeState(B.mirrored(self.packed))

    def transformed(self, t):
        from .symmetry import transforms as TR

        return LifeState(TR.transform(self.packed, t))

    def align_with(self, other):
        return LifeState(C.align_with(self.packed, other.packed))

    def halve(self):
        from .symmetry import lattice

        return LifeState(lattice.halve(self.packed))

    def skew(self):
        from .symmetry import lattice

        return LifeState(lattice.skew(self.packed))

    def inv_skew(self):
        from .symmetry import lattice

        return LifeState(lattice.inv_skew(self.packed))

    # -- ZOI ---------------------------------------------------------------
    def zoi(self):
        return LifeState(B.zoi(self.packed))

    def zoi_hollow(self):
        return LifeState(B.zoi_hollow(self.packed))

    def moore_zoi(self):
        return LifeState(B.moore_zoi(self.packed))

    def big_zoi(self):
        return LifeState(B.big_zoi(self.packed))

    def get_boundary(self):
        return LifeState(B.boundary(self.packed))

    def nzoi(self, distance):
        return LifeState(B.nzoi(self.packed, distance))

    def buffer_around(self, size_wh):
        return LifeState(B.buffer_around(self.packed, size_wh))

    # -- stepping ----------------------------------------------------------
    def stepped(self, n=1):
        if n == 1:
            return LifeState(S.step(self.packed))
        return LifeState(S.step_n(self.packed, n))

    def stepped_alt(self):
        return LifeState(S.step_alt(self.packed))

    def step_for(self, cell):
        return S.step_for_cell(self.packed, *cell)

    def count_neighbours(self, cell):
        center = B.get_cell(self.packed, *cell)
        counts = S.count_planes_to_int(*S.neighbour_counts(self.packed))
        return counts[..., cell[0], cell[1]] - center.to(counts.dtype)

    def interaction_counts(self):
        o1, o2, om = S.interaction_counts(self.packed)
        return LifeState(o1), LifeState(o2), LifeState(om)

    def interaction_offsets(self, other):
        return LifeState(C.interaction_offsets(self.packed, other.packed))

    # -- matching ----------------------------------------------------------
    def convolve(self, other, method=None):
        """OR-convolution (reference ``Convolve``).  ``method`` selects a
        route of :func:`lifeapi_tpu_torch.core.convolve.convolve`
        (``"sparse"`` peels the sparser operand); every route is exact."""
        return LifeState(C.convolve(self.packed, other.packed, method=method))

    def match_live(self, live):
        return LifeState(C.match_live(self.packed, live.packed))

    def match_live_and_dead(self, live, dead):
        return LifeState(C.match_live_and_dead(self.packed, live.packed, dead.packed))

    def match(self, other):
        from . import target as T

        if isinstance(other, T.LifeTarget):
            return LifeState(T.match(self.packed, other))
        return LifeState(C.match(self.packed, other.packed))

    def component_containing(self, seed=None, corona=None):
        if seed is None:
            x, y = self.first_on().tolist()
            seed = B.cell_mask(x, y, device=self.packed.device)
        else:
            seed = seed.packed
        return LifeState(C.component_containing(self.packed, seed, corona))

    def components(self, corona=None):
        return [LifeState(c) for c in C.components(self.packed, corona)]

    # -- strips/patches ----------------------------------------------------
    def get_strip(self, column, width=ST.STRIP_WIDTH):
        return ST.get_strip(self.packed, column, width)

    def set_strip(self, column, value):
        return LifeState(ST.set_strip(self.packed, column, value))

    def get_patch(self, cell, radius):
        return ST.get_patch(self.packed, cell, radius)

    def set_patch(self, cell, radius, value):
        return LifeState(ST.set_patch(self.packed, cell, radius, value))

    # -- hashing / orbits --------------------------------------------------
    def get_hash(self):
        from .symmetry import orbits

        return orbits.board_hash(self.packed)

    def get_octo_hash(self):
        from .symmetry import orbits

        return orbits.octo_hash(self.packed)

    def symmetry_orbit(self):
        from .symmetry import orbits

        return [LifeState(b) for b in orbits.symmetry_orbit(self.packed)]

    def symmetry_orbit_representatives(self):
        from .symmetry import orbits

        return orbits.symmetry_orbit_representatives(self.packed)

    # -- I/O ---------------------------------------------------------------
    def rle(self):
        return R.to_rle(self.packed)

    def print_grid(self):
        print(R.format_grid(B.to_dense(self.packed).cpu().numpy()))

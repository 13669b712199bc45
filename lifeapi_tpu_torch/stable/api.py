"""LifeStable: object wrapper with the reference's method surface
(reference LifeStable.hpp:39-215) over the batched dense solver state.

Counterpart of :mod:`lifeapi_tpu.stable.api`, as a plain class.  Boards are
``int64[..., 64]``; methods that take cells accept a board or a dense bool
mask.
"""

from __future__ import annotations

import torch

from ..core import board as B
from . import complete as C
from . import host as HO
from . import options as opt
from . import propagate as P


def _dense(cells):
    return B.to_dense(cells) if cells.dtype == torch.int64 else cells


class LifeStable:
    __slots__ = ("data",)

    def __init__(self, data: P.Stable = None):
        self.data = P.make() if data is None else data

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_boards(state=None, unknown=None, batch=(), device=None):
        """state/unknown: int64 boards or dense masks."""
        return LifeStable(P.make(state=state, unknown=unknown, batch=batch, device=device))

    # -- plane views (the reference stores inverted bit planes,
    #    LifeStable.hpp:44-53) ---------------------------------------------
    @property
    def state(self):
        return B.from_dense(self.data.state)

    @property
    def unknown(self):
        return B.from_dense(self.data.unknown)

    def plane(self, name):
        """The 'ruled out' plane of an option name (live2, live3, dead0...)
        as a board."""
        return B.from_dense((self.data.ruled & getattr(opt, name.upper())) != 0)

    # -- cell ops ----------------------------------------------------------
    def get_options(self, cell):
        return P.get_options(self.data, *cell)

    def singleton_options(self, cell):
        """Reference ``SingletonOptions`` (LifeStable.hpp:93-96)."""
        return opt.is_singleton(int(self.get_options(cell)))

    def restrict_options(self, cells, options_mask):
        return LifeStable(P.restrict_cells(self.data, _dense(cells), options_mask))

    def set_on(self, which):
        return LifeStable(P.set_on(self.data, _dense(which)))

    def set_off(self, which):
        return LifeStable(P.set_off(self.data, _dense(which)))

    def set_cell_on(self, cell):
        return LifeStable(P.set_cell_on(self.data, *cell))

    def set_cell_off(self, cell):
        return LifeStable(P.set_cell_off(self.data, *cell))

    # -- lattice -----------------------------------------------------------
    def join(self, other):
        return LifeStable(P.join(self.data, other.data))

    def graft(self, other):
        return LifeStable(P.graft(self.data, other.data))

    def clear_unmodified(self):
        return LifeStable(P.clear_unmodified(self.data))

    def differences(self, other):
        return B.from_dense(P.differences(self.data, other.data))

    def compatible_with(self, other):
        if isinstance(other, LifeStable):
            return P.compatible_with(self.data, other.data)
        return P.compatible_with_state(self.data, other)

    def moved(self, dx, dy):
        shift = (dx % 64, dy % 64)
        return LifeStable(P.Stable(*(torch.roll(a, shift, dims=(-2, -1)) for a in self.data)))

    def transformed(self, t):
        from ..symmetry import transforms as TR

        return LifeStable(P.Stable(*(TR.transform_dense(a, t) for a in self.data)))

    # -- propagation -------------------------------------------------------
    def _wrap(self, res):
        return LifeStable(res.stable), res.consistent, res.changed

    def propagate(self):
        return self._wrap(P.propagate(self.data))

    def propagate_simple(self):
        return self._wrap(P.propagate_simple(self.data))

    def stabilise_options(self):
        return self._wrap(P.stabilise_options(self.data))

    def perturbed_unknowns(self):
        return B.from_dense(P.perturbed_unknowns(self.data))

    def vulnerable(self):
        return B.from_dense(P.vulnerable(self.data))

    def propagate_and_test(self, max_cells=16):
        """Reference ``PropagateAndTest`` (LifeStable.hpp:163-184)."""
        return self._wrap(P.propagate_and_test(self.data, max_cells=max_cells))

    def test_unknowns(self, cells):
        return self._wrap(P.test_cells(self.data, _dense(cells)))

    # -- search ------------------------------------------------------------
    def complete_stable(self, timeout=1.0, minimise=False, use_seed=False, seed=None):
        """Single-board host DFS (reference CompleteStable contract).
        Returns (CompletionResult, int64[64] best still life)."""
        d = self.data
        assert d.state.dim() == 2, "use complete_stable_beam for batches"
        hst = HO.HostStable(d.state.cpu().numpy(), d.unknown.cpu().numpy(),
                            d.ruled.cpu().numpy())
        seed_np = None if seed is None else B.to_dense(seed).cpu().numpy()
        result, best = C.complete_stable(hst, timeout=timeout, minimise=minimise,
                                         use_seed=use_seed, seed=seed_np)
        return result, B.from_dense(torch.from_numpy(best)).to(d.state.device)

    def complete_stable_beam(self, frontier=8, iters=192, minimise=True, seed=None):
        """Batched beam completion; data must have a leading batch.
        ``seed`` (a board) enables the reference's useSeed proximity
        branching."""
        return C.complete_stable_beam(self.data, frontier=frontier, iters=iters,
                                      minimise=minimise, seed=seed)

    def complete_stable_portfolio(self, generator, replicas=256, frontier=4, iters=192,
                                  minimise=True):
        """Single hard instance -> orbit-randomized beam replica portfolio
        (:func:`lifeapi_tpu_torch.stable.complete.complete_stable_portfolio`)."""
        d = self.data
        assert d.state.dim() == 2, "portfolio searches ONE instance"
        return C.complete_stable_portfolio(
            B.from_dense(d.state), B.from_dense(d.unknown), generator,
            replicas=replicas, frontier=frontier, iters=iters, minimise=minimise)

    # -- I/O ---------------------------------------------------------------
    def rle(self):
        return P.to_rle(self.data)

    def rle_with_header(self):
        return P.to_rle_with_header(self.data)

    def sanity_check(self):
        from ..utils import debug

        debug.assert_stable_invariants(self.data)

"""Pure-NumPy mirror of the stable propagation kernels.

Carried over unchanged from :mod:`lifeapi_tpu.stable.host`.  Used by the
host-side DFS completer (complete.py) and as an independent implementation
for differential tests against the bit-plane path.  Shares the LUTs of
options.py; single board, dense [64, 64] arrays.
"""

from __future__ import annotations

import numpy as np

from . import options as opt

N = 64


def count9(x):
    x = x.astype(np.int32)
    v = x + np.roll(x, 1, axis=1) + np.roll(x, -1, axis=1)
    return v + np.roll(v, 1, axis=0) + np.roll(v, -1, axis=0)


def zoi(x):
    v = x | np.roll(x, 1, axis=1) | np.roll(x, -1, axis=1)
    return v | np.roll(v, 1, axis=0) | np.roll(v, -1, axis=0)


def big_zoi(x):
    """Reference ``BigZOI`` dilation (LifeAPI.hpp:564-591): plus-dilate,
    then horizontal 3-dilate, then vertical 3-dilate."""
    b = (x | np.roll(x, 1, axis=1) | np.roll(x, -1, axis=1)
         | np.roll(x, 1, axis=0) | np.roll(x, -1, axis=0))
    c = b | np.roll(b, 1, axis=0) | np.roll(b, -1, axis=0)
    return c | np.roll(c, 1, axis=1) | np.roll(c, -1, axis=1)


def zoi_hollow(x):
    v = x | np.roll(x, 1, axis=1) | np.roll(x, -1, axis=1)
    mid = np.roll(x, 1, axis=1) | np.roll(x, -1, axis=1)
    return np.roll(v, 1, axis=0) | np.roll(v, -1, axis=0) | mid


class HostStable:
    """Mutable host-side mirror of propagate.Stable.

    ``propagate`` is WINDOWED after the first full fixpoint (the
    counterpart of the reference's strip kernels, LifeStable.hpp:731-1249,
    which its DFS uses to re-propagate only the perturbed strip): once a
    board has been fully propagated, subsequent propagates run on the
    bounding window of (unknown cells | cells dirtied via set_on/set_off)
    + 2 margin, which is sound because state changes only occur at
    unknown cells, ruled changes within 1 cell of them, and signals only
    affect unknown cells.  Mutating fields directly on an
    already-propagated board requires :meth:`invalidate` first.
    """

    __slots__ = ("state", "unknown", "ruled", "_full_done", "_dirty")

    def __init__(self, state=None, unknown=None, ruled=None):
        self.state = np.zeros((N, N), bool) if state is None else state.astype(bool).copy()
        self.unknown = np.zeros((N, N), bool) if unknown is None else unknown.astype(bool).copy()
        if self.state.any():
            self.unknown &= ~self.state
        self.ruled = (
            np.zeros((N, N), np.uint8) if ruled is None else ruled.astype(np.uint8).copy()
        )
        self._full_done = False
        self._dirty = None  # (x0, x1, y0, y1) exclusive-end bbox or None

    def copy(self):
        out = HostStable(self.state, self.unknown, self.ruled)
        out._full_done = self._full_done
        out._dirty = self._dirty
        return out

    def invalidate(self):
        """Call after mutating fields directly: forces the next
        ``propagate`` to run the full-board fixpoint."""
        self._full_done = False
        self._dirty = None

    def _mark_dirty(self, cells):
        xs, ys = np.nonzero(cells)
        if len(xs) == 0:
            return
        box = (int(xs.min()), int(xs.max()) + 1,
               int(ys.min()), int(ys.max()) + 1)
        if self._dirty is None:
            self._dirty = box
        else:
            a = self._dirty
            self._dirty = (min(a[0], box[0]), max(a[1], box[1]),
                           min(a[2], box[2]), max(a[3], box[3]))

    def center_code(self):
        return np.where(self.unknown, opt.UNKNOWN, self.state.astype(np.int32))

    def set_on(self, cells):
        self.state |= cells
        self.unknown &= ~cells
        self.ruled[cells] |= opt.DEAD_MASK
        self._mark_dirty(cells)

    def set_off(self, cells):
        self.state &= ~cells
        self.unknown &= ~cells
        self.ruled[cells] |= opt.LIVE_MASK
        self._mark_dirty(cells)

    # -- kernels (mirror propagate.py; reference LifeStable.hpp:526-729) ---

    def synchronise_state_known(self):
        known_on = ~self.unknown & self.state
        known_off = ~self.unknown & ~self.state
        maybe_dead_b = (self.ruled & opt.DEAD_MASK) != opt.DEAD_MASK
        maybe_live_b = (self.ruled & opt.LIVE_MASK) != opt.LIVE_MASK
        changes = (maybe_dead_b & known_on) | (maybe_live_b & known_off)
        self.ruled[known_on] |= opt.DEAD_MASK
        self.ruled[known_off] |= opt.LIVE_MASK
        maybe_dead = (self.ruled & opt.DEAD_MASK) != opt.DEAD_MASK
        maybe_live = (self.ruled & opt.LIVE_MASK) != opt.LIVE_MASK
        if (~maybe_live & ~maybe_dead).any():
            return False, False
        forced_on = maybe_live & ~maybe_dead
        changes |= ~self.state & forced_on
        self.state |= forced_on
        still_unknown = maybe_live & maybe_dead
        changes |= self.unknown & ~still_unknown
        self.unknown &= still_unknown
        return True, bool(changes.any())

    def update_options(self):
        lut = opt.update_lut()
        out = lut[self.center_code(), count9(self.state), count9(self.unknown)]
        add = (out & 0xFF).astype(np.uint8)
        if ((out >> 8) != 0).any():
            return False, False
        changed = bool((add & ~self.ruled).any())
        self.ruled |= add
        return True, changed

    def signal_neighbours(self):
        lut = opt.signal_lut()
        on9 = count9(self.state)
        m9 = count9(self.state | self.unknown)
        bits = lut[self.center_code(), self.ruled.astype(np.int32), on9, m9]
        off_zoi = zoi_hollow((bits & 2) != 0) | ((bits & 8) != 0)
        on_zoi = zoi_hollow((bits & 1) != 0) | ((bits & 4) != 0)
        if (off_zoi & on_zoi & self.unknown).any():
            return False, False
        changes = bool(((off_zoi | on_zoi) & self.unknown).any())
        self.set_off(off_zoi & self.unknown)
        self.set_on(on_zoi & self.unknown)
        return True, changes

    def propagate_step(self):
        ok, c1 = self.synchronise_state_known()
        if not ok:
            return False, False
        ok, c2 = self.update_options()
        if not ok:
            return False, False
        ok, c3 = self.signal_neighbours()
        if not ok:
            return False, False
        return True, c1 | c2 | c3

    def propagate(self):
        if self._full_done:
            win = self._window()
            if win is not None:
                return self._propagate_window(*win)
        ever = False
        while True:
            ok, changed = self.propagate_step()
            if not ok:
                return False, False
            if not changed:
                self._full_done = True
                self._dirty = None
                return True, ever
            ever = True

    def _window(self):
        """(xs, ys) slice pair covering bbox(unknown | dirty) + 2, or
        None when the window would wrap the torus edge (fall back to the
        full fixpoint)."""
        xs, ys = np.nonzero(self.unknown)
        if self._dirty is None:
            if len(xs) == 0:
                return slice(0, 0), slice(0, 0)  # nothing can change
            box = (int(xs.min()), int(xs.max()) + 1,
                   int(ys.min()), int(ys.max()) + 1)
        else:
            d = self._dirty
            if len(xs) == 0:
                box = d
            else:
                box = (min(d[0], int(xs.min())),
                       max(d[1], int(xs.max()) + 1),
                       min(d[2], int(ys.min())),
                       max(d[3], int(ys.max()) + 1))
        x0, x1, y0, y1 = box
        if x0 < 2 or y0 < 2 or x1 > N - 2 or y1 > N - 2:
            return None  # touching the torus seam: full propagate
        return slice(x0 - 2, x1 + 2), slice(y0 - 2, y1 + 2)

    def _propagate_window(self, xs, ys):
        """Fixpoint restricted to window VIEWS: torus rolls inside the
        window corrupt only its outer ring, whose deductions are masked
        off (class docstring has the soundness argument)."""
        if xs.stop == xs.start:
            self._dirty = None
            return True, False
        st = self.state[xs, ys]
        un = self.unknown[xs, ys]
        rl = self.ruled[xs, ys]
        interior = np.zeros(st.shape, bool)
        interior[1:-1, 1:-1] = True
        update_lut = opt.update_lut()
        signal_lut = opt.signal_lut()

        ever = False
        while True:
            changed = False
            # synchronise (per-cell; ring cells are settled no-ops)
            known_on = ~un & st
            known_off = ~un & ~st
            maybe_dead_b = (rl & opt.DEAD_MASK) != opt.DEAD_MASK
            maybe_live_b = (rl & opt.LIVE_MASK) != opt.LIVE_MASK
            ch = (maybe_dead_b & known_on) | (maybe_live_b & known_off)
            rl[known_on] |= opt.DEAD_MASK
            rl[known_off] |= opt.LIVE_MASK
            maybe_dead = (rl & opt.DEAD_MASK) != opt.DEAD_MASK
            maybe_live = (rl & opt.LIVE_MASK) != opt.LIVE_MASK
            if (~maybe_live & ~maybe_dead).any():
                return False, False
            forced_on = maybe_live & ~maybe_dead
            ch |= ~st & forced_on
            st |= forced_on
            still_unknown = maybe_live & maybe_dead
            ch |= un & ~still_unknown
            un &= still_unknown
            changed |= bool(ch.any())

            # update options (counts valid on the interior only)
            code = np.where(un, opt.UNKNOWN, st.astype(np.int32))
            out = update_lut[code, count9(st), count9(un)]
            if (((out >> 8) != 0) & interior).any():
                return False, False
            add = (out & 0xFF).astype(np.uint8)
            add[~interior] = 0
            changed |= bool((add & ~rl).any())
            rl |= add

            # signal neighbours (bits masked to the interior)
            code = np.where(un, opt.UNKNOWN, st.astype(np.int32))
            on9 = count9(st)
            m9 = count9(st | un)
            bits = signal_lut[code, rl.astype(np.int32), on9, m9]
            bits[~interior] = 0
            off_zoi = zoi_hollow((bits & 2) != 0) | ((bits & 8) != 0)
            on_zoi = zoi_hollow((bits & 1) != 0) | ((bits & 4) != 0)
            if (off_zoi & on_zoi & un).any():
                return False, False
            sig_off = off_zoi & un
            sig_on = on_zoi & un
            changed |= bool((sig_off | sig_on).any())
            st &= ~sig_off
            un &= ~sig_off
            rl[sig_off] |= opt.LIVE_MASK
            st |= sig_on
            un &= ~sig_on
            rl[sig_on] |= opt.DEAD_MASK

            if not changed:
                self._dirty = None
                return True, ever
            ever = True

    def perturbed_unknowns(self):
        return (self.ruled != 0) & self.unknown

    def vulnerable(self):
        lut = opt.vulnerable_lut()
        bits = lut[
            self.ruled.astype(np.int32), count9(self.state), count9(self.unknown)
        ]
        on = zoi_hollow((bits & 1) != 0) | ((bits & 4) != 0)
        off = zoi_hollow((bits & 2) != 0) | ((bits & 8) != 0)
        return on & off

    def vulnerable_win(self, xs, ys):
        """``vulnerable`` evaluated on the window views only — valid for
        cells at distance >= 2 from the window edge (the DFS queries it
        on settable cells, which live in the window's bbox interior)."""
        lut = opt.vulnerable_lut()
        st = self.state[xs, ys]
        un = self.unknown[xs, ys]
        bits = lut[self.ruled[xs, ys].astype(np.int32), count9(st),
                   count9(un)]
        on = zoi_hollow((bits & 1) != 0) | ((bits & 4) != 0)
        off = zoi_hollow((bits & 2) != 0) | ((bits & 8) != 0)
        return on & off

    def query_window(self):
        """Window slices for branch-cell queries (same bbox+2 window as
        the windowed propagate), or None when unavailable (never fully
        propagated, or the window touches the torus seam)."""
        if not self._full_done:
            return None
        return self._window()

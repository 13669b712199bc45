"""Batched still-life constraint propagation (AC-style fixpoint), dense.

Counterpart of :mod:`lifeapi_tpu.stable.propagate` (the reference
``LifeStable`` propagation stack, LifeStable.hpp:39-729).  Per cell a bool
``state`` (known ON), a bool ``unknown`` and a uint8 ``ruled`` options mask
(bit set = option ruled out, the reference's inverted planes,
LifeStable.hpp:44-53) over ``[..., 64, 64]`` grids indexed ``[x, y]``.
Neighbour counts come from 3x3 rolled sums; the per-cell rules are the
closed-form interval rules of :mod:`lifeapi_tpu_torch.stable.rules_vec`.
The fixpoints are Python loops with per-board convergence and consistency
masks, so many independent problems propagate in lockstep; each iteration
reads one flag back to test whether any board is still active.

This is plain PyTorch on whatever device the tensors are on.  The beam
search packs a dense :class:`Stable` into bit planes
(:func:`lifeapi_tpu_torch.stable.bitplane.from_dense_stable`) and runs the
packed kernels of :mod:`lifeapi_tpu_torch.ops.stable_cuda`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve
from ..core import board as board_mod
from . import options as opt
from . import rules_vec

N = 64
U8 = torch.uint8


class Stable(NamedTuple):
    """Batched partial still-life (reference ``LifeStable``,
    LifeStable.hpp:39-53)."""

    state: torch.Tensor  # bool[..., 64, 64] known ON
    unknown: torch.Tensor  # bool[..., 64, 64]
    ruled: torch.Tensor  # uint8[..., 64, 64] options ruled out

    @property
    def batch_shape(self):
        return self.state.shape[:-2]


class PropagateResult(NamedTuple):
    """Per-board consistency/progress flags (reference
    LifeStable.hpp:123-126)."""

    stable: Stable
    consistent: torch.Tensor  # bool[...]
    changed: torch.Tensor  # bool[...]


def make(state=None, unknown=None, batch=(), device=None):
    """Fresh Stable; ``state``/``unknown`` may be int64 boards or dense.
    It is built on ``device``, else on the device of the given tensors,
    else on the CUDA card."""
    dev = resolve(device, like=(state, unknown))

    def to_dense(x):
        if x is None:
            return torch.zeros((*batch, N, N), dtype=torch.bool, device=dev)
        x = x.to(dev)
        if x.dtype == torch.int64:
            return board_mod.to_dense(x)
        return x.bool()

    s = to_dense(state)
    u = to_dense(unknown)
    shape = torch.broadcast_shapes(s.shape, u.shape)
    s = s.expand(shape)
    u = u.expand(shape) & ~s
    return Stable(s.clone(), u, torch.zeros(shape, dtype=U8, device=s.device))


def _any(mask):
    """bool[..., 64, 64] -> bool[...]: any cell set."""
    return mask.flatten(-2).any(dim=-1)


def count9(dense_bool):
    """3x3 window sum including the center, int32, torus."""
    x = dense_bool.to(torch.int32)
    v = x + torch.roll(x, 1, dims=-1) + torch.roll(x, -1, dims=-1)
    return v + torch.roll(v, 1, dims=-2) + torch.roll(v, -1, dims=-2)


def zoi_dense(dense_bool):
    x = dense_bool
    v = x | torch.roll(x, 1, dims=-1) | torch.roll(x, -1, dims=-1)
    return v | torch.roll(v, 1, dims=-2) | torch.roll(v, -1, dims=-2)


def zoi_hollow_dense(dense_bool):
    x = dense_bool
    mid = torch.roll(x, 1, dims=-1) | torch.roll(x, -1, dims=-1)
    v = x | mid
    return torch.roll(v, 1, dims=-2) | torch.roll(v, -1, dims=-2) | mid


def center_code(st: Stable):
    """Dense three-state code: 0=OFF, 1=ON, 2=UNKNOWN (int32)."""
    return torch.where(st.unknown, opt.UNKNOWN, st.state.to(torch.int32))


# ---------------------------------------------------------------------------
# Cell-level access (reference LifeStable.hpp:284-364)
# ---------------------------------------------------------------------------


def get_options(st: Stable, x, y):
    """Possible-options mask of one cell (reference ``GetOptions``)."""
    return ~st.ruled[..., x, y]


def _or_where(cells, ruled, bits):
    """``ruled | bits`` on the given cells, ``ruled`` elsewhere."""
    return torch.where(cells, ruled | bits, ruled)


def restrict_cells(st: Stable, cells, options_mask):
    """Rule out everything outside ``options_mask`` on the given cells
    (reference ``RestrictOptions(LifeState, StableOptions)``,
    LifeStable.hpp:308-318).  ``cells``: dense bool mask."""
    return st._replace(ruled=_or_where(cells, st.ruled, (~options_mask) & 0xFF))


def set_on(st: Stable, cells):
    """Force cells ON (reference ``SetOn``, LifeStable.hpp:320-329)."""
    return Stable(st.state | cells, st.unknown & ~cells,
                  _or_where(cells, st.ruled, opt.DEAD_MASK))


def set_off(st: Stable, cells):
    """Force cells OFF (reference ``SetOff``, LifeStable.hpp:330-335)."""
    return Stable(st.state & ~cells, st.unknown & ~cells,
                  _or_where(cells, st.ruled, opt.LIVE_MASK))


def set_cell_on(st: Stable, x, y):
    return set_on(st, _cell_mask(st, x, y))


def set_cell_off(st: Stable, x, y):
    return set_off(st, _cell_mask(st, x, y))


def _cell_mask(st: Stable, x, y):
    m = torch.zeros((N, N), dtype=torch.bool, device=st.state.device)
    m[x, y] = True
    return m.expand(st.state.shape)


# ---------------------------------------------------------------------------
# Lattice ops (reference LifeStable.hpp:217-282, :1461-1479)
# ---------------------------------------------------------------------------


def join(a: Stable, b: Stable):
    """Least upper bound: keeps only what both agree on (reference
    ``Join``, LifeStable.hpp:217-233)."""
    unknown = a.unknown | b.unknown | (a.state ^ b.state)
    return Stable(a.state & ~unknown, unknown, a.ruled & b.ruled)


def graft(a: Stable, b: Stable):
    """Overlay b's decided region onto a (reference ``Graft``,
    LifeStable.hpp:235-251): cells where b has DEAD0 ruled out carry b's
    constraints."""
    modified = (b.ruled & opt.DEAD0) != 0
    unknown = a.unknown & ~(~b.unknown & modified)
    ruled = a.ruled | torch.where(modified, b.ruled, 0).to(U8)
    return Stable(a.state | b.state, unknown, ruled)


def clear_unmodified(st: Stable):
    """Drop unknown cells far from any decided region (reference
    ``ClearUnmodified``, LifeStable.hpp:253-264)."""
    modified_zoi = zoi_dense((st.ruled & opt.DEAD0) != 0)
    out = Stable(st.state, st.unknown & modified_zoi, st.ruled)
    return update_options(out).stable


def differences(a: Stable, b: Stable):
    """Dense mask of any differing plane (reference ``Differences``,
    LifeStable.hpp:266-282)."""
    return (a.state ^ b.state) | (a.unknown ^ b.unknown) | (a.ruled != b.ruled)


def equal(a: Stable, b: Stable):
    return ~_any(differences(a, b))


def compatible_with(a: Stable, b: Stable):
    """Reference ``CompatibleWith`` (LifeStable.hpp:1468-1479)."""
    bad = (a.ruled & ~b.ruled) != 0
    bad = bad | (~a.unknown & ~b.unknown & (a.state ^ b.state))
    return ~_any(bad)


def compatible_with_state(a: Stable, desired_state):
    """Reference LifeStable.hpp:1461-1466."""
    d = make(state=desired_state, batch=a.batch_shape, device=a.state.device)
    d = stabilise_options(d).stable
    return compatible_with(a, d)


# ---------------------------------------------------------------------------
# Propagation rules
# ---------------------------------------------------------------------------


def synchronise_state_known(st: Stable):
    """Reconcile the option planes with state/unknown (reference
    ``SynchroniseStateKnown``, LifeStable.hpp:526-556)."""
    known_on = ~st.unknown & st.state
    known_off = ~st.unknown & ~st.state
    ruled = st.ruled
    maybe_dead_before = (ruled & opt.DEAD_MASK) != opt.DEAD_MASK
    maybe_live_before = (ruled & opt.LIVE_MASK) != opt.LIVE_MASK
    changes = (maybe_dead_before & known_on) | (maybe_live_before & known_off)

    ruled = _or_where(known_on, ruled, opt.DEAD_MASK)
    ruled = _or_where(known_off, ruled, opt.LIVE_MASK)

    maybe_dead = (ruled & opt.DEAD_MASK) != opt.DEAD_MASK
    maybe_live = (ruled & opt.LIVE_MASK) != opt.LIVE_MASK
    abort = _any(~maybe_live & ~maybe_dead)

    forced_on = maybe_live & ~maybe_dead
    changes = changes | (~st.state & forced_on)
    state = st.state | forced_on

    still_unknown = maybe_live & maybe_dead
    changes = changes | (st.unknown & ~still_unknown)
    unknown = st.unknown & still_unknown

    return PropagateResult(Stable(state, unknown, ruled), ~abort, _any(changes))


def update_options(st: Stable):
    """Prune per-cell options from ON / unknown counts (reference
    ``UpdateOptions``, LifeStable.hpp:558-615, netlist stable_count)."""
    add, abort_cells = rules_vec.update_bits(center_code(st), count9(st.state),
                                             count9(st.unknown))
    changed = _any((add & ~st.ruled) != 0)
    return PropagateResult(st._replace(ruled=st.ruled | add), ~_any(abort_cells), changed)


def signal_neighbours(st: Stable):
    """Broadcast forced values to unknown neighbours (reference
    ``SignalNeighbours``, LifeStable.hpp:617-675, netlist stable_signal)."""
    on9 = count9(st.state)
    m9 = count9(st.state | st.unknown)
    bits = rules_vec.signal_bits(center_code(st), st.ruled, on9, m9)
    sig_on = (bits & 1) != 0
    sig_off = (bits & 2) != 0
    cen_on = (bits & 4) != 0
    cen_off = (bits & 8) != 0

    off_zoi = zoi_hollow_dense(sig_off) | cen_off
    on_zoi = zoi_hollow_dense(sig_on) | cen_on

    abort = _any(off_zoi & on_zoi & st.unknown)
    changes = _any((off_zoi | on_zoi) & st.unknown)

    out = set_off(st, off_zoi & st.unknown)
    out = set_on(out, on_zoi & out.unknown)
    return PropagateResult(out, ~abort, changes)


def propagate_simple_step(st: Stable):
    """Cheap state/unknown-only rule (reference ``PropagateSimpleStep``,
    LifeStable.hpp:414-503, netlist stable_simple)."""
    bits = rules_vec.simple_bits(center_code(st), count9(st.state), count9(st.unknown))
    new_off = ((bits & 1) != 0) & st.unknown
    new_on = ((bits & 2) != 0) & st.unknown
    sig_off = (bits & 4) != 0
    sig_on = (bits & 8) != 0
    abort = _any((bits & 16) != 0)

    state = st.state | new_on
    unknown = st.unknown & ~new_on & ~new_off

    off_zoi = zoi_dense(sig_off)
    on_zoi = zoi_dense(sig_on)
    state = state | (on_zoi & unknown)
    unknown_after = unknown & ~off_zoi & ~on_zoi
    abort = abort | _any(off_zoi & on_zoi & unknown)

    changed = _any(unknown_after != st.unknown)
    return PropagateResult(Stable(state, unknown_after, st.ruled), ~abort, changed)


def _masked(old: Stable, new: Stable, active):
    """Apply ``new`` only on active boards (freeze finished/inconsistent)."""
    a = active[..., None, None]
    return Stable(torch.where(a, new.state, old.state),
                  torch.where(a, new.unknown, old.unknown),
                  torch.where(a, new.ruled, old.ruled))


def _fixpoint(step_fn, st: Stable, max_iters=256):
    """Run ``step_fn`` per board until no active board changes (reference
    fixpoint loops, e.g. LifeStable.hpp:718-729), with per-board masks: a
    step that finds a board inconsistent leaves that board as it was."""
    batch, dev = st.batch_shape, st.state.device
    consistent = torch.ones(batch, dtype=torch.bool, device=dev)
    changed_ever = torch.zeros(batch, dtype=torch.bool, device=dev)
    active = torch.ones(batch, dtype=torch.bool, device=dev)
    cur = st
    for _ in range(max_iters):
        if not bool(active.any()):
            break
        res = step_fn(cur)
        cur = _masked(cur, res.stable, active & res.consistent)
        consistent = consistent & (~active | res.consistent)
        changed_ever = changed_ever | (active & res.changed)
        active = active & res.consistent & res.changed
    return PropagateResult(cur, consistent, changed_ever)


def propagate_step(st: Stable):
    """One full propagation pass (reference ``PropagateStep``,
    LifeStable.hpp:695-716)."""
    r1 = synchronise_state_known(st)
    r2 = update_options(r1.stable)
    r3 = signal_neighbours(r2.stable)
    consistent = r1.consistent & r2.consistent & r3.consistent
    changed = r1.changed | r2.changed | r3.changed
    return PropagateResult(r3.stable, consistent, changed)


def propagate(st: Stable):
    """Fixpoint of propagate_step (reference ``Propagate``,
    LifeStable.hpp:718-729)."""
    return _fixpoint(propagate_step, st)


def _stabilise_step(cur: Stable):
    r1 = synchronise_state_known(cur)
    r2 = update_options(r1.stable)
    return PropagateResult(r2.stable, r1.consistent & r2.consistent, r1.changed | r2.changed)


def stabilise_options(st: Stable):
    """Fixpoint of synchronise+update (reference ``StabiliseOptions``,
    LifeStable.hpp:677-693)."""
    return _fixpoint(_stabilise_step, st)


def propagate_simple(st: Stable):
    """Fixpoint of the simple rule, then options stabilisation (reference
    ``PropagateSimple``, LifeStable.hpp:505-524)."""
    r = _fixpoint(propagate_simple_step, st)
    r2 = stabilise_options(r.stable)
    return PropagateResult(r2.stable, r.consistent & r2.consistent, r.changed)


def perturbed_unknowns(st: Stable):
    """Unknown cells with any option already ruled out (reference
    ``PerturbedUnknowns``, LifeStable.hpp:154-157)."""
    return (st.ruled != 0) & st.unknown


def vulnerable(st: Stable):
    """Branch-point heuristic mask (reference ``Vulnerable``,
    LifeStable.hpp:366-412, netlist stable_vulnerable)."""
    bits = rules_vec.vulnerable_bits(center_code(st), st.ruled, count9(st.state),
                                     count9(st.unknown))
    on = zoi_hollow_dense((bits & 1) != 0) | ((bits & 4) != 0)
    off = zoi_hollow_dense((bits & 2) != 0) | ((bits & 8) != 0)
    return on & off


# ---------------------------------------------------------------------------
# Lookahead (reference LifeStable.hpp:1251-1338)
# ---------------------------------------------------------------------------


def test_cells(st: Stable, cell_mask):
    """Try ON and OFF for one cell per board (dense one-hot ``cell_mask``),
    propagate each, keep the forced branch or the join (reference
    ``TestUnknown``, LifeStable.hpp:1251-1284, using full propagation as in
    the commented-out whole-board variant at :1286-1319)."""
    on_r = propagate(set_on(st, cell_mask))
    off_r = propagate(set_off(st, cell_mask))

    both = on_r.consistent & off_r.consistent
    only_on = on_r.consistent & ~off_r.consistent
    only_off = ~on_r.consistent & off_r.consistent
    neither = ~on_r.consistent & ~off_r.consistent

    joined = join(on_r.stable, off_r.stable)
    m_on, m_off, m_j = (s[..., None, None] for s in (only_on, only_off, both))

    def pick(a, b, c, orig):
        return torch.where(m_on, a, torch.where(m_off, b, torch.where(m_j, c, orig)))

    out = Stable(*(pick(a, b, c, o) for a, b, c, o in
                   zip(on_r.stable, off_r.stable, joined, st)))
    changed = only_on | only_off | (both & _any(differences(joined, st)))
    return PropagateResult(out, ~neither, changed)


def _first_cell_mask(dense_mask):
    """One-hot [..., 64, 64] of the lexicographically first set cell per
    board (all-zero when the mask is empty).  ``argmax`` of the uint8 view
    returns the first maximum, as JAX's does."""
    flat = dense_mask.flatten(-2).to(U8)
    idx = flat.argmax(dim=-1, keepdim=True)
    onehot = torch.zeros_like(flat, dtype=torch.bool).scatter_(-1, idx, True)
    return onehot.view(dense_mask.shape) & dense_mask


def propagate_and_test(st: Stable, max_cells=16):
    """Alternate full propagation with lookahead on vulnerable cells until
    nothing changes (reference ``PropagateAndTest``, LifeStable.hpp:163-184;
    the reference tests every cell of Vulnerable().ZOI(), here a bounded
    number of cells per board per round, batched)."""
    res = propagate(st)
    cur, consistent, changed_ever = res.stable, res.consistent, res.changed
    active = consistent.clone()
    for _ in range(max_cells):
        if not bool(active.any()):
            break
        cell = _first_cell_mask(vulnerable(cur) & cur.unknown)
        has_cell = _any(cell)
        res = test_cells(cur, cell & active[..., None, None])
        cur = _masked(cur, res.stable, active & has_cell & res.consistent)
        consistent = consistent & (~active | res.consistent)
        changed_now = active & has_cell & res.changed
        changed_ever = changed_ever | changed_now
        active = active & res.consistent & changed_now
    return PropagateResult(cur, consistent, changed_ever)


# ---------------------------------------------------------------------------
# I/O (reference LifeStable.hpp:196-202, :1481-1487)
# ---------------------------------------------------------------------------


def to_rle(st: Stable):
    """LifeBellman RLE: 'C' = ON, 'E' = unknown, '.' = OFF (reference
    LifeStable.hpp:1481-1487).  Single board only."""
    import numpy as np

    from ..core import rle as rle_mod

    s = st.state.cpu().numpy()
    u = st.unknown.cpu().numpy()
    table = np.array([".", "A", "E", "C"])
    idx = s.astype(int) + ((s | u).astype(int) << 1)
    return rle_mod.write_rle_planes(lambda x, y: table[idx[x, y]])


def to_rle_with_header(st: Stable):
    return "x = 0, y = 0, rule = LifeBellman\n" + to_rle(st)

"""Bit-sliced still-life constraint propagation on int64 board planes.

Counterpart of :mod:`lifeapi_tpu.stable.bitplane`, all of it: the
propagation, the three-state (ternary) steps over a stable background that
:mod:`lifeapi_tpu_torch.mpc.reachability` rolls, and the
``Vulnerable``/branch-priority part.  The 10-plane layout of the reference
``LifeStable`` (state, unknown, 8 inverted option planes,
LifeStable.hpp:39-53), each plane a port board ``int64[..., 64]``, with the
espresso netlists replaced by the interval-comparator circuits of
:mod:`lifeapi_tpu_torch.stable.nibble`.  Every circuit is the JAX
package's, gate for gate, so results are bit-exact with it.

Key algebraic simplification (vs the literal new_signal_function): with
A = known-ON neighbours, U = unknown neighbours, and [mo, Mo] the possible
neighbour-count interval of the cell's options mask, the neighbour forcing
conditions reduce to exact end-point equalities:
    signal OFF  <=>  Mo == A        (only the minimum count is reachable)
    signal ON   <=>  mo == A + U    (only the maximum count is reachable)
under the guards (U > 0, options nonempty, o|maximal(n) consistent, no
three-state conflict).

The fused CUDA kernels (:mod:`lifeapi_tpu_torch.ops.stable_cuda`) hold the
10 planes of a board as one ``int64[..., 10, 64]`` tensor;
:func:`to_planes` and :func:`from_planes` convert.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve
from ..core import board as B
from ..core import step as S
from . import nibble as nb
from . import options as opt

# option order: index -> (ruled-plane name, neighbour count, is_live)
OPTIONS = (
    ("live2", 2, True),
    ("live3", 3, True),
    ("dead0", 0, False),
    ("dead1", 1, False),
    ("dead2", 2, False),
    ("dead4", 4, False),
    ("dead5", 5, False),
    ("dead6", 6, False),
)
OPTION_BITS = (opt.LIVE2, opt.LIVE3, opt.DEAD0, opt.DEAD1, opt.DEAD2, opt.DEAD4,
               opt.DEAD5, opt.DEAD6)

# count -> option indices, ascending count order (for min/max scans)
_BY_COUNT = ((2,), (3,), (0, 4), (1,), (5,), (6,), (7,))
_COUNT_VALS = (0, 1, 2, 3, 4, 5, 6)

N_PLANES = 10  # state, unknown, 8 ruled


class BitStable(NamedTuple):
    """Packed 10-plane partial still-life (reference layout)."""

    state: torch.Tensor  # int64[..., 64]
    unknown: torch.Tensor
    ruled: tuple  # 8 planes, OPTIONS order, 1 = ruled out

    @property
    def batch_shape(self):
        return self.state.shape[:-1]


class BitPropagateResult(NamedTuple):
    stable: BitStable
    consistent: torch.Tensor
    changed: torch.Tensor


def make(state=None, unknown=None, batch=(), device=None):
    """Fresh BitStable: nothing ruled out; a missing state or unknown is
    empty.  It is built on ``device``, else on the device of the given
    tensors, else on the CUDA card."""
    dev = resolve(device, like=(state, unknown))
    s = B.empty(batch, dev) if state is None else state.to(dev)
    u = B.empty(batch, dev) if unknown is None else unknown.to(dev)
    shape = torch.broadcast_shapes(s.shape, u.shape)
    s = s.expand(shape).clone()
    u = u.expand(shape) & ~s
    return BitStable(s, u, tuple(torch.zeros_like(s) for _ in range(8)))


def to_planes(bst: BitStable):
    """BitStable -> contiguous ``int64[..., 10, 64]`` (state, unknown,
    ruled 0..7): the layout of the fused kernels."""
    return torch.stack((bst.state, bst.unknown) + tuple(bst.ruled), dim=-2)


def from_planes(planes):
    """Inverse of :func:`to_planes`."""
    p = planes.unbind(-2)
    return BitStable(p[0], p[1], tuple(p[2:]))


# -- conversions to/from the dense representation ---------------------------


def from_dense_stable(st):
    """propagate.Stable -> BitStable."""
    ruled = tuple(B.from_dense((st.ruled & bit) != 0) for bit in OPTION_BITS)
    return BitStable(B.from_dense(st.state), B.from_dense(st.unknown), ruled)


def to_dense_stable(bst: BitStable):
    from . import propagate as P

    ruled = None
    for plane, bit in zip(bst.ruled, OPTION_BITS):
        t = B.to_dense(plane).to(torch.uint8) * bit
        ruled = t if ruled is None else ruled | t
    return P.Stable(B.to_dense(bst.state), B.to_dense(bst.unknown), ruled)


# -- helpers ----------------------------------------------------------------


def _counts_nibble(board):
    """9-cell inclusive window count as an LSB-first nibble of planes
    (reuses the CSA neighbour counter, core.step)."""
    bit3, bit2, bit1, bit0 = S.neighbour_counts(board)
    return (bit0, bit1, bit2, bit3)


def _any(plane):
    return ~B.is_empty(plane)


def set_on(bst: BitStable, which):
    """Reference ``SetOn`` (LifeStable.hpp:320-329)."""
    ruled = list(bst.ruled)
    for i in range(2, 8):
        ruled[i] = ruled[i] | which
    return BitStable(bst.state | which, bst.unknown & ~which, tuple(ruled))


def set_off(bst: BitStable, which):
    """Reference ``SetOff`` (LifeStable.hpp:330-335)."""
    ruled = list(bst.ruled)
    ruled[0] = ruled[0] | which
    ruled[1] = ruled[1] | which
    return BitStable(bst.state & ~which, bst.unknown & ~which, tuple(ruled))


def _gt_thresholds7(x):
    """``[x > c for c in 0..6]`` for a width-4 nibble as ONE shared
    circuit (12 ops vs 7 independent gt_const evaluations)."""
    b0, b1, b2, b3 = (tuple(x) + (torch.zeros_like(x[0]),) * 4)[:4]
    or01 = b1 | b0
    and10 = b1 & b0
    hi = b2 | b3
    return (
        hi | or01,           # x > 0
        hi | b1,             # x > 1
        hi | and10,          # x > 2
        hi,                  # x > 3
        b3 | (b2 & or01),    # x > 4
        b3 | (b2 & b1),      # x > 5
        b3 | (b2 & and10),   # x > 6
    )


def _maximal_ruled_planes(A, AU, center_on, known_off):
    """Per-option ruled-out planes from the interval [A, AU] and the
    center's three-state (the vector maximal_options on planes).
    ``ruled(cnt) = A > cnt  |  AU < cnt`` with both threshold families
    shared across the 8 options (thermometer decode)."""
    gtA = _gt_thresholds7(A)
    geAU = _gt_thresholds7(AU)  # AU > c  <=>  AU >= c+1
    out = []
    for _, cnt, live in OPTIONS:
        ruled = gtA[cnt]
        if cnt > 0:
            ruled = ruled | ~geAU[cnt - 1]  # AU < cnt
        ruled = ruled | (known_off if live else center_on)
        out.append(ruled)
    return out


def _count_class(possible, ids):
    p = possible[ids[0]]
    for i in ids[1:]:
        p = p | possible[i]
    return p


def _min_possible(possible):
    """Nibble: minimum neighbour count among possible options (garbage
    when none possible — callers guard)."""
    sels = []
    none_lower = None
    for ids in _BY_COUNT:
        p = _count_class(possible, ids)
        sel = p if none_lower is None else p & none_lower
        none_lower = ~p if none_lower is None else none_lower & ~p
        sels.append(sel)
    return _encode_selected(sels)


def _max_possible(possible):
    sels_rev = []
    none_higher = None
    for ids in reversed(_BY_COUNT):
        p = _count_class(possible, ids)
        sel = p if none_higher is None else p & none_higher
        none_higher = ~p if none_higher is None else none_higher & ~p
        sels_rev.append(sel)
    return _encode_selected(list(reversed(sels_rev)))


def _poss_counts(possible):
    """7 planes: some possible option has neighbour count c (c = 0..6)."""
    return [_count_class(possible, ids) for ids in _BY_COUNT]


def _single_count(possible):
    """Plane: at most ONE neighbour-count class remains possible (with
    the some-option-possible guard applied by callers, this is exactly
    ``min_possible == max_possible``)."""
    any_ = torch.zeros_like(possible[0])
    two = torch.zeros_like(possible[0])
    for ids in _BY_COUNT:
        p = _count_class(possible, ids)
        two = two | (any_ & p)
        any_ = any_ | p
    return ~two


def _encode_selected(sels):
    """One-hot count selectors -> nibble of the selected constant."""
    z = torch.zeros_like(sels[0])
    bits = [z, z, z, z]
    for c, sel in zip(_COUNT_VALS, sels):
        for i in range(4):
            if (c >> i) & 1:
                bits[i] = bits[i] | sel
    return tuple(bits)


def _and_all(planes):
    acc = planes[0]
    for p in planes[1:]:
        acc = acc & p
    return acc


def _or_all(planes):
    acc = planes[0]
    for p in planes[1:]:
        acc = acc | p
    return acc


# -- propagation circuits ----------------------------------------------------


def synchronise_state_known(bst: BitStable):
    """Reference ``SynchroniseStateKnown`` (LifeStable.hpp:526-556), packed."""
    state, unknown, ruled, abort_cells, changes = sync_circuit(
        bst.state, bst.unknown, bst.ruled
    )
    return BitPropagateResult(
        BitStable(state, unknown, ruled), ~_any(abort_cells), _any(changes)
    )


def update_circuit(state, unknown, ruled, on9, unk9):
    """Pure elementwise part of UpdateOptions: returns (new_ruled tuple,
    abort_cells plane, changes plane).  Counts are injected so the same
    circuit serves the three-pass step and the fused step."""
    A = nb.sub_bit(on9, state)
    Un = nb.sub_bit(unk9, unknown)
    AU = nb.add(A, Un)
    return update_circuit_interval(state, unknown, ruled, A, AU)


def update_circuit_interval(state, unknown, ruled, A, AU):
    """``update_circuit`` with the exclusive neighbour interval [A, AU]
    precomputed (shared with signal_circuit_post in fused steps)."""
    center_on = state
    known_off = ~state & ~unknown

    out = _maximal_ruled_planes(A, AU, center_on, known_off)
    abort_cells = _and_all(out)

    changes = torch.zeros_like(state)
    new_ruled = list(ruled)
    for i in range(8):
        add = out[i] & ~abort_cells
        changes = changes | (add & ~new_ruled[i])
        new_ruled[i] = new_ruled[i] | add
    return tuple(new_ruled), abort_cells, changes


def update_options(bst: BitStable):
    """Reference ``UpdateOptions`` (LifeStable.hpp:558-615), packed."""
    on9 = _counts_nibble(bst.state)
    unk9 = _counts_nibble(bst.unknown)
    ruled, abort_cells, changes = update_circuit(
        bst.state, bst.unknown, bst.ruled, on9, unk9
    )
    return BitPropagateResult(
        bst._replace(ruled=ruled), ~_any(abort_cells), _any(changes)
    )


def _maybe_live_dead(possible):
    return possible[0] | possible[1], _or_all(possible[2:])


def signal_circuit(state, unknown, ruled, s9, m9):
    """Pure elementwise part of SignalNeighbours: returns (signal_on,
    signal_off, center_on_force, center_off_force) planes; counts injected
    (see update_circuit)."""
    center_on = state
    center_unk = unknown
    known_off = ~state & ~unknown

    A = nb.sub_bit(s9, center_on)
    U = nb.sub_bit(nb.sub(m9, s9), center_unk)
    AU = nb.add(A, U)

    maximal = _maximal_ruled_planes(A, AU, center_on, known_off)
    o2 = [r | m for r, m in zip(ruled, maximal)]
    o2_ok = ~_and_all(o2)

    possible = [~r for r in ruled]
    o_ok = ~_and_all(ruled)

    mo = _min_possible(possible)
    Mo = _max_possible(possible)

    maybe_live_o, maybe_dead_o = _maybe_live_dead(possible)
    conflict = (center_on & maybe_dead_o & ~maybe_live_o) | (
        known_off & maybe_live_o & ~maybe_dead_o
    )

    u_nonzero = ~nb.eq_const(U, 0)
    guards = u_nonzero & o2_ok & o_ok & ~conflict

    signal_off = guards & nb.eq(Mo, A)
    signal_on = guards & nb.eq(mo, AU) & ~signal_off

    maybe_live2, maybe_dead2 = _maybe_live_dead([~p for p in o2])
    cen_guards = center_unk & o2_ok
    center_on_f = cen_guards & maybe_live2 & ~maybe_dead2
    center_off_f = cen_guards & maybe_dead2 & ~maybe_live2
    return signal_on, signal_off, center_on_f, center_off_f


def signal_circuit_post(state, unknown, ruled, A, U, AU):
    """``signal_circuit`` specialised to POST-UPDATE ruled planes (the
    fused step's form): the maximal-options pruning is already in
    ``ruled``, so the endpoint equalities collapse to threshold tests on
    the per-count possibility planes.  Equal to ``signal_circuit`` on all
    cells of consistent boards."""
    center_on = state
    center_unk = unknown
    known_off = ~state & ~unknown

    possible = [~r for r in ruled]
    o_ok = ~_and_all(ruled)

    #   max_possible == A   <=>  no possible count exceeds A
    #   min_possible == AU  <=>  no possible count is below AU
    poss = _poss_counts(possible)
    gtA = _gt_thresholds7(A)
    gtAU = _gt_thresholds7(AU)
    has_above = poss[1] & ~gtA[0]
    has_below = poss[0] & gtAU[0]
    for c in range(2, 7):
        has_above = has_above | (poss[c] & ~gtA[c - 1])
    for c in range(1, 7):
        has_below = has_below | (poss[c] & gtAU[c])

    maybe_live, maybe_dead = _maybe_live_dead(possible)
    conflict = (center_on & maybe_dead & ~maybe_live) | (
        known_off & maybe_live & ~maybe_dead
    )

    u_nonzero = ~nb.eq_const(U, 0)
    guards = u_nonzero & o_ok & ~conflict

    signal_off = guards & ~has_above
    signal_on = guards & ~has_below & ~signal_off

    cen_guards = center_unk & o_ok
    center_on_f = cen_guards & maybe_live & ~maybe_dead
    center_off_f = cen_guards & maybe_dead & ~maybe_live
    return signal_on, signal_off, center_on_f, center_off_f


def sync_circuit(state, unknown, ruled):
    """Pure elementwise SynchroniseStateKnown: returns (state', unknown',
    ruled', abort_cells, changes)."""
    known_on = ~unknown & state
    known_off = ~unknown & ~state

    maybe_dead_b = ~_and_all(ruled[2:])
    maybe_live_b = ~(ruled[0] & ruled[1])
    changes = (maybe_dead_b & known_on) | (maybe_live_b & known_off)

    new_ruled = list(ruled)
    new_ruled[0] = new_ruled[0] | known_off
    new_ruled[1] = new_ruled[1] | known_off
    for i in range(2, 8):
        new_ruled[i] = new_ruled[i] | known_on

    maybe_dead = ~_and_all(new_ruled[2:])
    maybe_live = ~(new_ruled[0] & new_ruled[1])
    abort_cells = ~maybe_live & ~maybe_dead

    forced_on = maybe_live & ~maybe_dead
    changes = changes | (~state & forced_on)
    new_state = state | forced_on

    still_unknown = maybe_live & maybe_dead
    changes = changes | (unknown & ~still_unknown)
    new_unknown = unknown & still_unknown
    return new_state, new_unknown, tuple(new_ruled), abort_cells, changes


def signal_neighbours(bst: BitStable):
    """Reference ``SignalNeighbours`` (LifeStable.hpp:617-675), packed,
    using the end-point equality simplification (module docstring)."""
    s9 = _counts_nibble(bst.state)
    m9 = _counts_nibble(bst.state | bst.unknown)
    signal_on, signal_off, center_on_f, center_off_f = signal_circuit(
        bst.state, bst.unknown, bst.ruled, s9, m9
    )

    off_zoi = B.zoi_hollow(signal_off) | center_off_f
    on_zoi = B.zoi_hollow(signal_on) | center_on_f

    abort = _any(off_zoi & on_zoi & bst.unknown)
    changes = _any((off_zoi | on_zoi) & bst.unknown)

    out = set_off(bst, off_zoi & bst.unknown)
    out = set_on(out, on_zoi & out.unknown)
    return BitPropagateResult(out, ~abort, changes)


def simple_circuit(state, unknown, on9, unk9):
    """Elementwise core of the cheap state/unknown-only rule (reference
    ``PropagateSimpleStep`` netlist stable_simple, LifeStable.hpp:414-503).
    ``on9``/``unk9`` are INCLUSIVE 9-counts as nibbles.  Returns bit-planes
    ``(new_off, new_on, sig_off, sig_on, abort)``; set/clear masks are
    pre-gated on unknown centers, signal masks must be smeared with an
    INCLUSIVE ZOI by the caller.  Ruled planes are neither read nor
    written — the next synchronise pass reconciles them, as in the
    reference."""
    known_off = ~state & ~unknown
    A = nb.sub_bit(on9, state)       # known-ON neighbours (interval lo)
    U = nb.sub_bit(unk9, unknown)    # unknown neighbours
    hi = nb.add(A, U)                # interval hi (<= 8, fits a nibble)

    in2 = nb.ge_const(hi, 2) & nb.le_const(A, 2)
    in3 = nb.ge_const(hi, 3) & nb.le_const(A, 3)
    only_three = nb.eq_const(A, 3) & nb.eq_const(hi, 3)
    live_ok = in2 | in3

    abort = (state & ~live_ok) | (known_off & only_three)

    new_on = unknown & only_three
    new_off = unknown & ~only_three & ~live_ok

    unique = in2 ^ in3
    sig_on_on = state & unique & (
        (in2 & nb.eq_const(hi, 2)) | (in3 & nb.eq_const(hi, 3))
    )
    sig_off_on = state & unique & (
        (in2 & nb.eq_const(A, 2)) | (in3 & nb.eq_const(A, 3))
    )
    one_unk = nb.eq_const(U, 1)
    sig_on_off = known_off & one_unk & nb.eq_const(A, 3)
    sig_off_off = known_off & one_unk & nb.eq_const(A, 2)

    has_unk = ~nb.eq_const(U, 0)
    sig_on = (sig_on_on | sig_on_off) & has_unk
    sig_off = (sig_off_on | sig_off_off) & has_unk
    return new_off, new_on, sig_off, sig_on, abort


def propagate_simple_step(bst: BitStable):
    """One cheap simple-rule step (reference ``PropagateSimpleStep``,
    LifeStable.hpp:414-503).  Ruled planes are untouched; the next
    synchronise reconciles them."""
    on9 = _counts_nibble(bst.state)
    unk9 = _counts_nibble(bst.unknown)
    new_off, new_on, sig_off, sig_on, abort_cells = simple_circuit(
        bst.state, bst.unknown, on9, unk9
    )
    state = bst.state | new_on
    unknown = bst.unknown & ~new_on & ~new_off
    on_z = B.zoi(sig_on)
    off_z = B.zoi(sig_off)
    state = state | (on_z & unknown)
    abort_cells = abort_cells | (off_z & on_z & unknown)
    unknown = unknown & ~off_z & ~on_z
    changed = _any(unknown ^ bst.unknown)
    return BitPropagateResult(
        BitStable(state, unknown, bst.ruled), ~_any(abort_cells), changed
    )


def propagate_step(bst: BitStable):
    """Reference ``PropagateStep`` (LifeStable.hpp:695-716), packed."""
    r1 = synchronise_state_known(bst)
    r2 = update_options(r1.stable)
    r3 = signal_neighbours(r2.stable)
    return BitPropagateResult(
        r3.stable,
        r1.consistent & r2.consistent & r3.consistent,
        r1.changed | r2.changed | r3.changed,
    )


def _masked(old: BitStable, new: BitStable, active):
    a = active[..., None]
    sel = lambda n, o: torch.where(a, n, o)
    return BitStable(
        sel(new.state, old.state),
        sel(new.unknown, old.unknown),
        tuple(sel(n, o) for n, o in zip(new.ruled, old.ruled)),
    )


def propagate(bst: BitStable, max_iters=256):
    """Reference ``Propagate`` fixpoint (LifeStable.hpp:718-729), packed,
    batched with per-board convergence/consistency masks."""
    batch = bst.batch_shape
    dev = bst.state.device
    consistent = torch.ones(batch, dtype=torch.bool, device=dev)
    changed_ever = torch.zeros(batch, dtype=torch.bool, device=dev)
    active = torch.ones(batch, dtype=torch.bool, device=dev)
    cur = bst
    it = 0
    while bool(active.any()) and it < max_iters:
        res = propagate_step(cur)
        cur = _masked(cur, res.stable, active & res.consistent)
        consistent = consistent & (~active | res.consistent)
        changed_ever = changed_ever | (active & res.changed)
        active = active & res.consistent & res.changed
        it += 1
    return BitPropagateResult(cur, consistent, changed_ever)


# -- three-state (ternary) stepping over a stable background -----------------


def step_ternary_packed(state, unknown, naive=False):
    """Packed three-state Life step (interval semantics of the dormant
    unknown_step netlists; bit-plane counterpart of
    stable/ternary.step_ternary).  state/unknown: boards; returns
    (next_state, next_unknown)."""
    center_on = state
    center_unk = unknown
    known_off = ~state & ~unknown

    on9 = _counts_nibble(state)
    unk9 = _counts_nibble(unknown)
    A = nb.sub_bit(on9, center_on)
    U = nb.sub_bit(unk9, center_unk)
    AU = nb.add(A, U)

    def in_range(c):
        return nb.le_const(A, c) & nb.ge_const(AU, c)

    has_23 = in_range(2) | in_range(3)
    has_3 = in_range(3)
    # interval is never empty (U >= 0); "contains a non-{2,3}" and
    # "contains a non-3" by complement of containment
    only_23 = nb.ge_const(A, 2) & nb.le_const(AU, 3)
    only_3 = nb.eq_const(A, 3) & nb.eq_const(AU, 3)

    on_like = ~known_off
    off_like = ~center_on

    maybe_on = (on_like & has_23) | (off_like & has_3)
    maybe_off = (on_like & ~only_23) | (off_like & ~only_3)

    next_state = maybe_on & ~maybe_off
    next_unknown = maybe_on & maybe_off
    if naive:
        next_unknown = next_unknown | center_unk
        next_state = next_state & ~center_unk
    return next_state, next_unknown


def refined_step_circuit(cur_on, cur_unk, ruled, A_cur, A_stab, U_stab):
    """Elementwise core of the options-REFINED ternary step (the reference's
    dormant ``bitslicing/unknown_step_refined.py:51-85`` semantics): step a
    board whose unknown cells are *stable* unknowns, using the stable option
    planes to enumerate only the achievable neighbour configurations instead
    of the naive count interval.

    Inputs (all exclusive of the center cell):
      ``A_cur``  nibble — currently known-ON neighbours,
      ``A_stab`` nibble — stable known-ON neighbours,
      ``U_stab`` nibble — stable-unknown neighbours,
    plus the current three-state (``cur_on``/``cur_unk``) and the center's
    8 ruled option planes.

    For each possible stable option (center s, stable count n): the
    unknown neighbours contribute exactly ``n - A_stab`` current ON cells
    (they sit at their stable values), so the current count is
    ``c = A_cur + n - A_stab``; the center steps by ``life_rule(center, c)``
    with center = the current state, or s when the current state is
    unknown.  Aggregating over options yields maybe_on / maybe_off /
    maybe_unstable exactly as the reference's ``unknown_step_function``.

    Returns ``(next_on, next_unknown, unstable)`` planes:
      * cells whose current AND stable center are unknown stay unknown;
        for them ``unstable`` flags that stability of the unknown
        background could not be guaranteed;
      * cells with no achievable option at all (inconsistent stable
        knowledge) come out unknown with ``unstable`` set.
    """
    # V = A_cur - A_stab + 8, shifted to stay unsigned: it ranges over
    # 0..16, so it needs 5 bits (a 4-bit nibble would wrap)
    eight = nb.const(cur_on, 8, width=5)
    V = nb.add(A_cur, nb.sub(eight, A_stab, width=5), width=5)
    # achievable current count for option count n:  c = n + (V - 8)
    # c == 3  <=>  V == 11 - n ;  c in {2,3}  <=>  V in {10-n, 11-n}
    eqV = {v: nb.eq_const(V, v) for v in range(4, 12)}

    AU_stab = nb.add(A_stab, U_stab)

    maybe_on = torch.zeros_like(cur_on)
    maybe_off = torch.zeros_like(cur_on)
    maybe_unstable = torch.zeros_like(cur_on)
    any_valid = torch.zeros_like(cur_on)
    for idx, (_, cnt, live) in enumerate(OPTIONS):
        # option achievable: not ruled out AND its stable count is reachable
        # (A_stab <= cnt <= A_stab + U_stab)
        valid = (~ruled[idx] & nb.le_const(A_stab, cnt)
                 & nb.ge_const(AU_stab, cnt))
        # center used for stepping: the current state; the option's stable
        # center when the current state is unknown
        center_on = cur_on | cur_unk if live else cur_on
        # life_rule(center, c): ON iff c==3, or center ON and c==2
        stepped_on = eqV[11 - cnt] | (center_on & eqV[10 - cnt])
        unstable = ~stepped_on if live else stepped_on
        maybe_on = maybe_on | (valid & stepped_on)
        maybe_off = maybe_off | (valid & ~stepped_on)
        maybe_unstable = maybe_unstable | (valid & unstable)
        any_valid = any_valid | valid

    # stable three-state of the center from the option planes alone
    # (reference StableOptions.to_three_state)
    maybe_live_o = ~(ruled[0] & ruled[1])
    maybe_dead_o = ~(ruled[2] & ruled[3] & ruled[4] & ruled[5]
                     & ruled[6] & ruled[7])
    keep_unknown = cur_unk & maybe_live_o & maybe_dead_o

    inconsistent = ~any_valid
    next_unknown = keep_unknown | (maybe_on & maybe_off) | inconsistent
    next_on = maybe_on & ~maybe_off & ~next_unknown
    unstable = (keep_unknown & maybe_unstable) | inconsistent
    return next_on, next_unknown, unstable


def step_ternary_refined(cur_state, cur_unknown, stable: BitStable):
    """Options-refined packed ternary step (reference
    unknown_step_refined.py semantics; see :func:`refined_step_circuit`).

    ``cur_state``/``cur_unknown``: the current generation (unknown cells
    are assumed to sit at their stable values — the reference's "all
    unknowns are stable unknowns" precondition, i.e.
    ``cur_unknown == stable.unknown``).  ``stable`` carries the stable
    background knowledge.  Returns (next_state, next_unknown, unstable)."""
    A_cur = nb.sub_bit(_counts_nibble(cur_state), cur_state)
    A_stab = nb.sub_bit(_counts_nibble(stable.state), stable.state)
    U_stab = nb.sub_bit(_counts_nibble(stable.unknown), stable.unknown)
    return refined_step_circuit(cur_state, cur_unknown, stable.ruled,
                                A_cur, A_stab, U_stab)


def refined_step_tracked_circuit(cur_on, track_unk, free_unk, tracking,
                                 ruled, A_cur, Tn, F, A_stab, U_stab):
    """Elementwise core of the SOUND multi-step refined ternary step.

    Generalizes :func:`refined_step_circuit` by dropping its "every
    unknown is a stable unknown" precondition, which multi-step rollouts
    violate as soon as a known cell is demoted to unknown.  Cells are
    partitioned by a ``tracking`` mask — cells whose CURRENT value provably
    equals their stable value in every completion of the background
    (stable-unknown cells still at their stable value count as
    tracking-unknowns):

      * known-ON / known-OFF neighbours contribute exactly their value;
      * tracking-unknown neighbours (count ``Tn``) contribute their
        stable bits, which the center's option pins to a SUM interval:
        for option count n, the stable-ON count among them lies in
        [max(0, n - A_stab - (U_stab - Tn)), min(n - A_stab, Tn)];
      * free unknowns (count ``F``) contribute [0, F] unconstrained.

    The current neighbour count is therefore a per-option INTERVAL
    [c_lo, c_hi], and next-state possibilities are interval queries.
    With Tn == U_stab and F == 0 the intervals degenerate and this
    reduces exactly to :func:`refined_step_circuit`.

    The ``keep`` output is the reference's dormant ``unknown_keep``
    vocabulary (bitslicing/unknown_keep.py:17-26 intended semantics):
    tracking cells for which EVERY achievable option steps back to its own
    stable value — they provably remain at their stable value next
    generation.

    All counts are exclusive of the center.  Returns
    ``(next_on, next_unknown, keep)``.
    """
    cur_unk = track_unk | free_unk
    known_off = ~cur_on & ~cur_unk
    track_known = tracking & ~cur_unk

    AU_stab = nb.add(A_stab, U_stab)
    # D = A_stab + (U_stab - Tn): max stable-ON neighbours outside the
    # tracking-unknown set (Tn <= U_stab so the subtraction is safe)
    D = nb.sub(AU_stab, Tn)
    zero4 = nb.const(cur_on, 0)
    zero = torch.zeros_like(cur_on)

    maybe_on = zero
    maybe_off = zero
    violate = zero
    any_valid = zero
    for idx, (_, cnt, live) in enumerate(OPTIONS):
        cnt_nib = nb.const(cur_on, cnt)
        valid = (~ruled[idx] & nb.le_const(A_stab, cnt)
                 & nb.ge_const(AU_stab, cnt))
        # a tracked KNOWN center's stable value IS its current value:
        # only options of that polarity are achievable
        wrong_polarity = known_off if live else cur_on
        valid = valid & ~(track_known & wrong_polarity)

        # c_lo = A_cur + max(0, cnt - D);  c_hi = A_cur + min(r, Tn) + F
        m = nb.select(nb.ge_const(D, cnt), zero4, nb.sub(cnt_nib, D))
        r = nb.sub(cnt_nib, A_stab)  # >= 0 under the valid guard
        c_lo = nb.add(A_cur, m, width=5)
        c_hi = nb.add(nb.add(A_cur, nb.minimum(r, Tn), width=5), F, width=5)

        int3 = nb.le_const(c_lo, 3) & nb.ge_const(c_hi, 3)
        int2 = nb.le_const(c_lo, 2) & nb.ge_const(c_hi, 2)
        sub23 = nb.ge_const(c_lo, 2) & nb.le_const(c_hi, 3)
        all3 = nb.eq_const(c_lo, 3) & nb.eq_const(c_hi, 3)

        # center-value hypotheses this option admits
        live_m = ~zero if live else zero
        h_on = cur_on | (track_unk & live_m) | free_unk
        h_off = known_off | (track_unk & ~live_m) | free_unk

        maybe_on = maybe_on | (valid & ((h_on & (int2 | int3))
                                        | (h_off & int3)))
        maybe_off = maybe_off | (valid & ((h_on & ~sub23)
                                          | (h_off & ~all3)))
        # keep: stepping FROM the option's own center must land back on it
        stays = sub23 if live else ~int3
        violate = violate | (valid & ~stays)
        any_valid = any_valid | valid

    inconsistent = ~any_valid
    next_unknown = (maybe_on & maybe_off) | inconsistent
    next_on = maybe_on & ~maybe_off
    keep = tracking & any_valid & ~violate
    return next_on, next_unknown, keep


def initial_tracking(cur_state, cur_unknown, stable: BitStable):
    """Cells whose current value provably equals their stable value: known
    cells agreeing with a KNOWN stable state, plus stable-unknown cells
    still marked unknown (they sit at their stable values by
    construction of the rollout's initial state)."""
    stable_known = ~stable.unknown
    agree = ~(cur_state ^ stable.state)
    return ((stable_known & ~cur_unknown & agree)
            | (stable.unknown & cur_unknown))


def _tracked_circuit(cur_state, cur_unknown, tracking, stable: BitStable):
    """:func:`refined_step_tracked_circuit` on the neighbour counts of a
    board: ``(next_on, next_unknown, keep)``."""
    track_unk = cur_unknown & tracking
    free_unk = cur_unknown & ~tracking
    A_cur = nb.sub_bit(_counts_nibble(cur_state), cur_state)
    Tn = nb.sub_bit(_counts_nibble(track_unk), track_unk)
    F = nb.sub_bit(_counts_nibble(free_unk), free_unk)
    A_stab = nb.sub_bit(_counts_nibble(stable.state), stable.state)
    U_stab = nb.sub_bit(_counts_nibble(stable.unknown), stable.unknown)
    return refined_step_tracked_circuit(
        cur_state, track_unk, free_unk, tracking, stable.ruled,
        A_cur, Tn, F, A_stab, U_stab,
    )


def step_ternary_tracked(cur_state, cur_unknown, tracking,
                         stable: BitStable):
    """One SOUND refined ternary step with tracking maintenance (see
    :func:`refined_step_tracked_circuit`).  Returns
    ``(next_state, next_unknown, next_tracking)``; iterate by feeding all
    three back (mpc/reachability.refined_rollout)."""
    next_on, next_unknown, keep = _tracked_circuit(cur_state, cur_unknown,
                                                   tracking, stable)
    # a kept tracking cell's next value IS its stable value: keep known
    # cells at the stable state, keep stable-unknown cells unknown
    keep_known = keep & ~stable.unknown
    keep_unk = keep & stable.unknown
    next_on = ((next_on & ~keep_known) | (stable.state & keep_known)) \
        & ~keep_unk
    next_unknown = (next_unknown | keep_unk) & ~keep_known
    # tracking persists through keep, and (re)starts wherever the next
    # value is known and equals a known stable value
    stable_known = ~stable.unknown
    known_eq = ~next_unknown & stable_known & ~(next_on ^ stable.state)
    next_tracking = keep | known_eq
    return next_on, next_unknown, next_tracking


def keep_stable(cur_state, cur_unknown, stable: BitStable):
    """The reference's dormant ``unknown_keep`` correction mask
    (bitslicing/unknown_keep.py intended semantics): cells that provably
    remain at their stable value after one step, evaluated under the
    generator's own "all unknowns are stable unknowns" precondition
    (``cur_unknown == stable.unknown``, current values at stable
    values)."""
    tracking = initial_tracking(cur_state, cur_unknown, stable)
    return _tracked_circuit(cur_state, cur_unknown, tracking, stable)[2]


# -- branch priorities -------------------------------------------------------


def vulnerable_circuit(state, unknown, ruled, on9, unk9):
    """Elementwise core of the ``Vulnerable`` heuristic: per-cell signal
    masks ``(v_on, v_off, vc_on, vc_off)`` from the inclusive 9-counts.
    The caller broadcasts ``v_on``/``v_off`` with a hollow ZOI (the only
    cross-cell step) and combines."""
    center_on = state
    center_unk = unknown
    known_off = ~state & ~unknown
    center_known = ~center_unk

    A = nb.sub_bit(on9, center_on)
    U = nb.sub_bit(unk9, center_unk)

    one = nb.const(state, 1)

    def is_forced(c_on, c_off, c_unk, A_, U_):
        AU_ = nb.add(A_, U_)
        maximal = _maximal_ruled_planes(A_, AU_, c_on, c_off)
        o2 = [r | m for r, m in zip(ruled, maximal)]
        impossible = _and_all(o2)
        possible = [~p for p in o2]
        # possible counts lie inside [A_, AU_] after the maximal pruning,
        # so max(A_, min_possible) == min(AU_, max_possible) collapses to
        # "exactly one count class remains possible"
        decided = _single_count(possible)
        maybe_live2, maybe_dead2 = _maybe_live_dead(possible)
        center_decided = c_unk & (maybe_live2 ^ maybe_dead2)
        return impossible | decided | center_decided

    z = torch.zeros_like(state)
    f_on = is_forced(center_on, known_off, center_unk, nb.add(A, one),
                     nb.sub(U, one))
    f_off = is_forced(center_on, known_off, center_unk, A, nb.sub(U, one))
    neigh_ok = ~((center_known & nb.le_const(U, 1))
                 | (center_unk & nb.eq_const(U, 0)))
    v_on = neigh_ok & f_on
    v_off = neigh_ok & f_off

    ones_p = ~z
    fc_on = is_forced(ones_p, z, z, A, U)
    fc_off = is_forced(z, ones_p, z, A, U)
    cen_ok = center_unk & ~nb.eq_const(U, 0)
    vc_on = cen_ok & fc_on
    vc_off = cen_ok & fc_off
    return v_on, v_off, vc_on, vc_off


def vulnerable(bst: BitStable):
    """Reference ``Vulnerable`` heuristic (LifeStable.hpp:366-412), packed."""
    on9 = _counts_nibble(bst.state)
    unk9 = _counts_nibble(bst.unknown)
    v_on, v_off, vc_on, vc_off = vulnerable_circuit(
        bst.state, bst.unknown, bst.ruled, on9, unk9
    )
    on = B.zoi_hollow(v_on) | vc_on
    off = B.zoi_hollow(v_off) | vc_off
    return on & off


def branch_levels(bst: BitStable):
    """Branch-priority level masks for the frontier search, highest
    priority first (reference branch-cell order, LifeStable.hpp:1377-1391):
    vulnerable, exactly-2-unknown window, exactly-3-unknown window, any
    settable cell — each intersected with the settable set
    (``PerturbedUnknowns() & dead0.ZOI()``, LifeStable.hpp:1357)."""
    unk9 = _counts_nibble(bst.unknown)
    vuln = vulnerable(bst)
    settable = B.zoi(bst.ruled[2]) & _or_all(bst.ruled) & bst.unknown
    return (
        vuln & settable,
        settable & nb.eq_const(unk9, 2),
        settable & nb.eq_const(unk9, 3),
        settable,
    )

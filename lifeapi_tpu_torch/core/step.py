"""Life stepping and neighbour counting on int64 boards.

Counterpart of :mod:`lifeapi_tpu.core.step`: the same carry-save-adder
netlist (reference LifeAPI.hpp:822-1064, Rokicki's next-state formula at
:837-848), so the binary path is bit-exact by construction.  This module
is the plain PyTorch reference; the hand-written CUDA rollouts in
:mod:`lifeapi_tpu_torch.ops.step_cuda` run the same netlist on the card.
"""

from __future__ import annotations

import torch

from .board import roll_x, roll_y


def half_add(a, b):
    """(sum, carry) one-bit adder on boards (reference LifeAPI.hpp:850-854)."""
    return a ^ b, a & b


def full_add(a, b, c):
    """(sum, carry) full adder on boards (reference LifeAPI.hpp:856-864)."""
    half = a ^ b
    return half ^ c, (a & b) | (c & half)


def count_rows(board):
    """Vertical 3-sum of each cell and its y-neighbours as two bit-planes
    (bit0, bit1) (reference ``CountRows``, LifeAPI.hpp:897-907)."""
    l = roll_y(board, 1)
    r = roll_y(board, -1)
    bit0 = l ^ r ^ board
    bit1 = ((l ^ r) & board) | (l & r)
    return bit0, bit1


def _side_sums(col0, col1):
    """The vertical 3-sums of the column to the left (u) and to the right
    (b) of every column: (u0, u1, b0, b1)."""
    return roll_x(col0, 1), roll_x(col1, 1), roll_x(col0, -1), roll_x(col1, -1)


def step(board):
    """One Life generation on the 64x64 torus, bit-exact with the reference
    ``Step`` (LifeAPI.hpp:1196-1216, Rokicki formula at :837-848).  The
    y-neighbours and their half-sum are computed once and shared by the
    column counts (``count_rows``) and the formula, so the circuit has no
    common subexpression (``utils.roofline`` counts it the same before and
    after CSE)."""
    aw = roll_y(board, 1)
    ae = roll_y(board, -1)
    s0 = aw ^ ae
    s1 = aw & ae
    u0, u1, b0, b1 = _side_sums(s0 ^ board, (s0 & board) | s1)
    ts0 = b0 ^ u0
    ts1 = (b0 & u0) | (ts0 & s0)
    return (b1 ^ u1 ^ ts1 ^ s1) & ((b1 | u1) ^ (ts1 | s1)) & ((ts0 ^ s0) | board)


def step_alt(board):
    """Independent derivation of the step used as a differential-test
    oracle (reference ``StepAlt``, LifeAPI.hpp:1218-1254)."""
    col0, col1 = count_rows(board)
    u0, u1, l0, l1 = _side_sums(col0, col1)
    final_sum, final_carry = full_add(u0, col0, l0)
    carry_sum, carry_carry = full_add(u1, col1, l1)
    carry_carry = carry_carry ^ (final_carry & carry_sum)
    return (
        (final_sum ^ carry_carry)
        & (final_carry ^ carry_sum ^ carry_carry)
        & (board | final_sum)
    )


def step_n(board, n):
    """n Life generations (reference ``Step(numIters)``,
    LifeAPI.hpp:877-881)."""
    for _ in range(n):
        board = step(board)
    return board


def stepped_trajectory(board, n):
    """The horizon [n, ...board] of successive states after 1..n steps."""
    traj = []
    for _ in range(n):
        board = step(board)
        traj.append(board)
    if not traj:
        return board.new_empty((0, *board.shape))
    return torch.stack(traj)


def neighbour_counts(board):
    """Per-cell 9-cell window population (center INCLUDED) as four
    bit-planes (bit3, bit2, bit1, bit0) (reference ``CountNeighbourhood``,
    LifeAPI.hpp:909-952)."""
    col0, col1 = count_rows(board)
    u0, u1, l0, l1 = _side_sums(col0, col1)
    uc0, uc_carry0 = half_add(u0, col0)
    uc1, uc2 = full_add(u1, col1, uc_carry0)
    on0, on_carry0 = half_add(uc0, l0)
    on1, on_carry1 = full_add(uc1, l1, on_carry0)
    on2, on3 = half_add(uc2, on_carry1)
    return on3, on2, on1, on0


def count_planes_to_int(bit3, bit2, bit1, bit0):
    """Count planes -> dense int32[..., 64, 64] counts."""
    from .board import to_dense

    return (to_dense(bit3).to(torch.int32) * 8 + to_dense(bit2).to(torch.int32) * 4
            + to_dense(bit1).to(torch.int32) * 2 + to_dense(bit0).to(torch.int32))


def with_exactly(planes, n):
    """Mask of cells whose 4-bit count equals n (reference
    ``NeighbourCount::WithExactly``, NeighbourCount.hpp:93-102)."""
    bit3, bit2, bit1, bit0 = planes
    result = torch.full_like(bit0, -1)
    for bit, plane in ((1, bit0), (2, bit1), (4, bit2), (8, bit3)):
        result = result & (plane if n & bit else ~plane)
    return result


def add_counts(a_planes, b_planes, carry=None):
    """Ripple add of two 4-bit count plane sets (reference
    ``NeighbourCount::Add``, NeighbourCount.hpp:71-79).  Planes are given
    (bit3, bit2, bit1, bit0) as produced by :func:`neighbour_counts`."""
    a3, a2, a1, a0 = a_planes
    b3, b2, b1, b0 = b_planes
    if carry is None:
        carry = torch.zeros_like(a0)
    r0, carry = full_add(a0, b0, carry)
    r1, carry = full_add(a1, b1, carry)
    r2, carry = full_add(a2, b2, carry)
    r3, _ = full_add(a3, b3, carry)
    return r3, r2, r1, r0


def subtract_counts(a_planes, b_planes):
    """Reference ``NeighbourCount::Subtract`` (NeighbourCount.hpp:85-91):
    add the complement with carry-in ~0."""
    b3, b2, b1, b0 = b_planes
    return add_counts(a_planes, (~b3, ~b2, ~b1, ~b0), carry=torch.full_like(b0, -1))


def interaction_counts(board):
    """(out1, out2, out_more): OFF cells with exactly 1, exactly 2, or >= 3
    live neighbours (reference ``InteractionCounts``, LifeAPI.hpp:956-993)."""
    return _interaction_counts_impl(board, with_next=False)[:3]


def interaction_counts_and_next(board):
    """Fused variant also returning the next generation (reference
    ``InteractionCountsAndNext``, LifeAPI.hpp:997-1040)."""
    return _interaction_counts_impl(board, with_next=True)


def _interaction_counts_impl(board, with_next):
    col0, col1 = count_rows(board)
    u0, u1, l0, l1 = _side_sums(col0, col1)
    final_sum, final_carry = full_add(u0, col0, l0)
    carry_sum, carry_carry = full_add(u1, col1, l1)

    off = ~board
    out1 = off & ~carry_carry & final_sum & ~carry_sum & ~final_carry
    out2 = off & ~carry_carry & ~final_sum & (carry_sum ^ final_carry)
    out_more = off & ~out2 & (final_carry | carry_sum | carry_carry)

    nxt = None
    if with_next:
        cc = carry_carry ^ (carry_sum & final_carry)
        nxt = (final_sum ^ cc) & (final_carry ^ carry_sum ^ cc) & (board | final_sum)
    return out1, out2, out_more, nxt


def step_for_cell(board, x, y):
    """Next state of one cell, bool[...] (reference ``StepFor``,
    LifeAPI.hpp:889-895)."""
    from .board import get_cell, torus_wrap

    count_inc = count_planes_to_int(*neighbour_counts(board))[..., torus_wrap(x),
                                                              torus_wrap(y)]
    center = get_cell(board, x, y)
    count = count_inc - center.to(torch.int32)
    return torch.where(center, (count == 2) | (count == 3), count == 3)
